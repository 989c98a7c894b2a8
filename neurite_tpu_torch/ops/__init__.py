"""
neurite_tpu_torch.ops — the kernel layer.

Counterpart of `neurite_tpu.ops`. Each op holds a hand-written CUDA kernel
(sources under `csrc/`, built at first use by `_build.library()`) beside its
plain PyTorch version; a CPU tensor takes the plain version, a CUDA tensor
the kernel.

    max_pool — max pooling with the first-max backward (`pool.py`); a 2x2x2
        pool of a 3-D CUDA volume runs `max_pool2_3d` (`pool_cuda.py`).
    dice_sums — one-pass per-label Dice sums (`dice_red.py`).
    interpn_window, interpn_onehot, interpn_pallas — the JAX engines' names
        for the exact 3-D interpolation K4 (`warp.py`, `warp_cuda.py`).
    separable_blur3d — the separable 3-D SAME blur K6 (`blur.py`,
        `blur_cuda.py`).
    resize_separable, interp_matrix — per-axis resize (`resize.py`).
    lc_transposed, keras_to_transposed, transposed_to_keras — the plain
        locally-connected conv with transposed weights (`lc_tap.py`).
    lc_transposed_pallas, lc3d_pallas — the JAX names of the LC kernels
        K7 (forward), K8 (dk) and K9 (dx) (`lc_cuda.py`).
    mi_histograms — the fused soft-quantize + MI joint histogram
        (`mi_hist.py`); its kernel route runs K10 (`mi_hist_cuda.py`).
"""

from neurite_tpu_torch.ops.pool import max_pool  # noqa: F401
from neurite_tpu_torch.ops.pool_cuda import max_pool2_3d  # noqa: F401
from neurite_tpu_torch.ops.dice_red import dice_sums  # noqa: F401
from neurite_tpu_torch.ops.warp import (  # noqa: F401
    interpn_onehot, interpn_pallas, interpn_window,
)
from neurite_tpu_torch.ops.blur import separable_blur3d  # noqa: F401
from neurite_tpu_torch.ops.resize import (  # noqa: F401
    interp_matrix, resize_separable,
)
from neurite_tpu_torch.ops.lc_tap import (  # noqa: F401
    keras_to_transposed, lc_transposed, transposed_to_keras,
)
from neurite_tpu_torch.ops.lc_cuda import (  # noqa: F401
    lc3d_pallas, lc_transposed_pallas,
)
from neurite_tpu_torch.ops.mi_hist import mi_histograms  # noqa: F401
