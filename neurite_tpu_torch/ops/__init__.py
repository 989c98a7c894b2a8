"""
neurite_tpu_torch.ops — the kernel layer.

Counterpart of `neurite_tpu.ops`. Each op holds a hand-written CUDA kernel
(sources under `csrc/`, built at first use by `_build.library()`) beside its
plain PyTorch version; a CPU tensor takes the plain version, a CUDA tensor
the kernel.

    max_pool — max pooling with the first-max backward (`pool.py`); a 2x2x2
        pool of a 3-D CUDA volume runs `max_pool2_3d` (`pool_cuda.py`).
    dice_sums — one-pass per-label Dice sums (`dice_red.py`).
"""

from neurite_tpu_torch.ops.pool import max_pool  # noqa: F401
from neurite_tpu_torch.ops.pool_cuda import max_pool2_3d  # noqa: F401
from neurite_tpu_torch.ops.dice_red import dice_sums  # noqa: F401
