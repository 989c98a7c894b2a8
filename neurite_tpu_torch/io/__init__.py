"""
neurite_tpu_torch.io — N-D patch/quilt tiling (counterpart of
`neurite_tpu.io`; the medical-image readers of `neurite_tpu.io.medio` are
not ported yet).
"""
from neurite_tpu_torch.io import tiling  # noqa: F401
from neurite_tpu_torch.io.tiling import (  # noqa: F401
    patch_gen, patch_starts, grid_size, quilt, quilt_device,
)
