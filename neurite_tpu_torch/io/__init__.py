"""
neurite_tpu_torch.io — native medical-image IO (NIfTI/MGH/npz, nibabel-free),
the multithreaded host ops (`native`) and N-D patch/quilt tiling
(counterpart of `neurite_tpu.io`).
"""
from neurite_tpu_torch.io import tiling  # noqa: F401
from neurite_tpu_torch.io.medio import (  # noqa: F401
    Volume, load_nii, save_nii, load_mgh, save_mgh, load_volfile,
    save_volfile,
)
from neurite_tpu_torch.io.tiling import (  # noqa: F401
    patch_gen, patch_starts, grid_size, quilt, quilt_device,
)
