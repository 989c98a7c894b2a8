"""
neurite_tpu_torch — the PyTorch/CUDA port of neurite_tpu, for NVIDIA Hopper.

Import as `import neurite_tpu_torch as ne`. Submodules mirror
`neurite_tpu`'s names and its channels-last [B, *spatial, C] tensors, so the
same inputs and weights give the same numbers. The hot ops run hand-written
CUDA kernels (`ops/csrc/`), built with nvcc at their first launch; CPU tensors
take the kernels' plain PyTorch versions. The package imports torch and
numpy, never JAX.
"""

__version__ = '0.1.0'

from neurite_tpu_torch import backend  # noqa: F401
from neurite_tpu_torch import checkify  # noqa: F401
from neurite_tpu_torch import py  # noqa: F401
from neurite_tpu_torch import utils  # noqa: F401
from neurite_tpu_torch import ops  # noqa: F401
from neurite_tpu_torch import layers  # noqa: F401
from neurite_tpu_torch import metrics  # noqa: F401
from neurite_tpu_torch import losses  # noqa: F401
from neurite_tpu_torch import regularizers  # noqa: F401
from neurite_tpu_torch import models  # noqa: F401
from neurite_tpu_torch import training  # noqa: F401
from neurite_tpu_torch import convert  # noqa: F401
from neurite_tpu_torch import io  # noqa: F401
from neurite_tpu_torch import generators  # noqa: F401
from neurite_tpu_torch import dataproc  # noqa: F401
from neurite_tpu_torch import data  # noqa: F401
from neurite_tpu_torch import callbacks  # noqa: F401
from neurite_tpu_torch import modelio  # noqa: F401
from neurite_tpu_torch import parallel  # noqa: F401
from neurite_tpu_torch.py import plot  # noqa: F401
