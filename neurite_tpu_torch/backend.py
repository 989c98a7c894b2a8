"""
Device selection for the PyTorch port.

Counterpart of `neurite_tpu/backend.py`. Every function of the port takes its
device from its tensors or from an explicit `device=` argument; these helpers
name the default and the test the kernel wrappers make.
"""

import torch


def default_device():
    """The first CUDA device when there is one, else the CPU."""
    return torch.device('cuda' if torch.cuda.is_available() else 'cpu')


def is_cuda(t):
    """True when tensor t lies on a CUDA device (and so takes the kernels)."""
    return bool(t.is_cuda)
