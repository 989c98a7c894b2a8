"""
Device selection for the PyTorch port.

Counterpart of `neurite_tpu/backend.py`. The port runs on the card: every
constructor and entry point puts its modules and tensors on
`default_device()` unless the caller passes `device='cpu'` (as the CPU tests
do). Functions that take tensors follow their tensors' device.
"""

import numpy as np
import torch


def default_device():
    """The first CUDA device. Raises when there is none: the port does not
    fall back to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: neurite_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device('cuda')


def resolve_device(device=None):
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)


def is_cuda(t):
    """True when tensor t lies on a CUDA device (and so takes the kernels)."""
    return bool(t.is_cuda)


def to_numpy(a):
    """A tensor on any device (bfloat16 as float32), or an array-like, as a
    numpy array that shares no memory with a tensor."""
    if not torch.is_tensor(a):
        return np.asarray(a)
    a = a.detach()
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.numpy().copy() if a.device.type == 'cpu' else a.cpu().numpy()
