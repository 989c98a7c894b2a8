"""
Axis-separable N-D resize (counterpart of `neurite_tpu/ops/resize_mm.py`).

A zoom grid is axis-separable: the multilinear weight of a corner is a
product of per-axis weights, so `interpn` on the zoom grid factorizes into
one 1-D interpolation per axis. Each pass is two contiguous `index_select`s
and a weighted sum (the JAX package's 'take' form), with the same clipping
and corner-weight convention as `utils.core.interpn`.
"""

import functools

import numpy as np
import torch

from neurite_tpu_torch import backend
from neurite_tpu_torch.utils.core import device_constant


@functools.lru_cache(maxsize=256)
def _interp_take_np(new_len, old_len, method):
    """(lo index, hi index, weight of lo in float64) of each output
    position, with `interpn`'s clipping and corner-weight convention
    (nearest: lo == hi, weight 1)."""
    p = np.linspace(0., old_len - 1., new_len)
    if method == 'nearest':
        idx = np.clip(np.round(p), 0, old_len - 1).astype(np.int64)
        return idx, idx, np.ones(new_len)
    pc = np.clip(p, 0, old_len - 1)
    lo = np.clip(np.floor(pc), 0, old_len - 1).astype(np.int64)
    hi = np.clip(lo + 1, 0, old_len - 1)
    return lo, hi, hi - pc


def interp_matrix(new_len, old_len, method='linear', dtype=torch.float32,
                  device=None):
    """The [new, old] 1-D interpolation matrix (linear or nearest), on
    `device` (the card unless 'cpu'): the take form's weights scattered
    into rows."""
    lo, hi, w_lo = _interp_take_np(int(new_len), int(old_len), method)
    mat = np.zeros((int(new_len), int(old_len)), np.float32)
    rows = np.arange(int(new_len))
    np.add.at(mat, (rows, lo), w_lo)
    np.add.at(mat, (rows, hi), 1. - w_lo)
    return torch.tensor(mat, dtype=dtype, device=backend.resolve_device(device))


def _apply_axis_take(vol, new_len, axis, method):
    lo, hi, w_lo = _interp_take_np(int(new_len), int(vol.shape[axis]), method)
    lo_v = vol.index_select(axis, device_constant(lo, vol.device))
    if method == 'nearest':
        return lo_v
    hi_v = vol.index_select(axis, device_constant(hi, vol.device))
    dtype = vol.dtype if vol.is_floating_point() else torch.float32
    shape = [1] * vol.ndim
    shape[axis] = new_len
    w = device_constant(w_lo.astype(np.float32), vol.device,
                        dtype).reshape(shape)
    return w * lo_v.to(dtype) + (1. - w) * hi_v.to(dtype)


def resize_separable(vol, new_shape, method='linear', impl='take',
                     precision=None):
    """
    Resize the leading len(new_shape) axes of `vol` to `new_shape`; trailing
    axes (channels) are untouched. Equal to `interpn(vol, ndgrid of
    linspace(0, n-1, new))` with `method`.

    `impl` and `precision` choose the JAX package's TPU form ('take' or an
    MXU 'matmul'); every impl runs the exact two-take form here.
    """
    del precision
    if method not in ('linear', 'nearest'):
        raise ValueError(f'method must be linear or nearest, got {method!r}')
    if impl not in ('take', 'matmul'):
        raise ValueError(f"impl must be 'take' or 'matmul', got {impl!r}")
    out = vol if vol.is_floating_point() else vol.to(torch.float32)
    # largest shrink first keeps the intermediates small
    order = sorted(range(len(new_shape)),
                   key=lambda d: new_shape[d] / vol.shape[d])
    for d in order:
        if out.shape[d] != new_shape[d]:
            out = _apply_axis_take(out, int(new_shape[d]), d, method)
    return out
