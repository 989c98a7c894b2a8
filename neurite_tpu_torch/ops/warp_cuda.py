"""
3-D interpolation by the hand-written CUDA kernel K4 of `csrc/interpn.cu`.

Counterpart of the Pallas warp kernels of `neurite_tpu/ops/pallas_warp.py`
(v1 and v2): K4 is the exact, unbounded `interpn`, so it equals each of
them inside its window contract. Its gradient goes through the plain
version's autograd, as the JAX VJP rides the gather chain
(`pallas_warp.py:371-386`); the TPU has no backward kernel to port.

K4 has two bodies with the same bits, and `plan` picks one; the launcher
trusts it: 'vec' (32-bit indices, the batch item from the grid, 4 points a
thread for nearest and 1 for linear, a warp's lanes on consecutive points
and the gathers of a thread's points issued together), where every offset
fits 32 bits; 'scalar' (one point a thread, 64-bit offsets) otherwise.
Every K4 launch adds one to `_build.launches['interpn']`, and a launch of
the 'vec' body one to `_build.launches['interpn_vec']` too.
"""

import math

import torch

from neurite_tpu_torch.ops import _build
from neurite_tpu_torch.utils import core


def _check(vol, loc):
    if not (vol.is_cuda and loc.is_cuda) or vol.device != loc.device:
        raise ValueError('vol and loc must be CUDA tensors on one device')
    if vol.dtype != torch.float32 or loc.dtype != torch.float32:
        raise ValueError(f'the interpolation kernel takes float32, got vol '
                         f'{vol.dtype} and loc {loc.dtype}')
    if vol.ndim != 5 or loc.ndim < 3 or loc.shape[-1] != 3 \
            or loc.shape[0] != vol.shape[0]:
        raise ValueError(f'the interpolation kernel takes vol [B, D, H, W, C] '
                         f'and loc [B, *out, 3], got {tuple(vol.shape)} and '
                         f'{tuple(loc.shape)}')
    if not (vol.is_contiguous() and loc.is_contiguous()):
        raise ValueError('vol and loc must be contiguous')


MAX_GRID_Y = 65535  # the 'vec' body takes the batch item from blockIdx.y


def plan(vol, loc):
    """K4's body for vol [B, D, H, W, C] at loc [B, *out, 3]: 'vec' where
    vol, loc and out ([B, *out, C]) each have fewer than 2^31 elements and
    B <= 65535; else 'scalar'. Reckoned from shapes only: meta tensors will
    do."""
    b, c = vol.shape[0], vol.shape[-1]
    p = math.prod(loc.shape[1:-1])
    fits = max(vol.numel(), b * p * 3, b * p * c) < 2 ** 31
    return 'vec' if fits and b <= MAX_GRID_Y else 'scalar'


def _launch(vol, loc, out, interp_method, fill_value, body):
    """Launch K4's `body` ('vec' or 'scalar') on checked tensors into
    out."""
    b, d, h, w, c = vol.shape
    p = math.prod(loc.shape[1:-1])
    args = [vol.data_ptr(), loc.data_ptr(), out.data_ptr(), b, d, h, w, c,
            p]
    flags = [int(interp_method == 'nearest'), int(fill_value is not None),
             float(0. if fill_value is None else fill_value),
             _build.stream_of(vol)]
    lib = _build.library()
    with torch.cuda.device(vol.device):
        lib.call('neurite_interpn3d_vec_f32' if body == 'vec'
                 else 'neurite_interpn3d_f32', *args, *flags)
    _build.launches['interpn'] += 1
    if body == 'vec':
        _build.launches['interpn_vec'] += 1


def interpn3d_fwd(vol, loc, interp_method, fill_value):
    """K4: vol [B, D, H, W, C] at loc [B, *out, 3] -> [B, *out, C], by the
    body `plan` picks."""
    _check(vol, loc)
    if interp_method not in ('linear', 'nearest'):
        raise ValueError(f'method should be linear or nearest, got: '
                         f'{interp_method}')
    out = torch.empty((vol.shape[0], *loc.shape[1:-1], vol.shape[-1]),
                      dtype=torch.float32, device=vol.device)
    _launch(vol, loc, out, interp_method, fill_value, plan(vol, loc))
    return out


class Interpn3d(torch.autograd.Function):
    """K4 forward; backward by autograd through `core.interpn_plain`."""

    @staticmethod
    def forward(ctx, vol, loc, interp_method, fill_value):
        ctx.save_for_backward(vol, loc)
        ctx.method, ctx.fill = interp_method, fill_value
        return interpn3d_fwd(vol, loc, interp_method, fill_value)

    @staticmethod
    def backward(ctx, g):
        vol, loc = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((vol, loc),
                                                                  need)]
            out = core.interpn_plain(ins[0], ins[1], ctx.method, ctx.fill,
                                     batched=True)
            wrt = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        res = []
        for t, n in zip(ins, need):
            gi = next(grads) if n else None
            res.append(torch.zeros_like(t) if n and gi is None else gi)
        return res[0], res[1], None, None


def interpn3d(vol, loc, interp_method='linear', fill_value=None):
    """Differentiable K4 on float32 contiguous CUDA tensors."""
    return Interpn3d.apply(vol, loc, interp_method, fill_value)
