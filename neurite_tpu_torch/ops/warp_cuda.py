"""
3-D interpolation by the hand-written CUDA kernel K4 of `csrc/interpn.cu`.

Counterpart of the Pallas warp kernels of `neurite_tpu/ops/pallas_warp.py`
(v1 and v2): K4 is the exact, unbounded `interpn`, so it equals each of
them inside its window contract. Its gradient goes through the plain
version's autograd, as the JAX VJP rides the gather chain
(`pallas_warp.py:371-386`); the TPU has no backward kernel to port.
"""

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


def interpn3d_fwd(vol, loc, interp_method, fill_value):
    """K4: vol [B, D, H, W, C] at loc [B, *out, 3] -> [B, *out, C]."""
    _check(vol, loc)
    if interp_method not in ('linear', 'nearest'):
        raise ValueError(f'method should be linear or nearest, got: '
                         f'{interp_method}')
    b, d, h, w, c = vol.shape
    out_shape = tuple(loc.shape[1:-1])
    p = loc[0, ..., 0].numel()
    out = torch.empty((b, *out_shape, c), dtype=torch.float32,
                      device=vol.device)
    lib = _build.library()
    with torch.cuda.device(vol.device):
        lib.call('neurite_interpn3d_f32', vol.data_ptr(), loc.data_ptr(),
                 out.data_ptr(), b, d, h, w, c, p,
                 int(interp_method == 'nearest'), int(fill_value is not None),
                 float(0. if fill_value is None else fill_value),
                 _build.stream_of(vol))
    _build.launches['interpn'] += 1
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
