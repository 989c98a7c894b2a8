"""
3-D warp engines (counterpart of `neurite_tpu/ops/warp.py` and
`ops/pallas_warp.py`).

The JAX package has several TPU engines for one function, `core.interpn`:
a one-hot MXU engine (`interpn_onehot`, exact within `max_disp`), a guarded
window engine (`interpn_window`) and the Pallas kernels v1 and v2
(`interpn_pallas`). Their windows, blocks and guards exist for the TPU's
layout. The port has one engine: K4 (`warp_cuda`, `csrc/interpn.cu`) for
CUDA tensors, the plain gather chain (`core.interpn_plain`) for CPU tensors,
both exact and unbounded. The engines' names (`interpn_onehot`,
`interpn_window`, `interpn_pallas`, `interpn_cube`, `interpn_rows`,
`interpn_shear_onehot`) stay as aliases of it; their window, engine and
precision arguments are accepted and have no effect. The one-hot engines'
host arithmetic (`block_spread_ok`, `shear_bound`, `shear_window_disp`)
returns JAX's values.
"""

import numpy as np
import torch

from neurite_tpu_torch.utils import core


def interpn_batch(vol, loc, interp_method='linear', fill_value=None):
    """
    3-D interpolation over a leading batch axis: vol [B, D, H, W] or
    [B, D, H, W, C], loc [B, *out, 3] voxel coordinates; returns [B, *out]
    (+C). One K4 launch for a CUDA tensor (float32), the plain version for a
    CPU one.
    """
    if interp_method not in ('linear', 'nearest'):
        raise ValueError(f'method should be linear or nearest, got: '
                         f'{interp_method}')
    if loc.shape[-1] != 3 or vol.ndim not in (4, 5):
        raise ValueError(f'interpn_batch takes vol [B, D, H, W(, C)] and loc '
                         f'[B, *out, 3], got {tuple(vol.shape)} and '
                         f'{tuple(loc.shape)}')
    if not vol.is_cuda:
        return core.interpn_plain(vol, loc, interp_method, fill_value,
                                  batched=True)
    from neurite_tpu_torch.ops import warp_cuda
    no_channel = vol.ndim == 4
    v = vol[..., None] if no_channel else vol
    out = warp_cuda.interpn3d(v.contiguous(), loc.contiguous(),
                              interp_method, fill_value)
    return out[..., 0] if no_channel else out


def _exact(vol, loc, interp_method, fill_value):
    """vol [D, H, W(, C)] at loc [*out, 3], or both with a batch axis when
    loc has one ([B, Do, Ho, Wo, 3])."""
    if isinstance(loc, (list, tuple)):
        loc = torch.stack(list(loc), -1)
    if loc.shape[-1] != 3:
        raise ValueError('the warp engines are 3-D')
    if loc.ndim == 5:
        return interpn_batch(vol, loc, interp_method, fill_value)
    return interpn_batch(vol[None], loc[None], interp_method, fill_value)[0]


def interpn_onehot(vol, loc, interp_method='linear', fill_value=None,
                   max_disp=8.0, block=(8, 8), matmul_dtype=None, *,
                   guard='none', engine='auto', version='v2'):
    """The JAX one-hot MXU engine's name for the exact op (K4 on the card).
    `max_disp`, `block`, `matmul_dtype`, `guard`, `engine` and `version`
    have no effect: the result is the exact `interpn` beyond any window."""
    del max_disp, block, matmul_dtype, guard, engine, version
    return _exact(vol, loc, interp_method, fill_value)


def interpn_window(vol, loc, interp_method='linear', fill_value=None,
                   block=None, window_pad=5, matmul_dtype=None,
                   engine='auto', guard='runtime', *, max_disp=8.0,
                   version='v2'):
    """The JAX guarded window engine's name for the exact op (K4 on the
    card). `block`, `window_pad`, `matmul_dtype`, `engine`, `guard`,
    `max_disp` and `version` have no effect."""
    del block, window_pad, matmul_dtype, engine, guard, max_disp, version
    return _exact(vol, loc, interp_method, fill_value)


def interpn_pallas(vol, loc, interp_method='linear', fill_value=None,
                   max_disp=4.0, block=(8, 8), interpret=False,
                   version='v2', *, guard='none', engine='pallas',
                   matmul_dtype=None):
    """The JAX Pallas warp's name (v1 and v2) for the exact op (K4 on the
    card). `max_disp`, `block`, `interpret`, `version`, `guard`, `engine`
    and `matmul_dtype` have no effect."""
    del max_disp, block, interpret, version, guard, engine, matmul_dtype
    return _exact(vol, loc, interp_method, fill_value)


def interpn_cube(vol, loc, interp_method='linear', fill_value=None):
    """The JAX cube-gather engine's name for the exact N-D linear
    `core.interpn` (K4 on the card in 3-D). Linear only, as there."""
    if interp_method != 'linear':
        raise ValueError(f'interpn_cube is the linear path, got '
                         f'{interp_method!r}')
    return core.interpn(vol, loc, 'linear', fill_value)


def interpn_rows(vol, loc, interp_method='linear', fill_value=None):
    """The JAX row-gather engine's name for the exact 3-D op (K4 on the
    card): vol [D, H, W(, C)], loc [*out, 3] or a list of 3."""
    return _exact(vol, loc, interp_method, fill_value)


def interpn_shear_onehot(vol, matrix, loc, max_disp=8.0, max_shear=0.5,
                         block=(8, 8), fill_value=None, matmul_dtype=None):
    """The JAX shear-decomposed one-hot engine's name for the exact
    nearest 3-D op (K4 on the card): vol [B, D, H, W(, C)], loc [B, D, H,
    W, 3]; the result in vol's dtype. `matrix` (the affine whose shear the
    TPU engine undoes), `max_disp`, `max_shear`, `block` and `matmul_dtype`
    have no effect: the exact op needs no window."""
    del matrix, max_disp, max_shear, block, matmul_dtype
    if loc.ndim != 5 or loc.shape[-1] != 3:
        raise ValueError(f'loc must be [B, D, H, W, 3], got {tuple(loc.shape)}')
    return interpn_batch(vol, loc, 'nearest', fill_value).to(vol.dtype)


def block_spread_ok(loc, vol_shape, interp_method='linear', block=(8, 8),
                    pad=5):
    """
    The JAX one-hot engine's window guard, computed as there (it bounds
    that engine, not this port's exact op): a 0-d bool tensor, True iff
    every output block's source-index spread fits the window `block +
    2*pad` on every axis. loc: [B, *out_spatial, 3] absolute coordinates;
    vol_shape: (D, H, W). No host read.
    """
    D, H, W = vol_shape
    loc = torch.as_tensor(loc).to(torch.float32)
    maxl = torch.tensor([D - 1., H - 1., W - 1.], device=loc.device)
    cl = torch.minimum(torch.clamp(loc, min=0.), maxl)
    if interp_method == 'linear':
        lo = torch.minimum(torch.clamp(torch.floor(cl), min=0.),
                           torch.clamp(maxl - 1., min=0.))
        need = 2  # the engine clamps local indices to S-2 (the +1 tap)
    else:
        lo = torch.round(cl)
        need = 1
    lo_i = lo.to(torch.int32)

    B = lo_i.shape[0]
    Do, Ho, Wo = lo_i.shape[1:-1]
    bz, by = block[0], block[1]
    bx = block[2] if len(block) > 2 else None
    pz, py = (-Do) % bz, (-Ho) % by
    px = 0 if bx is None else (-Wo) % bx
    # edge padding to whole blocks
    dev = lo_i.device
    lo_i = lo_i[:, torch.arange(Do + pz, device=dev).clamp(max=Do - 1)]
    lo_i = lo_i[:, :, torch.arange(Ho + py, device=dev).clamp(max=Ho - 1)]
    lo_i = lo_i[:, :, :, torch.arange(Wo + px, device=dev).clamp(max=Wo - 1)]
    nbz, nby = (Do + pz) // bz, (Ho + py) // by
    bxe = Wo + px if bx is None else bx
    nbx = 1 if bx is None else (Wo + px) // bx
    blk = lo_i.reshape(B, nbz, bz, nby, by, nbx, bxe, 3)
    spread = blk.amax(dim=(2, 4, 6)) - blk.amin(dim=(2, 4, 6))
    S = torch.tensor([min(bz + 2 * pad, D), min(by + 2 * pad, H),
                      (W if bx is None else min(bx + 2 * pad, W))],
                     dtype=torch.int32, device=dev)
    # x without tiling is never windowed (full rows): no constraint
    if bx is None:
        spread = spread[..., :2]
        S = S[:2]
    return torch.all(spread <= S - need)


def shear_window_disp(block, rot_deg, scale, shear, dense_bound):
    """The JAX shear engine's static `max_disp` for an affine drawn with
    |rotation| <= rot_deg (degrees), |scale-1| <= scale, |shear| <= shear
    and a dense residual bounded by `dense_bound` per axis (host
    arithmetic, JAX's values)."""
    bz, by = block[0], block[1]
    m = (2.5 * np.sin(np.deg2rad(min(float(rot_deg), 45.)))
         + 1.5 * float(scale) + 1.5 * float(shear))
    ms = 1. + m
    spread = ((bz - 1) * m + (by - 1) * m
              + 2. * float(dense_bound) * ms + 3.)
    return spread / 2. + 1.


def shear_bound(rot_deg, scale, shear):
    """The JAX shear engine's static bound on the per-lane shear rates
    |A_zx/A_xx|, |A_yx/A_xx| (host arithmetic, JAX's values)."""
    th = np.deg2rad(min(float(rot_deg), 45.))
    num = 2. * np.sin(th) + 1.5 * float(shear)
    den = max(0.5, np.cos(th) * (1. - min(float(scale), 0.5)))
    return num / den
