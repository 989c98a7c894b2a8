"""
3-D warp engines (counterpart of `neurite_tpu/ops/warp.py` and
`ops/pallas_warp.py`).

The JAX package has several TPU engines for one function, `core.interpn`:
a one-hot MXU engine (`interpn_onehot`, exact within `max_disp`), a guarded
window engine (`interpn_window`) and the Pallas kernels v1 and v2
(`interpn_pallas`). Their windows, blocks and guards exist for the TPU's
layout. The port has one engine: K4 (`warp_cuda`, `csrc/interpn.cu`) for
CUDA tensors, the plain gather chain (`core.interpn_plain`) for CPU tensors,
both exact and unbounded. The three names stay as aliases of it; their
window, engine and precision arguments are accepted and have no effect.
"""

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
