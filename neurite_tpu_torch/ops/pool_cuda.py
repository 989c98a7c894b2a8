"""
2x2x2 stride-2 max pool of [B, D, H, W, C] by the hand-written CUDA kernels
of `csrc/pool.cu` (forward K1, first-max backward K2).

Counterpart of `neurite_tpu/ops/pool_pallas.py`. The CUDA kernels take any
C and any even D, H, W, in float32 or bfloat16; a tensor on the CPU takes the
plain version (`ops.pool._max_pool_tiled`), which has the same semantics.
"""

import torch

from neurite_tpu_torch.ops import _build
from neurite_tpu_torch.ops.pool import _max_pool_tiled

_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def supported(x_shape, window, dtype):
    """The CUDA kernels' domain: a 3-D volume, window 2x2x2, even spatial
    dims, float32 or bfloat16."""
    return (len(x_shape) == 5 and tuple(window) == (2, 2, 2)
            and all(s % 2 == 0 for s in x_shape[1:4]) and dtype in _SUFFIX)


def _check(x, name):
    if not x.is_cuda:
        raise ValueError(f'{name} must be a CUDA tensor')
    if not supported(x.shape, (2, 2, 2), x.dtype):
        raise ValueError(f'{name}: the pool kernel takes [B, D, H, W, C] with '
                         f'even D, H, W in float32 or bfloat16, got '
                         f'{tuple(x.shape)} {x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def pool2_fwd(x):
    """K1: y = max over each 2x2x2 window of x (NaN propagates)."""
    _check(x, 'x')
    b, d, h, w, c = x.shape
    y = torch.empty((b, d // 2, h // 2, w // 2, c), dtype=x.dtype,
                    device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call(f'neurite_pool2_fwd_{_SUFFIX[x.dtype]}', x.data_ptr(),
                 y.data_ptr(), b, d, h, w, c, _build.stream_of(x))
    _build.launches['pool2_fwd'] += 1
    return y


def pool2_bwd(x, g):
    """K2: dx, with g routed to the first max of each window of x (every tap
    of a window whose max is NaN)."""
    _check(x, 'x')
    b, d, h, w, c = x.shape
    if g.shape != (b, d // 2, h // 2, w // 2, c) or g.dtype != x.dtype:
        raise ValueError(f'g: expected {(b, d // 2, h // 2, w // 2, c)} '
                         f'{x.dtype}, got {tuple(g.shape)} {g.dtype}')
    g = g.contiguous()
    if g.device != x.device:
        raise ValueError('g and x must be on the same device')
    dx = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call(f'neurite_pool2_bwd_{_SUFFIX[x.dtype]}', x.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), b, d, h, w, c,
                 _build.stream_of(x))
    _build.launches['pool2_bwd'] += 1
    return dx


class MaxPool2x3d(torch.autograd.Function):
    """K1 forward, K2 backward; saves only x (K2 recomputes the max)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return pool2_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return pool2_bwd(x, g)


def max_pool2_3d(x):
    """2x2x2 stride-2 max pool of [B, D, H, W, C] with first-max backward:
    the CUDA kernels for a CUDA tensor, the plain version for a CPU one."""
    if not x.is_cuda:
        return _max_pool_tiled(x, (2, 2, 2))
    return MaxPool2x3d.apply(x)
