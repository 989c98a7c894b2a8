"""
2x2x2 stride-2 max pool of [B, D, H, W, C] by the hand-written CUDA kernels
of `csrc/pool.cu` (forward K1, first-max backward K2).

Counterpart of `neurite_tpu/ops/pool_pallas.py`. The CUDA kernels take any
C and any even D, H, W, in float32 or bfloat16; a tensor on the CPU takes the
plain version (`ops.pool._max_pool_tiled`), which has the same semantics.

`plan` picks K1's body, its block and its grid, and the launcher trusts it:
'vec' (one 16-byte channel vector a thread, where C is a multiple of 8
bfloat16 or 4 float32 channels and x and y are 16-byte aligned) or 'scalar'
(one element a thread). Every K1 launch adds one to
`_build.launches['pool2_fwd']`, and a launch of the 'vec' body one to
`_build.launches['pool2_fwd_vec']` too.
"""

import collections
import functools

import torch

from neurite_tpu_torch.ops import _build
from neurite_tpu_torch.ops.pool import _max_pool_tiled

_SUFFIX = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
THREADS = 256       # threads of a 'vec' block
MAX_GRID_Y = 65535  # rows past this many blocks: a grid-stride loop

Plan = collections.namedtuple('Plan', 'body block grid wide')


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


def plan(shape, dtype, ptrs):
    """K1's Plan(body, block, grid, wide) for x of `shape` [B, D, H, W, C]
    and `dtype`, with `ptrs` the data pointers of x and y. 'vec' where C is
    a multiple of the 16-byte vector's lanes (8 bfloat16, 4 float32) and
    every pointer is 16-byte aligned: block (tx, ty) with tx the row's
    vectors (W/2 * C/lanes, at most THREADS) and ty rows a block, grid
    (row's vectors / tx, rows / ty) with at most MAX_GRID_Y row blocks (a
    grid-stride loop walks the rest), and `wide` (64-bit offsets) where an
    offset of x does not fit 31 bits. 'scalar' otherwise, block and grid
    None: its launcher sizes them."""
    return _plan(tuple(shape), dtype, all(p % 16 == 0 for p in ptrs))


@functools.cache
def _plan(shape, dtype, aligned):
    b, d, h, w, c = shape
    lanes = 16 // dtype.itemsize
    if c % lanes or not aligned:
        return Plan('scalar', None, None, None)
    per_row = w // 2 * (c // lanes)
    rows = b * (d // 2) * (h // 2)
    tx = max(1, min(per_row, THREADS))
    ty = max(1, THREADS // tx)
    grid = (max(1, -(-per_row // tx)), max(1, min(-(-rows // ty), MAX_GRID_Y)))
    return Plan('vec', (tx, ty), grid, b * d * h * w * c >= 2 ** 31)


def pool2_fwd(x):
    """K1: y = max over each 2x2x2 window of x (NaN propagates)."""
    _check(x, 'x')
    b, d, h, w, c = x.shape
    y = torch.empty((b, d // 2, h // 2, w // 2, c), dtype=x.dtype,
                    device=x.device)
    p = plan(x.shape, x.dtype, (x.data_ptr(), y.data_ptr()))
    sfx = _SUFFIX[x.dtype]
    lib = _build.library()
    with torch.cuda.device(x.device):
        if p.body == 'vec':
            lib.call(f'neurite_pool2_fwd_vec_{sfx}', x.data_ptr(),
                     y.data_ptr(), b, d, h, w, c, *p.block, *p.grid,
                     int(p.wide), _build.stream_of(x))
        else:
            lib.call(f'neurite_pool2_fwd_{sfx}', x.data_ptr(), y.data_ptr(),
                     b, d, h, w, c, _build.stream_of(x))
    _build.launches['pool2_fwd'] += 1
    if p.body == 'vec':
        _build.launches['pool2_fwd_vec'] += 1
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
