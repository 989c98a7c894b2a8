"""
One axis pass of the separable 3-D SAME blur by the hand-written CUDA kernel
K6 of `csrc/blur.cu` (counterpart of the fused Pallas blur,
`neurite_tpu/ops/blur.py`). A blur of a volume is three launches.

`plan` picks K6's body, its tiles and its shared bytes for a shape, an axis
and a tap width, and the launcher trusts it: 'whole' stages a block's 32
columns over the whole axis with every tap (the config #5 shapes); 'halo'
takes 64-row tiles with their halo and, past 48 KB, walks the taps in
chunks. Any length and any odd width plans. Every launch adds one to
`_build.launches['blur']`, and a launch of the whole-axis body one to
`_build.launches['blur_whole']` too.
"""

import collections
import functools

import torch

from neurite_tpu_torch.ops import _build

R = 8               # outputs a thread, along the axis (kR of blur.cu)
ROW = 33            # floats of a shared row: 32 columns and a pad (kRow)
HALO_TILE = 64      # output rows of a 'halo' tile: one group of R a warp
SMEM_LIMIT = 48 * 1024   # a block's shared memory without opting in

Plan = collections.namedtuple('Plan', 'body tile chunk smem')


def _smem(length, tile, chunk):
    """Shared bytes of a block: the chunk's taps (rounded to 4, and 8 more
    for the float4 reads past its end), the input rows they reach from
    `tile` outputs (at most the axis) and the output tile (rounded to R)."""
    taps = -(-chunk // 4) * 4 + 8
    rows = min(length, tile + chunk - 1)
    return 4 * (taps + (rows + -(-tile // R) * R) * ROW)


@functools.cache
def plan(shape, axis, width):
    """K6's Plan(body, tile, chunk, smem) for x of `shape` blurred along
    `axis` with `width` taps: 'whole' (tile = the axis, one chunk of every
    tap) where that fits SMEM_LIMIT, else 'halo' (64-row tiles, the taps in
    chunks of a multiple of 4 when they do not all fit beside their rows)."""
    length = shape[axis]
    whole = _smem(length, max(length, 1), width)
    if whole <= SMEM_LIMIT:
        return Plan('whole', max(length, 1), width, whole)
    if _smem(length, HALO_TILE, width) <= SMEM_LIMIT:
        return Plan('halo', HALO_TILE, width, _smem(length, HALO_TILE, width))
    # the largest multiple of 4 whose chunk fits beside its rows
    free = SMEM_LIMIT // 4 - 8 - (2 * HALO_TILE - 1) * ROW
    chunk = free // (ROW + 1) // 4 * 4
    return Plan('halo', HALO_TILE, chunk, _smem(length, HALO_TILE, chunk))


def blur_axis(x, taps, axis):
    """K6: zero-padded cross-correlation of x [N, D, H, W] (float32,
    contiguous, CUDA) with the odd-width 1-D `taps` (float32 CUDA) along
    `axis` (1, 2 or 3)."""
    if not (x.is_cuda and taps.is_cuda) or x.device != taps.device:
        raise ValueError('x and taps must be CUDA tensors on one device')
    if x.dtype != torch.float32 or taps.dtype != torch.float32:
        raise ValueError(f'the blur kernel takes float32, got x {x.dtype} '
                         f'and taps {taps.dtype}')
    if x.ndim != 4 or axis not in (1, 2, 3):
        raise ValueError(f'the blur kernel takes x [N, D, H, W] and axis 1, '
                         f'2 or 3, got {tuple(x.shape)} and {axis}')
    if taps.ndim != 1 or taps.numel() % 2 == 0:
        raise ValueError(f'taps must be 1-D of odd width, got '
                         f'{tuple(taps.shape)}')
    if not (x.is_contiguous() and taps.is_contiguous()):
        raise ValueError('x and taps must be contiguous')
    length = x.shape[axis]
    pre = x.shape[:axis].numel()
    post = x.shape[axis + 1:].numel()
    width = taps.numel()
    p = plan(tuple(x.shape), axis, width)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call('neurite_blur_axis_f32', x.data_ptr(), taps.data_ptr(),
                 out.data_ptr(), pre, length, post, width, p.tile, p.chunk,
                 p.smem, _build.stream_of(x))
    _build.launches['blur'] += 1
    if p.body == 'whole':
        _build.launches['blur_whole'] += 1
    return out
