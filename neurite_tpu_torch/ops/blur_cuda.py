"""
One axis pass of the separable 3-D SAME blur by the hand-written CUDA kernel
K6 of `csrc/blur.cu` (counterpart of the fused Pallas blur,
`neurite_tpu/ops/blur.py`). A blur of a volume is three launches.
"""

import torch

from neurite_tpu_torch.ops import _build

_SMEM_LIMIT = 48 * 1024  # a block's shared memory without opting in


def _tile(length, post, width):
    """(TL, TQ) of a block: TL outputs along the axis by TQ columns after it,
    halved until the tile, its halo and the taps fit in shared memory."""
    tq = 1 if post == 1 else min(32, post)
    tl = min(256 if post == 1 else 64, length)
    while 4 * ((tl + width - 1) * tq + width) > _SMEM_LIMIT:
        if tq > 1:
            tq //= 2
        elif tl > 1:
            tl //= 2
        else:
            raise ValueError(f'the blur kernel takes at most '
                             f'{_SMEM_LIMIT // 8} taps, got {width}')
    return tl, tq


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
    tl, tq = _tile(length, post, width)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call('neurite_blur_axis_f32', x.data_ptr(), taps.data_ptr(),
                 out.data_ptr(), pre, length, post, width, tl, tq,
                 _build.stream_of(x))
    _build.launches['blur'] += 1
    return out
