"""
Max pooling over channels-last [B, *spatial, C] with the first-max backward.

Counterpart of `neurite_tpu/ops/pool.py`. The gradient routes to the FIRST
maximal element of each window in window order (the keras /
`select_and_scatter` tie-break), and NaN propagates forward. A 2x2x2 pool of
a 3-D CUDA tensor runs the hand-written kernels of `ops/pool_cuda.py`; other
non-overlapping pools run the plain tiled version here, and pools whose
windows overlap or do not divide the volume run a plain padded pool with
flax's SAME/VALID rule.
"""

import math

import torch

from neurite_tpu_torch.parallel import spatial as sharding


def _windowed(x, window):
    """[B, *spatial, C] -> [B, s0/w0, w0, s1/w1, w1, ..., C]."""
    shape = [x.shape[0]]
    for s, w in zip(x.shape[1:-1], window):
        shape += [s // w, w]
    return x.reshape(*shape, x.shape[-1])


def _window_axes(window):
    return tuple(2 + 2 * i for i in range(len(window)))


def _upsample(y, window):
    """Nearest-neighbour upsampling of the spatial axes by `window`."""
    for ax, w in enumerate(window):
        if w != 1:
            y = y.repeat_interleave(w, dim=ax + 1)
    return y


def _intra_window_index(shape, window, device):
    """Linear index of each element within its window, in window order."""
    idx = torch.zeros((), dtype=torch.int32, device=device)
    for ax, w in enumerate(window):
        view = [1] * len(shape)
        view[ax + 1] = shape[ax + 1]
        ia = (torch.arange(shape[ax + 1], dtype=torch.int32, device=device)
              % w).reshape(view)
        idx = idx * w + ia
    return idx


def _max_pool_tiled_fwd(x, window):
    """y: the max of each window (NaN propagates)."""
    return _windowed(x, window).amax(dim=_window_axes(window))


def _max_pool_tiled_bwd(x, y, g, window):
    """dx: g routed to the first element of each window equal to its max —
    the mask formula of `neurite_tpu/ops/pool.py:_max_pool_tiled_bwd`,
    written out. A window whose max is NaN equals nowhere, and all its
    elements receive g."""
    eq = x == _upsample(y, window)
    idx = _intra_window_index(x.shape, window, x.device)
    big = torch.tensor(math.prod(window), dtype=torch.int32, device=x.device)
    cand = torch.where(eq, idx, big)
    winner = _windowed(cand, window).amin(dim=_window_axes(window))
    mask = cand == _upsample(winner, window)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    return torch.where(mask, _upsample(g, window), zero).to(x.dtype)


class _MaxPoolTiled(torch.autograd.Function):
    """Plain non-overlapping max pool with the first-max backward."""

    @staticmethod
    def forward(ctx, x, window):
        y = _max_pool_tiled_fwd(x, window)
        ctx.window = window
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _max_pool_tiled_bwd(x, y, g, ctx.window), None


def _max_pool_tiled(x, window):
    """Non-overlapping max pool of [B, *spatial, C]; every dim divides."""
    return _MaxPoolTiled.apply(x, tuple(window))


def _same_pads(size, window, stride):
    """lax.padtype_to_pads for 'SAME': (lo, hi) padding of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _max_pool_padded(x, window, strides, padding):
    """General max pool with flax's SAME/VALID rule: -inf padding, then the
    first maximal element of each window (NaN counts as maximal, as in
    `lax.max`); autograd routes the gradient to that element."""
    padding = padding.upper() if isinstance(padding, str) else padding
    if padding not in ('SAME', 'VALID'):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    nd = len(window)
    if padding == 'SAME':
        pads = [_same_pads(s, w, st)
                for s, w, st in zip(x.shape[1:-1], window, strides)]
        flat = []
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        # torch pads from the last dim; the channel dim gets (0, 0)
        x = torch.nn.functional.pad(x, [0, 0] + flat, value=-math.inf)
    for ax, (w, st) in enumerate(zip(window, strides)):
        x = x.unfold(ax + 1, w, st)          # window taps go to the end
    # [B, *out, C, *window] -> [B, *out, C, prod(window)]
    taps = x.reshape(*x.shape[:nd + 2], -1)
    first = taps.argmax(dim=-1, keepdim=True)
    return taps.gather(-1, first).squeeze(-1)


def max_pool(x, window, strides=None, padding='VALID', impl='auto'):
    """
    Max pooling over the spatial axes of [B, *spatial, C].

    Counterpart of `neurite_tpu.ops.pool.max_pool` (a drop-in for flax's
    `nn.max_pool`). Non-overlapping pools whose windows divide every spatial
    dim use the first-max tiled path: the CUDA kernel for a 2x2x2 pool of a
    float32 or bfloat16 CUDA tensor, the plain version otherwise. Everything
    else takes the plain padded pool.

    impl: 'auto' (the kernel where it applies), 'kernel' (the same, but raise
        for a CUDA tensor the kernel does not take), or 'plain'.

    Under spatial sharding (`parallel.spatial`) x is a block, and the pool
    runs on it as it is: the windows must tile the block along the sharded
    axis (window = stride, dividing the block), or this raises.
    """
    if impl not in ('auto', 'kernel', 'plain'):
        raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")
    window = tuple(int(w) for w in window)
    strides = window if strides is None else tuple(int(s) for s in strides)
    spatial = tuple(x.shape[1:-1])
    if len(spatial) != len(window) or len(strides) != len(window):
        raise ValueError(f'window {window} / strides {strides} do not match '
                         f'the {len(spatial)} spatial dims of {tuple(x.shape)}')
    if sharding.active() is not None:
        sharding.check_pool(x.shape, window, strides)
    if strides == window and all(s % w == 0 for s, w in zip(spatial, window)):
        if impl != 'plain' and x.is_cuda:
            from neurite_tpu_torch.ops import pool_cuda
            if pool_cuda.supported(x.shape, window, x.dtype):
                return pool_cuda.max_pool2_3d(x.contiguous())
            if impl == 'kernel':
                raise ValueError(
                    f'the CUDA pool kernel does not take window {window} '
                    f'on {tuple(x.shape)} {x.dtype}')
        return _max_pool_tiled(x, window)
    return _max_pool_padded(x, window, strides, padding)
