"""
The JAX package's TPU conv forms, as aliases of one SAME-padding, stride-1
N-D convolution (counterpart of `neurite_tpu/ops/im2col.py` and
`ops/zdecomp.py`).

`conv_im2col` stacks the taps into the channel axis and `conv_z2d` splits a
3-D conv into 2-D convs along z, each to fill the TPU's lanes; both compute
the same function as `nn.Conv` with SAME padding. Here both are
`F.conv{N}d` on the channels-last tensors, taking JAX's `[*k, Cin, Cout]`
kernel layout; the kernel and bias are cast to the input's dtype, as there.
"""

import torch.nn.functional as F

from neurite_tpu_torch.utils import core


def conv_same(x, kernel, bias=None):
    """
    SAME-padding (XLA's: the high side takes the odd voxel), stride-1 N-D
    convolution. x: [B, *spatial, C]; kernel: [*k, C, F] (flax's `nn.Conv`
    layout); bias: [F] or None. Returns [B, *spatial, F] in x's dtype.
    """
    nd = kernel.ndim - 2
    if nd not in (1, 2, 3) or x.ndim != nd + 2 or x.shape[-1] != kernel.shape[-2]:
        raise ValueError(f'conv_same takes x [B, *spatial, C] and kernel '
                         f'[*k, C, F] of 1-3 spatial dims, got '
                         f'{tuple(x.shape)} and {tuple(kernel.shape)}')
    w = kernel.to(x.dtype).permute(nd + 1, nd, *range(nd))
    pads = []
    for n, k in reversed(list(zip(x.shape[1:-1], kernel.shape[:nd]))):
        pads += core._same_pad(n, k, 1, 1)
    y = (F.conv1d, F.conv2d, F.conv3d)[nd - 1](
        F.pad(x.movedim(-1, 1), pads), w).movedim(1, -1)
    return y if bias is None else y + bias.to(y.dtype)


def conv_im2col(x, kernel, bias=None, precision=None, remat=True):
    """The JAX tap-stacked matmul conv's name for `conv_same`. `precision`
    and `remat` (rematerialise the tap stack) have no effect."""
    del precision, remat
    return conv_same(x, kernel, bias)


def conv_z2d(x, kernel, bias=None, dw_impl=None):
    """The JAX z-decomposed 3-D conv's name for `conv_same` (3-D only).
    `dw_impl` (the weight-gradient form) has no effect."""
    del dw_impl
    if x.ndim != 5 or kernel.ndim != 5:
        raise ValueError(f'conv_z2d is 3-D: x [B, D, H, W, C], kernel '
                         f'[kd, kh, kw, C, F], got {tuple(x.shape)} and '
                         f'{tuple(kernel.shape)}')
    return conv_same(x, kernel, bias)
