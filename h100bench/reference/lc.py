"""
A plain float32 LocallyConnected3D (neurite `layers.py:811-1532`) in the
transposed layout of the program's 3-D head, the count of its weights
that reach the volume, and the mean squared error config #3 trains with.

Nothing here imports the program. The layer is stride 1 with SAME
padding ((k - 1) // 2 low, the rest high, per axis): the weights are
[O, prod(k) * C, V], per filter the keras feature axis (tap-major over
(kz, ky, kx), channel-minor) and then the output voxels (z-major); the
bias is [*spatial, O].
y[b, v, o] = sum over taps t and channels c of k[o, t*C + c, v] *
x[b, v + offset_t, c], zero outside the volume, plus bias[v, o]: one
x-slice times kernel-slice product a tap, in float32.
"""

import itertools

import torch
import torch.nn.functional as F

from h100bench.reference.unet import fake_fp8


def _rounded(t, precision):
    """t as a product's operand in `precision` ('f32', 'bf16' or 'fp8'),
    in float32."""
    if precision == 'fp8':
        return fake_fp8(t.float())
    if precision == 'bf16':
        return t.to(torch.bfloat16).float()
    return t.float()


def forward(x, kernel, bias, kernel_size, precision='f32'):
    """y [B, D, H, W, O] float32 of x [B, D, H, W, C], kernel
    [O, prod(k) * C, D * H * W] and bias [D, H, W, O] (or None); the
    operands rounded to `precision`, the sums in float32."""
    ks = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(
        kernel_size)
    _, *sp, c = x.shape
    o = kernel.shape[0]
    xo = _rounded(x, precision)
    ko = _rounded(kernel, precision).reshape(o, -1, c, *sp)
    pads = []
    for k in reversed(ks):
        pads += [(k - 1) // 2, k - 1 - (k - 1) // 2]
    xp = F.pad(xo.movedim(-1, 1), pads).movedim(1, -1)     # [B, *padded, C]
    y = None
    for t, (dz, dy, dx) in enumerate(itertools.product(*map(range, ks))):
        xs = xp[:, dz:dz + sp[0], dy:dy + sp[1], dx:dx + sp[2]]
        kt = ko[:, t].permute(2, 3, 4, 0, 1)                # [*sp, O, C]
        term = (xs[..., None, :] * kt).sum(-1)              # [B, *sp, O]
        y = term if y is None else y + term
    return y if bias is None else y + bias.float()


def live_weights(spatial, kernel_size, filters, channels):
    """Weights of a SAME, stride-1 layer that multiply an input inside the
    volume: along an axis of length s a tap at offset d reaches s - |d|
    inputs. The others multiply the zero padding."""
    total = filters * channels
    for s, k in zip(spatial, kernel_size):
        low = (k - 1) // 2
        total *= sum(max(s - abs(d), 0) for d in range(-low, k - low))
    return total


def mse(y_true, y_pred):
    """The mean over every element of (y_true - y_pred)^2, in float32 (the
    loss of bench.py's config #3)."""
    return torch.mean((y_true.float() - y_pred.float()) ** 2)

