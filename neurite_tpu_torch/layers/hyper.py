"""
Hypernetwork layers: convolutions and dense maps whose weights arrive as
inputs.

Counterpart of `neurite_tpu/layers/hyper.py` (reference
`neurite/tf/layers.py:2515-3033`). JAX convolves each sample with its own
kernel (`jax.vmap` of `lax.conv_general_dilated`); here the batch folds
into the groups of one `F.conv{N}d`: the input [1, B*C, *spatial], the
kernel [B*F, C, *k], groups=B. 'same' padding is XLA's (the high side
takes the odd voxel, for even kernels and strides), padded before the
conv. The trainable maps from a hypernetwork's output to those weights
(`hyperkernel`, `hyperbias`) hold flax's `kernel` [h, units] and `bias` as
they are, so `neurite_tpu_torch.convert` moves them by name. Torch needs
their input sizes at construction: the `...FromDense` layers take the
feature count of x (`in_features`) and of the hypernetwork's output
(`hyper_features`).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from neurite_tpu_torch import backend
from neurite_tpu_torch.models.unet import (_lecun_normal, _tuple,
                                           get_activation)
from neurite_tpu_torch.utils import core


def _act(activation, y):
    act = get_activation(activation)
    return act(y) if act is not None else y


class HyperConv(nn.Module):
    """
    N-D convolution with per-sample weights: forward([x, kernel(, bias)])
    with x [B, *spatial, C], kernel [B, *k, C, F] and bias [B, F].
    Parity: reference `layers.py:2515-2646`.
    """

    def __init__(self, filters, kernel_size, rank=3, strides=1,
                 padding='valid', dilation_rate=1, activation=None,
                 use_bias=True):
        super().__init__()
        if rank not in (1, 2, 3):
            raise ValueError(f'HyperConv takes rank 1-3, got {rank}')
        padding = padding.lower()
        if padding == 'causal':
            raise ValueError('Causal padding is not supported for HyperConv')
        if padding not in ('same', 'valid'):
            raise ValueError(
                f"padding must be 'same' or 'valid', got {padding!r}")
        self.filters = filters
        self.kernel_size = _tuple(kernel_size, rank)
        self.rank = rank
        self.strides = _tuple(strides, rank)
        self.padding = padding
        self.dilation = _tuple(dilation_rate, rank)
        self.activation = activation
        self.use_bias = use_bias

    def forward(self, inputs):
        x, kernel = inputs[0], inputs[1]
        rank = self.rank
        b, c, f = x.shape[0], x.shape[-1], kernel.shape[-1]
        xs = x.movedim(-1, 1).reshape(1, b * c, *x.shape[1:-1])
        # [B, *k, C, F] -> [B, F, C, *k] -> [B*F, C, *k]
        w = kernel.permute(0, rank + 2, rank + 1, *range(1, rank + 1))
        w = w.reshape(b * f, c, *kernel.shape[1:rank + 1])
        if self.padding == 'same':
            pads = []
            for n, k, st, d in reversed(list(zip(
                    xs.shape[2:], w.shape[2:], self.strides, self.dilation))):
                pads += core._same_pad(n, k, st, d)
            xs = F.pad(xs, pads)
        conv = (F.conv1d, F.conv2d, F.conv3d)[rank - 1]
        y = conv(xs, w, stride=self.strides, dilation=self.dilation, groups=b)
        y = y.reshape(b, f, *y.shape[2:]).movedim(1, -1)
        if self.use_bias:
            y = y + inputs[2].reshape(b, *([1] * rank), f)
        return _act(self.activation, y)


class HyperConv2D(HyperConv):
    def __init__(self, filters, kernel_size, rank=2, **kwargs):
        super().__init__(filters, kernel_size, rank=rank, **kwargs)


class HyperConv3D(HyperConv):
    def __init__(self, filters, kernel_size, rank=3, **kwargs):
        super().__init__(filters, kernel_size, rank=rank, **kwargs)


class _HyperDenseMapping(nn.Module):
    """Dense map from the hypernetwork's output h [B, hyper_features] to
    per-sample weights [B, *target_shape] (ref `layers.py:2751-2805`):
    flax's lecun-normal `kernel` [h, units] and zero `bias`."""

    flax_same_layout = True

    def __init__(self, hyper_features, target_shape, use_bias=True,
                 activation=None, generator=None):
        super().__init__()
        self.target_shape = tuple(int(s) for s in target_shape)
        units = math.prod(self.target_shape)
        self.kernel = nn.Parameter(torch.empty(hyper_features, units))
        self.bias = nn.Parameter(torch.empty(units)) if use_bias else None
        self.activation = activation
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Draw the kernel (lecun normal) from `generator`; zero the bias."""
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(tuple(self.kernel.shape),
                                            self.kernel.shape[0], generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, h):
        out = h @ self.kernel
        if self.bias is not None:
            out = out + self.bias
        return _act(self.activation, out).reshape(-1, *self.target_shape)


class HyperConvFromDense(nn.Module):
    """
    HyperConv with the trainable maps from the hypernetwork's output to its
    kernel (`hyperkernel`) and bias (`hyperbias`): forward([x, h]).
    Parity: reference `layers.py:2668-2805`.
    """

    def __init__(self, in_features, hyper_features, filters, kernel_size,
                 rank=3, strides=1, padding='valid', dilation_rate=1,
                 activation=None, use_bias=True, hyperkernel_use_bias=True,
                 hyperbias_use_bias=True, hyperkernel_activation=None,
                 hyperbias_activation=None, generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        ks = _tuple(kernel_size, rank)
        self.hyperkernel = _HyperDenseMapping(
            hyper_features, (*ks, in_features, filters),
            use_bias=hyperkernel_use_bias, activation=hyperkernel_activation,
            generator=generator)
        if use_bias:
            self.hyperbias = _HyperDenseMapping(
                hyper_features, (filters,), use_bias=hyperbias_use_bias,
                activation=hyperbias_activation, generator=generator)
        # flax's auto name for the parameterless conv, so module paths agree
        self.HyperConv_0 = HyperConv(filters, ks, rank=rank, strides=strides,
                                     padding=padding,
                                     dilation_rate=dilation_rate,
                                     activation=activation, use_bias=use_bias)
        self.to(backend.resolve_device(device))

    def forward(self, inputs):
        x, h = inputs
        weights = [x, self.hyperkernel(h)]
        if self.HyperConv_0.use_bias:
            weights.append(self.hyperbias(h))
        return self.HyperConv_0(weights)


class HyperConv2DFromDense(HyperConvFromDense):
    def __init__(self, in_features, hyper_features, filters, kernel_size,
                 rank=2, **kwargs):
        super().__init__(in_features, hyper_features, filters, kernel_size,
                         rank=rank, **kwargs)


class HyperConv3DFromDense(HyperConvFromDense):
    def __init__(self, in_features, hyper_features, filters, kernel_size,
                 rank=3, **kwargs):
        super().__init__(in_features, hyper_features, filters, kernel_size,
                         rank=rank, **kwargs)


class HyperDense(nn.Module):
    """
    Dense map with per-sample weights: forward([x, kernel(, bias)]) with x
    [B, ..., d], kernel [B, d, units] and bias [B, units]: one einsum.
    Parity: reference `layers.py:2825-2924`.
    """

    def __init__(self, units, activation=None, use_bias=True):
        super().__init__()
        self.units = units
        self.activation = activation
        self.use_bias = use_bias

    def forward(self, inputs):
        x, kernel = inputs[0], inputs[1]
        y = torch.einsum('b...i,bio->b...o', x, kernel)
        if self.use_bias:
            bias = inputs[2]
            y = y + bias.reshape(bias.shape[0], *([1] * (y.ndim - 2)),
                                 bias.shape[-1])
        return _act(self.activation, y)


class HyperDenseFromDense(nn.Module):
    """
    HyperDense with the trainable maps from the hypernetwork's output to its
    kernel (`hyperkernel`) and bias (`hyperbias`): forward([x, h]).
    Parity: reference `layers.py:2927-3033`.
    """

    def __init__(self, in_features, hyper_features, units, activation=None,
                 use_bias=True, hyperkernel_use_bias=True,
                 hyperbias_use_bias=True, hyperkernel_activation=None,
                 hyperbias_activation=None, generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.hyperkernel = _HyperDenseMapping(
            hyper_features, (in_features, units),
            use_bias=hyperkernel_use_bias, activation=hyperkernel_activation,
            generator=generator)
        if use_bias:
            self.hyperbias = _HyperDenseMapping(
                hyper_features, (units,), use_bias=hyperbias_use_bias,
                activation=hyperbias_activation, generator=generator)
        self.HyperDense_0 = HyperDense(units, activation=activation,
                                       use_bias=use_bias)
        self.to(backend.resolve_device(device))

    def forward(self, inputs):
        x, h = inputs
        weights = [x, self.hyperkernel(h)]
        if self.HyperDense_0.use_bias:
            weights.append(self.hyperbias(h))
        return self.HyperDense_0(weights)
