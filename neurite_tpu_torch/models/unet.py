"""
Conv encoder/decoder and UNet/hourglass models and their constructors (PyTorch).

Counterpart of `neurite_tpu/models/unet.py` (reference `neurite/tf/models.py`
`conv_enc:1309-1442`, `conv_dec:1445-1617`, `unet:88-246`,
`add_prior:378-435`, `dilation_net:45-85`), with the same knobs, the same
channels-last [B, *spatial, C] tensors at every public boundary, and module
attribute names that follow the flax scopes (`enc.conv_downarm_{l}_{c}`,
`dec.conv_uparm_{nb_levels+l}_{c}`, `dec.likelihood`,
`expand_down_merge_{l}`, `bn_down_{l}`, `bn_up_{l}`, ...), so that
`neurite_tpu_torch.convert` maps flax parameter trees by name.

Every `conv_impl` value of the JAX package is accepted: its z-decomposed and
im2col forms are the same math as a SAME conv, so a 1x...x1 conv becomes a
matmul over channels (`PointwiseConv`) and every other conv `F.conv{N}d`.

Parameters are float32 and are drawn on the CPU from a `torch.Generator`
(seed 0 when none is given) as flax draws them (`lecun_normal` kernels, zero
biases), then moved to `device`, so one seed gives the same weights on any
device. `device` defaults to the card (`backend.default_device()`); the CPU
runs only when a caller passes device='cpu'. `dtype` is the compute type: each conv casts its input and weights to
it, as the JAX package does.

`remat=True` recomputes the encoder and the decoder in the backward pass
(`torch.utils.checkpoint`, as `nn.remat` over the flax `ConvEnc` and
`ConvDec`): the step stores only their inputs, the skips and the
bottleneck. The recomputation draws the dropout masks of the forward pass
again (from a copy of the generator's state before it, leaving the
generator where the forward pass left it) and does not update the
BatchNorm running statistics a second time.

While a profiler records, the glue around the convs runs in spans
(`trace.span`): each `Conv`'s casts of its input, weight and bias in
'neurite/unet/cast', and each decoder level's upsampling and skip
concatenation in 'unet/upsample' and 'unet/concat' (args: the level).
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neurite_tpu_torch import backend, trace
from neurite_tpu_torch.ops import max_pool
from neurite_tpu_torch.ops.pool import _upsample  # keras UpSamplingND
from neurite_tpu_torch.parallel import spatial as sharding
from neurite_tpu_torch.utils import core

# std of a standard normal truncated to [-2, 2]; flax's variance_scaling
# divides by it (jax.nn.initializers.variance_scaling)
_TRUNC_STD = .87962566103423978


def get_activation(act):
    """Map a keras-style activation name to a torch function."""
    if act is None or callable(act):
        return act
    table = {
        'elu': F.elu,
        'relu': F.relu,
        'gelu': lambda x: F.gelu(x, approximate='tanh'),  # jax.nn.gelu
        'tanh': torch.tanh,
        'sigmoid': torch.sigmoid,
        'softmax': lambda x: torch.softmax(x, dim=-1),
        'linear': lambda x: x,
        'softplus': F.softplus,
        'leaky_relu': F.leaky_relu,
        'exp': torch.exp,
    }
    if act not in table:
        raise ValueError(f'unknown activation {act!r}')
    return table[act]


def _lecun_normal(shape, fan_in, generator):
    """flax `lecun_normal`: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1. / fan_in) / _TRUNC_STD
    w = torch.empty(shape)
    return nn.init.trunc_normal_(w, std=std, a=-2. * std, b=2. * std,
                                 generator=generator)


def _tuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(i) for i in v)


class Conv(nn.Module):
    """
    flax `nn.Conv` counterpart for N = 1, 2 or 3 spatial dims: SAME or VALID
    padding, strides, dilation. The weight is [O, I, *k] in the
    channels-last memory format, so the NDHWC input viewed as NCDHW
    (`x.movedim(-1, 1)`) goes through `F.conv{N}d` without a copy. With
    strides, SAME pads as XLA does (the high side takes the odd voxel).
    Under spatial sharding (`parallel.spatial`) a stride-1 SAME conv with
    an odd kernel on the sharded axis exchanges halos; other forms gather.
    """

    spatial_rule = 'halo'

    def __init__(self, in_features, features, kernel_size, padding='same',
                 dilation=1, dtype=None, use_bias=True, generator=None,
                 strides=1):
        super().__init__()
        ks = tuple(kernel_size)
        nd = len(ks)
        if nd not in (1, 2, 3):
            raise ValueError(f'Conv takes 1-3 spatial dims, got {ks}')
        pad = padding.lower() if isinstance(padding, str) else padding
        if pad not in ('same', 'valid'):
            raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
        w = torch.empty((features, in_features, *ks))
        fmt = {2: torch.channels_last, 3: torch.channels_last_3d}.get(nd)
        if fmt is not None:
            w = w.contiguous(memory_format=fmt)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.kernel_size = ks
        self.padding = pad
        self.dilation = int(dilation)
        self.strides = _tuple(strides, nd)
        self.dtype = dtype
        self._conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Draw the kernel (lecun normal) from `generator`; zero the bias."""
        with torch.no_grad():
            self.weight.copy_(_lecun_normal(
                tuple(self.weight.shape),
                self.weight.shape[1] * math.prod(self.kernel_size), generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        if sharding.active() is not None:
            return sharding.conv(self, x)
        return self._forward(x)

    def _forward(self, x):
        dt = self.dtype or x.dtype
        with trace.span('unet/cast'):
            w = self.weight.to(dt)
            b = None if self.bias is None else self.bias.to(dt)
            x = x.movedim(-1, 1).to(dt)
        if all(s == 1 for s in self.strides):
            y = self._conv(x, w, b, padding=self.padding,
                           dilation=self.dilation)
            return y.movedim(1, -1)
        if self.padding == 'same':
            pads = []
            for n, k, st in reversed(list(zip(x.shape[2:], self.kernel_size,
                                              self.strides))):
                pads += core._same_pad(n, k, st, self.dilation)
            x = F.pad(x, pads)
        y = self._conv(x, w, b, stride=self.strides, dilation=self.dilation)
        return y.movedim(1, -1)


class PointwiseConv(nn.Module):
    """
    1x...x1 conv as a matmul over the channel axis, `x @ W + b` (counterpart
    of the JAX `PointwiseConv`). W is the flax kernel [1,..,1,C,F] reshaped
    to [C, F].
    """

    spatial_rule = 'local'

    def __init__(self, in_features, features, ndims, dtype=None,
                 use_bias=True, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.kernel_size = (1,) * ndims
        self.dtype = dtype
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Draw the kernel (lecun normal) from `generator`; zero the bias."""
        with torch.no_grad():
            self.weight.copy_(_lecun_normal(tuple(self.weight.shape),
                                            self.weight.shape[0], generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class BatchNorm(nn.Module):
    """
    flax `nn.BatchNorm` counterpart, written out: batch statistics in
    float32 with the biased variance E[x^2] - E[x]^2, running averages
    updated as `momentum * avg + (1 - momentum) * stat` (flax momentum 0.99
    is torch's 0.01), epsilon 1e-5. Parameters `scale`, `bias`; buffers
    `mean`, `var` (flax's `batch_stats`). Under spatial sharding
    (`parallel.spatial`) the batch moments are the whole volume's: the
    blocks' summed over the 'space' group.
    """

    spatial_rule = 'reduce'
    flax_same_layout = True
    flax_buffers = {'batch_stats': ('mean', 'var')}

    def __init__(self, features, axis=-1, dtype=None, momentum=0.99,
                 epsilon=1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.axis = int(axis)
        self.dtype = dtype
        self.momentum = momentum
        self.epsilon = epsilon

    def reset_parameters(self, generator=None):
        """flax's initial values: scale and var 1, bias and mean 0."""
        with torch.no_grad():
            for t in (self.scale, self.var):
                t.fill_(1.)
            for t in (self.bias, self.mean):
                t.zero_()

    def forward(self, x, training=False, update_stats=True):
        """With training, normalize by the batch statistics and, unless
        update_stats is False, fold them into the running averages."""
        axis = self.axis % x.ndim
        red = tuple(i for i in range(x.ndim) if i != axis)
        shape = [1] * x.ndim
        shape[axis] = -1
        if training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean, sq = xf.mean(red), (xf * xf).mean(red)
            if sharding.active() is not None:
                mean, sq = sharding.batch_moments(mean, sq, axis)
            var = torch.clamp(sq - mean * mean, min=0.)
        if training and update_stats:
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1. - m) * mean)
                self.var.copy_(m * self.var + (1. - m) * var)
        if not training:
            mean, var = self.mean, self.var
        y = x - mean.reshape(shape)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = y * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


def _dropout(x, rate, training, generator, ndims):
    """flax `nn.Dropout` with broadcast over the spatial dims: one keep mask
    of shape [B, 1, ..., 1, C], drawn from `generator`."""
    if rate == 0 or not training:
        return x
    if rate == 1:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError('conv_dropout in training needs a torch.Generator')
    keep = 1. - rate
    shape = (x.shape[0],) + (1,) * ndims + (x.shape[-1],)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _conv_layer(conv_impl, cin, nf, ndims, conv_size, padding, dilation,
                dtype, generator):
    """Same choice as the JAX `_conv_layer`: 1x..x1 undilated convs under
    'auto'/'z2d'/'im2col' are matmuls; everything else is a conv."""
    ks = _tuple(conv_size, ndims)
    if (conv_impl in ('auto', 'z2d', 'im2col') and dilation == 1
            and all(k == 1 for k in ks)):
        return PointwiseConv(cin, nf, ndims, dtype=dtype, generator=generator)
    return Conv(cin, nf, ks, padding=padding, dilation=dilation, dtype=dtype,
                generator=generator)


def _level_feats(nb_features, feat_mult, level, nb_conv_per_level,
                 layer_nb_feats, lf_offset):
    """
    Per-level feature schedule, honoring the reference's three override layers
    (`models.py:1362-1381`): nb_features list-of-lists > layer_nb_feats >
    nb_features * feat_mult**level.
    Returns a list of feature counts, one per conv in the level.
    """
    if isinstance(nb_features, (list, tuple)):
        lvl = nb_features[level]
        if isinstance(lvl, (list, tuple)):
            return list(lvl)
        return [int(lvl)] * nb_conv_per_level
    feats = []
    for conv in range(nb_conv_per_level):
        if layer_nb_feats is not None:
            feats.append(int(layer_nb_feats[lf_offset + conv]))
        else:
            feats.append(int(np.round(nb_features * feat_mult ** level)))
    return feats


def _nb_levels(nb_features, nb_levels):
    return (len(nb_features) if isinstance(nb_features, (list, tuple))
            else nb_levels)


def _final_activation(like, final_pred_activation):
    if final_pred_activation == 'softmax':
        return torch.softmax(like, dim=-1)
    if final_pred_activation in (None, 'linear'):
        return like
    return get_activation(final_pred_activation)(like)


class ConvEnc(nn.Module):
    """
    Fully-convolutional encoder arm (reference `models.py:1309-1442`).
    forward returns (bottleneck, skips), skips[level] being the level's
    output before pooling. `in_channels` and `ndims` stand for the input
    shape flax infers at the first call.
    """

    spatial_rule = 'local'

    def __init__(self, in_channels, ndims, nb_features, nb_levels, conv_size,
                 feat_mult=1, pool_size=2, padding='same', dilation_rate_mult=1,
                 activation='elu', layer_nb_feats=None, use_residuals=False,
                 nb_conv_per_level=2, conv_dropout=0, batch_norm=None,
                 dtype=None, conv_impl='auto', pool_impl='auto',
                 generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.ndims = ndims
        self.nb_levels = _nb_levels(nb_features, nb_levels)
        self.act = get_activation(activation)
        self.use_residuals = use_residuals
        self.conv_dropout = conv_dropout
        self.batch_norm = batch_norm
        self.pool_size = _tuple(pool_size, ndims)
        self.pool_padding = (padding.upper() if isinstance(padding, str)
                             else padding)
        self.pool_impl = pool_impl
        self.level_feats = []
        self.skip_channels = []
        ch = in_channels
        lfidx = 0
        for level in range(self.nb_levels):
            feats = _level_feats(nb_features, feat_mult, level,
                                 nb_conv_per_level, layer_nb_feats, lfidx)
            lfidx += len(feats)
            self.level_feats.append(feats)
            dilation = dilation_rate_mult ** level
            nb_in = ch
            for conv, nf in enumerate(feats):
                self.add_module(f'conv_downarm_{level}_{conv}', _conv_layer(
                    conv_impl, ch, nf, ndims, conv_size, padding, dilation,
                    dtype, generator))
                ch = nf
            if use_residuals and nb_in > 1 and ch > 1 and nb_in != ch:
                self.add_module(f'expand_down_merge_{level}', _conv_layer(
                    conv_impl, nb_in, feats[-1], ndims, conv_size, padding,
                    dilation, dtype, generator))
            if batch_norm is not None:
                self.add_module(f'bn_down_{level}',
                                BatchNorm(ch, axis=batch_norm, dtype=dtype))
            self.skip_channels.append(ch)
        self.out_channels = ch
        self.to(backend.resolve_device(device))

    def forward(self, x, training=None, generator=None, update_stats=True):
        """update_stats=False leaves the BatchNorm running statistics as
        they are (a recomputation under remat)."""
        training = self.training if training is None else training
        act = self.act
        skips = []
        for level, feats in enumerate(self.level_feats):
            lvl_first = x
            for conv in range(len(feats)):
                last = conv == len(feats) - 1
                x = getattr(self, f'conv_downarm_{level}_{conv}')(x)
                # last conv of a residual level has no activation (ref :1383-1388)
                if not (last and self.use_residuals):
                    x = act(x)
                x = _dropout(x, self.conv_dropout, training, generator,
                             self.ndims)
            if self.use_residuals:
                add_layer = lvl_first
                merge = getattr(self, f'expand_down_merge_{level}', None)
                if merge is not None:
                    add_layer = _dropout(act(merge(lvl_first)),
                                         self.conv_dropout, training,
                                         generator, self.ndims)
                x = act(add_layer + x)
            if self.batch_norm is not None:
                x = getattr(self, f'bn_down_{level}')(x, training,
                                                      update_stats)
            skips.append(x)
            if level < self.nb_levels - 1:
                x = max_pool(x, self.pool_size, strides=self.pool_size,
                             padding=self.pool_padding, impl=self.pool_impl)
        return x, skips


class ConvDec(nn.Module):
    """
    Fully-convolutional decoder arm (reference `models.py:1445-1617`): per
    level upsample (+ skip concat, `[skip, up]`), convs, optional
    residual/BN; a final 1x1 'likelihood' conv and the prediction activation.
    With skip connections, `skip_channels[level]` is the channel count of the
    encoder's skip at that level.
    """

    spatial_rule = 'local'

    def __init__(self, in_channels, ndims, nb_features, nb_levels, conv_size,
                 nb_labels, feat_mult=1, pool_size=2,
                 use_skip_connections=False, skip_channels=None,
                 padding='same', dilation_rate_mult=1, activation='elu',
                 use_residuals=False, final_pred_activation='softmax',
                 nb_conv_per_level=2, layer_nb_feats=None, batch_norm=None,
                 conv_dropout=0, dtype=None, conv_impl='auto', generator=None,
                 device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        if use_skip_connections and skip_channels is None:
            raise ValueError('using skip connections requires skip_channels')
        self.ndims = ndims
        self.nb_levels = _nb_levels(nb_features, nb_levels)
        self.act = get_activation(activation)
        self.use_skip_connections = use_skip_connections
        self.use_residuals = use_residuals
        self.conv_dropout = conv_dropout
        self.batch_norm = batch_norm
        self.pool_size = _tuple(pool_size, ndims)
        self.final_pred_activation = final_pred_activation
        self.level_feats = []
        ch = in_channels
        lfidx = 0
        for level in range(self.nb_levels - 1):
            lindex = self.nb_levels - 2 - level
            feats = _level_feats(nb_features, feat_mult, lindex,
                                 nb_conv_per_level, layer_nb_feats, lfidx)
            lfidx += len(feats)
            self.level_feats.append(feats)
            dilation = dilation_rate_mult ** lindex
            up_ch = ch
            if use_skip_connections:
                ch = skip_channels[lindex] + ch
            for conv, nf in enumerate(feats):
                self.add_module(
                    f'conv_uparm_{self.nb_levels + level}_{conv}',
                    _conv_layer(conv_impl, ch, nf, ndims, conv_size, padding,
                                dilation, dtype, generator))
                ch = nf
            if use_residuals and up_ch > 1 and ch > 1 and up_ch != ch:
                self.add_module(f'expand_up_merge_{level}', _conv_layer(
                    conv_impl, up_ch, feats[-1], ndims, conv_size, padding,
                    dilation, dtype, generator))
            if batch_norm is not None:
                self.add_module(f'bn_up_{level}',
                                BatchNorm(ch, axis=batch_norm, dtype=dtype))
        # final 1x1 likelihood conv (no activation), a matmul as in JAX
        self.likelihood = PointwiseConv(ch, nb_labels, ndims, dtype=dtype,
                                        generator=generator)
        self.to(backend.resolve_device(device))

    def forward(self, x, skips=None, training=None, generator=None,
                update_stats=True):
        """update_stats=False leaves the BatchNorm running statistics as
        they are (a recomputation under remat)."""
        training = self.training if training is None else training
        act = self.act
        if self.use_skip_connections and skips is None:
            raise ValueError('using skip connections requires encoder skips')
        for level, feats in enumerate(self.level_feats):
            lindex = self.nb_levels - 2 - level
            with trace.span('unet/upsample', level):
                x = _upsample(x, self.pool_size)
            up_tensor = x
            if self.use_skip_connections:
                with trace.span('unet/concat', level):
                    x = torch.cat([skips[lindex], x], dim=-1)
            for conv in range(len(feats)):
                last = conv == len(feats) - 1
                x = getattr(self, f'conv_uparm_{self.nb_levels + level}_{conv}')(x)
                if not (last and self.use_residuals):
                    x = act(x)
                x = _dropout(x, self.conv_dropout, training, generator,
                             self.ndims)
            if self.use_residuals:
                add_layer = up_tensor
                merge = getattr(self, f'expand_up_merge_{level}', None)
                if merge is not None:
                    add_layer = act(merge(add_layer))
                x = act(x + add_layer)
            if self.batch_norm is not None:
                x = getattr(self, f'bn_up_{level}')(x, training,
                                                    update_stats)
        return _final_activation(self.likelihood(x), self.final_pred_activation)


class AddPrior(nn.Module):
    """
    Posterior head merging a likelihood with a spatial prior: log-prior add
    (use_logp) or sigmoid-likelihood multiply, then the final activation
    (reference `models.py:378-435`).
    """

    spatial_rule = 'local'

    def __init__(self, use_logp=True, final_pred_activation='softmax'):
        super().__init__()
        if final_pred_activation == 'softmax' and not use_logp:
            raise ValueError('cannot do softmax when adding prior via P()')
        self.use_logp = use_logp
        self.final_pred_activation = final_pred_activation

    def forward(self, like, prior):
        post = prior + like if self.use_logp else prior * torch.sigmoid(like)
        if self.final_pred_activation == 'softmax':
            return torch.softmax(post, dim=-1)
        return post


def _remat(fn, generator, *args):
    """
    fn(*args, generator=, update_stats=) under `torch.utils.checkpoint`
    (non-reentrant): its intermediates are recomputed in the backward pass.
    checkpoint's `preserve_rng_state` covers the global generators only, so
    the recomputation draws from a copy of `generator` set to its state
    before the forward pass (the same dropout masks, and `generator` is not
    advanced again), and leaves the BatchNorm running statistics alone.
    """
    state = None if generator is None else generator.get_state()
    calls = []

    def run(*a):
        gen = generator
        if calls and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        first = not calls
        calls.append(None)
        return fn(*a, generator=gen, update_stats=first)

    return checkpoint(run, *args, use_reentrant=False)


class UNet(nn.Module):
    """
    UNet/hourglass: ConvEnc + ConvDec with skip connections + optional prior
    head (reference `models.py:88-246`). A list of inputs is concatenated on
    the channel axis; `in_channels` counts the channels after that concat.

    space_to_depth=s > 1 folds s^N spatial tiles of the input into channels
    (`utils.core.space_to_depth`); the decoder predicts nb_labels * s^N
    channels with a linear head, which are unfolded before the final
    activation (JAX `models/unet.py:486-552`). remat=True recomputes the
    encoder and the decoder in the backward pass (see the module's
    docstring).
    """

    spatial_rule = 'local'

    def __init__(self, in_channels, ndims, nb_features, nb_levels, conv_size,
                 nb_labels, feat_mult=1, pool_size=2, use_logp=True,
                 padding='same', dilation_rate_mult=1, activation='elu',
                 use_residuals=False, final_pred_activation='softmax',
                 nb_conv_per_level=1, add_prior_layer=False,
                 layer_nb_feats=None, conv_dropout=0, batch_norm=None,
                 dtype=None, space_to_depth=1, conv_impl='auto', remat=False,
                 pool_impl='auto', generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        device = backend.resolve_device(device)
        nb_levels = _nb_levels(nb_features, nb_levels)
        n_enc = nb_levels * nb_conv_per_level
        enc_lnf = layer_nb_feats[:n_enc] if layer_nb_feats is not None else None
        dec_lnf = layer_nb_feats[n_enc:] if layer_nb_feats is not None else None
        self.add_prior_layer = add_prior_layer
        self.final_pred_activation = final_pred_activation
        self.space_to_depth = int(space_to_depth)
        self.remat = remat
        fold = self.space_to_depth ** ndims if self.space_to_depth > 1 else 1
        self.enc = ConvEnc(
            in_channels * fold, ndims, nb_features, nb_levels, conv_size,
            feat_mult=feat_mult, pool_size=pool_size, padding=padding,
            dilation_rate_mult=dilation_rate_mult, activation=activation,
            layer_nb_feats=enc_lnf, use_residuals=use_residuals,
            nb_conv_per_level=nb_conv_per_level, conv_dropout=conv_dropout,
            batch_norm=batch_norm, dtype=dtype, conv_impl=conv_impl,
            pool_impl=pool_impl, generator=generator, device=device)
        self.dec = ConvDec(
            self.enc.out_channels, ndims, nb_features, nb_levels, conv_size,
            nb_labels * fold, feat_mult=feat_mult, pool_size=pool_size,
            use_skip_connections=True, skip_channels=self.enc.skip_channels,
            padding=padding, dilation_rate_mult=dilation_rate_mult,
            activation=activation, use_residuals=use_residuals,
            final_pred_activation=('linear' if add_prior_layer or fold > 1
                                   else final_pred_activation),
            nb_conv_per_level=nb_conv_per_level, layer_nb_feats=dec_lnf,
            batch_norm=batch_norm, conv_dropout=conv_dropout, dtype=dtype,
            conv_impl=conv_impl, generator=generator, device=device)
        if add_prior_layer:
            self.prior = AddPrior(use_logp=use_logp,
                                  final_pred_activation=final_pred_activation)
        self.to(backend.resolve_device(device))

    def forward(self, x, prior=None, training=None, generator=None):
        """x [B, *spatial, C] (or a list of such) -> prediction
        [B, *spatial, nb_labels]. `generator` draws the dropout masks."""
        training = self.training if training is None else training
        if isinstance(x, (list, tuple)):
            spatial = x[0].shape[1:-1]
            for xi in x[1:]:
                if xi.shape[1:-1] != spatial:
                    raise ValueError(
                        'spatial dimensions must match if multiple inputs are '
                        f'provided, but got shapes {tuple(spatial)} and '
                        f'{tuple(xi.shape[1:-1])}')
            x = torch.cat(list(x), dim=-1)
        s2d = self.space_to_depth
        if s2d > 1:
            x = core.space_to_depth(x, s2d)
        if self.remat and torch.is_grad_enabled():
            x, skips = _remat(self.enc, generator, x, training)
            pred = _remat(self.dec, generator, x, skips, training)
        else:
            x, skips = self.enc(x, training=training, generator=generator)
            pred = self.dec(x, skips, training=training, generator=generator)
        if s2d > 1:
            pred = core.depth_to_space(pred, s2d)
            if not self.add_prior_layer:
                pred = _final_activation(pred, self.final_pred_activation)
        if self.add_prior_layer:
            if prior is None:
                raise ValueError('add_prior_layer requires a prior input')
            pred = self.prior(pred, prior)
        return pred


###############################################################################
# constructor functions (reference API)
###############################################################################

def unet(nb_features, input_shape, nb_levels, conv_size, nb_labels,
         name='unet', prefix=None, feat_mult=1, pool_size=2, use_logp=True,
         padding='same', dilation_rate_mult=1, activation='elu',
         use_residuals=False, final_pred_activation='softmax',
         nb_conv_per_level=1, add_prior_layer=False, add_prior_layer_reg=0,
         layer_nb_feats=None, conv_dropout=0, batch_norm=None, dtype=None,
         space_to_depth=1, conv_impl='auto', remat=False, pool_impl='auto',
         generator=None, device=None):
    """
    Build a UNet module (reference `neurite/tf/models.py:88-246` knob set).

    `input_shape` is (*spatial, C): its length gives the spatial dims and its
    last entry the input channels, which flax infers and torch needs at
    construction. `pool_impl` picks the pool ('auto', 'kernel' or 'plain',
    see `ops.max_pool`); `generator` draws the initial parameters.
    """
    del name, prefix, add_prior_layer_reg  # naming/keras-isms
    return UNet(int(input_shape[-1]), len(input_shape) - 1, nb_features,
                nb_levels, conv_size, nb_labels, feat_mult=feat_mult,
                pool_size=pool_size, use_logp=use_logp, padding=padding,
                dilation_rate_mult=dilation_rate_mult, activation=activation,
                use_residuals=use_residuals,
                final_pred_activation=final_pred_activation,
                nb_conv_per_level=nb_conv_per_level,
                add_prior_layer=add_prior_layer,
                layer_nb_feats=layer_nb_feats, conv_dropout=conv_dropout,
                batch_norm=batch_norm, dtype=dtype,
                space_to_depth=space_to_depth, conv_impl=conv_impl,
                remat=remat, pool_impl=pool_impl, generator=generator,
                device=device)


def dilation_net(nb_features, input_shape, nb_levels, conv_size, nb_labels,
                 name='dilation_net', prefix=None, feat_mult=1, pool_size=2,
                 use_logp=True, padding='same', dilation_rate_mult=2,
                 activation='elu', use_residuals=False,
                 final_pred_activation='softmax', nb_conv_per_level=1,
                 add_prior_layer=False, add_prior_layer_reg=0,
                 layer_nb_feats=None, conv_dropout=0, batch_norm=None,
                 dtype=None, space_to_depth=1, conv_impl='auto',
                 remat=False, pool_impl='auto', generator=None, device=None):
    """UNet preset with dilation_rate_mult=2 (ref `models.py:45-85`)."""
    return unet(nb_features, input_shape, nb_levels, conv_size, nb_labels,
                name=name, prefix=prefix, feat_mult=feat_mult,
                pool_size=pool_size, use_logp=use_logp, padding=padding,
                dilation_rate_mult=dilation_rate_mult, activation=activation,
                use_residuals=use_residuals,
                final_pred_activation=final_pred_activation,
                nb_conv_per_level=nb_conv_per_level,
                add_prior_layer=add_prior_layer,
                add_prior_layer_reg=add_prior_layer_reg,
                layer_nb_feats=layer_nb_feats, conv_dropout=conv_dropout,
                batch_norm=batch_norm, dtype=dtype,
                space_to_depth=space_to_depth, conv_impl=conv_impl,
                remat=remat, pool_impl=pool_impl, generator=generator,
                device=device)


def conv_enc(nb_features, input_shape, nb_levels, conv_size, name=None,
             prefix=None, feat_mult=1, pool_size=2, dilation_rate_mult=1,
             padding='same', activation='elu', layer_nb_feats=None,
             use_residuals=False, nb_conv_per_level=2, conv_dropout=0,
             batch_norm=None, generator=None, device=None):
    """Build a ConvEnc module (ref `models.py:1309-1442` knob set)."""
    del name, prefix
    return ConvEnc(int(input_shape[-1]), len(input_shape) - 1, nb_features,
                   nb_levels, conv_size, feat_mult=feat_mult,
                   pool_size=pool_size, padding=padding,
                   dilation_rate_mult=dilation_rate_mult,
                   activation=activation, layer_nb_feats=layer_nb_feats,
                   use_residuals=use_residuals,
                   nb_conv_per_level=nb_conv_per_level,
                   conv_dropout=conv_dropout, batch_norm=batch_norm,
                   generator=generator, device=device)


def conv_dec(nb_features, input_shape, nb_levels, conv_size, nb_labels,
             name=None, prefix=None, feat_mult=1, pool_size=2,
             use_skip_connections=False, padding='same', dilation_rate_mult=1,
             activation='elu', use_residuals=False,
             final_pred_activation='softmax', nb_conv_per_level=2,
             layer_nb_feats=None, batch_norm=None, conv_dropout=0,
             skip_channels=None, generator=None, device=None):
    """Build a ConvDec module (ref `models.py:1445-1617` knob set).
    `input_shape` is the bottleneck's (*spatial, C)."""
    del name, prefix
    return ConvDec(int(input_shape[-1]), len(input_shape) - 1, nb_features,
                   nb_levels, conv_size, nb_labels, feat_mult=feat_mult,
                   pool_size=pool_size,
                   use_skip_connections=use_skip_connections,
                   skip_channels=skip_channels, padding=padding,
                   dilation_rate_mult=dilation_rate_mult,
                   activation=activation, use_residuals=use_residuals,
                   final_pred_activation=final_pred_activation,
                   nb_conv_per_level=nb_conv_per_level,
                   layer_nb_feats=layer_nb_feats, batch_norm=batch_norm,
                   conv_dropout=conv_dropout, generator=generator,
                   device=device)


def add_prior(input_model=None, prior_shape=None, name='prior_model',
              prefix=None, use_logp=True, final_pred_activation='softmax',
              add_prior_layer_reg=0):
    """Build an AddPrior head module (ref `models.py:378-435` knob set)."""
    del input_model, prior_shape, name, prefix, add_prior_layer_reg
    return AddPrior(use_logp=use_logp,
                    final_pred_activation=final_pred_activation)
