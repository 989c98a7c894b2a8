"""
Classifier and regressor models and their constructors (PyTorch).

Counterpart of `neurite_tpu/models/classify.py` (reference
`neurite/tf/models.py`: `design_dnn:1620-1775`, `EncoderNet:1782-1848`,
`DenseLayerNet:1851-1880`), with the flax scope names as attribute names
(`conv_{level}_{conv}`, `strided_conv_{level}`, `enc`, `dense`,
`output_dense`, `dense{i}`, `BatchNorm{i}`, ...), so
`neurite_tpu_torch.convert` moves parameters and BatchNorm statistics by
name. Flax sizes each Dense from its first input; torch needs the shapes
at construction, so the builders use the `input_shape` (*spatial, C) that
the JAX builders drop. The max-pool route reaches the pool kernels on a
CUDA tensor (`pool_impl`, as in `models.unet`).

The JAX modules' `nn.Dropout` drops single elements (no broadcast); its
masks are drawn here from the `generator` a forward call is given.
`DenseLayerNetModule` sows its l1/l2 kernel penalty under ('losses',
'regularization'); here forward leaves it in the `regularization`
attribute, for the loss to add.
"""

import math

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch import backend
from neurite_tpu_torch.layers.basic import RescaleValues
from neurite_tpu_torch.models.ae import Dense
from neurite_tpu_torch.models.unet import (BatchNorm, Conv, ConvEnc,
                                           _conv_layer, _tuple,
                                           get_activation)
from neurite_tpu_torch.ops import max_pool

_FINAL_LAYERS = ('dense-sigmoid', 'dense-tanh', 'dense-softmax',
                 'myglobalmaxpooling', 'globalmaxpooling')


def _dropout(x, rate, training, generator):
    """flax `nn.Dropout`: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate)."""
    if not rate or not training:
        return x
    if generator is None:
        raise ValueError('dropout in training needs a torch.Generator')
    keep = 1. - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _conv_out(size, k, padding, stride=1, dilation=1):
    """Output length of a conv or pool along one axis (flax SAME/VALID)."""
    if str(padding).upper() == 'SAME':
        return -(-size // stride)
    return (size - (k - 1) * dilation - 1) // stride + 1


class DesignDNN(nn.Module):
    """
    "Deep" CNN encoder with a dense or global-max-pool head. Parity:
    reference `models.py:1620-1775` (final_layer 'dense-sigmoid',
    'dense-tanh', 'dense-softmax', 'myglobalmaxpooling' or
    'globalmaxpooling'; strided-conv or max-pool downsampling).
    """

    def __init__(self, input_shape, nb_features, nb_levels, conv_size,
                 nb_labels, feat_mult=1, pool_size=2, padding='same',
                 activation='elu', final_layer='dense-sigmoid',
                 conv_dropout=0, nb_input_features=1, batch_norm=False,
                 use_strided_convolution_maxpool=True, nb_conv_per_level=2,
                 pool_impl='auto', generator=None, device=None):
        super().__init__()
        if final_layer not in _FINAL_LAYERS:
            raise ValueError(f'unknown final_layer {final_layer!r}')
        generator = generator or torch.Generator().manual_seed(0)
        spatial = [int(s) for s in input_shape[:-1]]
        ndims = len(spatial)
        cs = _tuple(conv_size, ndims)
        self.pool_size = _tuple(pool_size, ndims)
        self.padding = padding
        self.act = get_activation(activation)
        self.final_layer = final_layer
        self.conv_dropout = conv_dropout
        self.strided = use_strided_convolution_maxpool
        self.pool_impl = pool_impl
        self.levels = []
        ch = int(input_shape[-1])
        for level in range(nb_levels):
            nf = int(np.round(nb_features * feat_mult ** level))
            for conv in range(nb_conv_per_level):
                self.add_module(f'conv_{level}_{conv}', _conv_layer(
                    'auto', ch, nf, ndims, cs, padding, 1, None, generator))
                ch = nf
                spatial = [_conv_out(s, k, padding)
                           for s, k in zip(spatial, cs)]
            if self.strided:
                self.add_module(f'strided_conv_{level}', Conv(
                    ch, nf, self.pool_size, padding=padding,
                    generator=generator, strides=self.pool_size))
            spatial = [_conv_out(s, p, padding, p)
                       for s, p in zip(spatial, self.pool_size)]
            self.levels.append(nb_conv_per_level)
        flat = ch * math.prod(spatial)
        if final_layer in ('dense-sigmoid', 'dense-tanh'):
            self.dense = Dense(flat, 1, generator)
        elif final_layer == 'dense-softmax':
            self.dense = Dense(flat, nb_labels, generator)
        elif final_layer == 'myglobalmaxpooling':
            self.batch_norm = BatchNorm(ch)
            self.global_max_pool_sigmoid = Conv(1, 1, (1,),
                                                generator=generator)
        else:
            self.conv_to_featmaps = Conv(ch, 2, (1,) * ndims,
                                         generator=generator)
        self.to(backend.resolve_device(device))

    def forward(self, x, training=None, generator=None):
        training = self.training if training is None else training
        act = self.act
        for level, nb_conv in enumerate(self.levels):
            for conv in range(nb_conv):
                x = _dropout(x, self.conv_dropout, training, generator)
                x = act(getattr(self, f'conv_{level}_{conv}')(x))
            if self.strided:
                x = act(getattr(self, f'strided_conv_{level}')(x))
            else:
                x = max_pool(x, self.pool_size, strides=self.pool_size,
                             padding=self.padding.upper(),
                             impl=self.pool_impl)
        fl = self.final_layer
        if fl.startswith('dense-'):
            y = self.dense(x.reshape(x.shape[0], -1))
            if fl == 'dense-sigmoid':
                return torch.sigmoid(y)
            return torch.tanh(y) if fl == 'dense-tanh' else \
                torch.softmax(y, dim=-1)
        if fl == 'myglobalmaxpooling':
            x = self.batch_norm(x, training)
            x = x.reshape(x.shape[0], -1).amax(1).reshape(-1, 1, 1)
            return torch.sigmoid(self.global_max_pool_sigmoid(x))
        x = torch.relu(self.conv_to_featmaps(x))
        return torch.softmax(x.reshape(x.shape[0], -1, x.shape[-1]).amax(1),
                             dim=-1)


class EncoderNetModule(nn.Module):
    """
    ConvEnc -> flatten -> Dense(dense_size) -> Dense(nb_labels) classifier;
    a regressor when nb_labels <= 0. Parity: reference `models.py:1782-1848`.
    """

    def __init__(self, input_shape, nb_features, nb_levels, conv_size,
                 feat_mult=1, pool_size=2, dilation_rate_mult=1,
                 padding='same', activation='elu', layer_nb_feats=None,
                 use_residuals=False, nb_conv_per_level=2, conv_dropout=0,
                 dense_size=256, nb_labels=2, final_activation=None,
                 rescale=None, dropout=None, batch_norm=None,
                 pool_impl='auto', generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        device = backend.resolve_device(device)
        spatial = [int(s) for s in input_shape[:-1]]
        ndims = len(spatial)
        self.enc = ConvEnc(
            int(input_shape[-1]), ndims, nb_features, nb_levels, conv_size,
            feat_mult=feat_mult, pool_size=pool_size, padding=padding,
            dilation_rate_mult=dilation_rate_mult, activation=activation,
            layer_nb_feats=layer_nb_feats, use_residuals=use_residuals,
            nb_conv_per_level=nb_conv_per_level, conv_dropout=conv_dropout,
            batch_norm=batch_norm, pool_impl=pool_impl, generator=generator,
            device=device)
        cs, ps = _tuple(conv_size, ndims), _tuple(pool_size, ndims)
        for level, feats in enumerate(self.enc.level_feats):
            dil = dilation_rate_mult ** level
            for _ in feats:
                spatial = [_conv_out(s, k, padding, 1, dil)
                           for s, k in zip(spatial, cs)]
            if level < self.enc.nb_levels - 1:
                spatial = [_conv_out(s, p, padding, p)
                           for s, p in zip(spatial, ps)]
        self.dropout = dropout
        self.dense = Dense(self.enc.out_channels * math.prod(spatial),
                           dense_size, generator)
        self.rescale = None if rescale is None else RescaleValues(rescale)
        if nb_labels <= 0:   # regression
            nb_labels = 1
            final_activation = final_activation or 'linear'
        self.final_act = get_activation(final_activation or 'softmax')
        self.output_dense = Dense(dense_size, nb_labels, generator)
        self.to(device)

    def forward(self, x, training=None, generator=None):
        training = self.training if training is None else training
        x, _ = self.enc(x, training=training, generator=generator)
        x = _dropout(x.reshape(x.shape[0], -1), self.dropout, training,
                     generator)
        x = _dropout(self.dense(x), self.dropout, training, generator)
        if self.rescale is not None:
            x = self.rescale(x)
        return self.final_act(self.output_dense(x))


class DenseLayerNetModule(nn.Module):
    """
    MLP classifier with an l1/l2 penalty on its hidden kernels, left in
    `regularization` by each forward call (flax sows it under ('losses',
    'regularization')). Parity: reference `models.py:1851-1880`, whose code
    would raise (typos); this is the working equivalent the JAX package
    has.
    """

    def __init__(self, inshape, layer_sizes, nb_labels=2, activation='relu',
                 final_activation='softmax', dropout=None, batch_norm=None,
                 l1=1e-5, l2=1e-4, generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.layer_sizes = [int(s) for s in layer_sizes]
        self.act = get_activation(activation)
        self.dropout = dropout
        self.batch_norm = batch_norm
        self.l1, self.l2 = l1, l2
        ch = math.prod(int(s) for s in inshape)
        for lno, size in enumerate(self.layer_sizes):
            self.add_module(f'dense{lno}', Dense(ch, size, generator))
            if batch_norm is not None:
                self.add_module(f'BatchNorm{lno}', BatchNorm(size))
            ch = size
        self.last_dense = Dense(ch, nb_labels, generator)
        fa = final_activation
        if nb_labels <= 0 and fa is None:
            fa = 'linear'
        self.final_act = get_activation(fa or 'softmax')
        self.regularization = None
        self.to(backend.resolve_device(device))

    def forward(self, x, training=None, generator=None):
        training = self.training if training is None else training
        x = x.reshape(x.shape[0], -1)
        reg = 0.
        for lno in range(len(self.layer_sizes)):
            dense = getattr(self, f'dense{lno}')
            x = self.act(dense(x))
            k = dense.kernel
            reg = reg + self.l1 * k.abs().sum() + \
                (self.l2 + self.l2) * k.square().sum()
            x = _dropout(x, self.dropout, training, generator)
            if self.batch_norm is not None:
                x = getattr(self, f'BatchNorm{lno}')(x, training)
        self.regularization = reg
        return self.final_act(self.last_dense(x))


def design_dnn(nb_features, input_shape, nb_levels, conv_size, nb_labels,
               feat_mult=1, pool_size=2, padding='same', activation='elu',
               final_layer='dense-sigmoid', conv_dropout=0, conv_maxnorm=0,
               nb_input_features=1, batch_norm=False, name=None, prefix=None,
               use_strided_convolution_maxpool=True, nb_conv_per_level=2,
               pool_impl='auto', generator=None, device=None):
    """Build a DesignDNN module (ref `models.py:1620-1775` knob set);
    `input_shape` is (*spatial, C)."""
    del name, prefix, conv_maxnorm
    return DesignDNN(input_shape, nb_features, nb_levels, conv_size,
                     nb_labels, feat_mult=feat_mult, pool_size=pool_size,
                     padding=padding, activation=activation,
                     final_layer=final_layer, conv_dropout=conv_dropout,
                     nb_input_features=nb_input_features,
                     batch_norm=batch_norm,
                     use_strided_convolution_maxpool=
                     use_strided_convolution_maxpool,
                     nb_conv_per_level=nb_conv_per_level,
                     pool_impl=pool_impl, generator=generator, device=device)


def EncoderNet(nb_features, input_shape, nb_levels, conv_size, name=None,
               prefix=None, feat_mult=1, pool_size=2, dilation_rate_mult=1,
               padding='same', activation='elu', layer_nb_feats=None,
               use_residuals=False, nb_conv_per_level=2, conv_dropout=0,
               dense_size=256, nb_labels=2, final_activation=None,
               rescale=None, dropout=None, batch_norm=None, pool_impl='auto',
               generator=None, device=None):
    """Build an EncoderNet module (ref `models.py:1782-1848` knob set);
    `input_shape` is (*spatial, C)."""
    del name, prefix
    if isinstance(nb_features, (list, tuple)):
        nb_levels = None
    return EncoderNetModule(
        input_shape, nb_features, nb_levels, conv_size, feat_mult=feat_mult,
        pool_size=pool_size, dilation_rate_mult=dilation_rate_mult,
        padding=padding, activation=activation,
        layer_nb_feats=layer_nb_feats, use_residuals=use_residuals,
        nb_conv_per_level=nb_conv_per_level, conv_dropout=conv_dropout,
        dense_size=dense_size, nb_labels=nb_labels,
        final_activation=final_activation, rescale=rescale, dropout=dropout,
        batch_norm=batch_norm, pool_impl=pool_impl, generator=generator,
        device=device)


def DenseLayerNet(inshape, layer_sizes, nb_labels=2, activation='relu',
                  final_activation='softmax', dropout=None, batch_norm=None,
                  generator=None, device=None):
    """Build a DenseLayerNet module (ref `models.py:1851-1880` knob set);
    `inshape` is the shape of one sample, flattened at the input."""
    return DenseLayerNetModule(inshape, layer_sizes, nb_labels=nb_labels,
                               activation=activation,
                               final_activation=final_activation,
                               dropout=dropout, batch_norm=batch_norm,
                               generator=generator, device=device)
