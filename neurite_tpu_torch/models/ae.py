"""
Auto-encoders: the single-bottleneck AE and the conv (V)AE; counterpart of
`neurite_tpu/models/ae.py` (reference `neurite/tf/models.py`, `ae:249-375`,
`single_ae:438-646`).

Module attribute names follow the flax scopes (`enc`, `mid.ae_mu_enc_conv`,
`mid.ae_sigma_enc_dense`, `mid.ae_mu_bn`, `mid.ae_conv_dec`, `dec`, ...), so
`neurite_tpu_torch.convert` maps flax trees, BatchNorm statistics included,
by name. Torch needs shapes at construction, so `SingleAE` takes the
`input_shape` (*spatial, C) it encodes, and `AE` computes its encoder's
output shape from its own.

The JAX modules sow mu, log-var and the sample into flax's 'intermediates';
here forward(..., return_intermediates=True) returns (output,
{'ae_mu': .., 'ae_sigma': .., 'ae_sample': ..}), the last two for a VAE
only. The sample layer draws its noise from `generator`, or takes it as
`noise` (the tests hand it the JAX run's). The bottleneck convs compute in
float32, as the JAX package's do (float32 parameters, no compute dtype), so
a bfloat16 encoder gives a float32 latent and decoder.
"""

import math

import torch
import torch.nn as nn

from neurite_tpu_torch import backend
from neurite_tpu_torch.layers import local  # a module: local imports models
from neurite_tpu_torch.layers.basic import Resize
from neurite_tpu_torch.layers.random import SampleNormalLogVar
from neurite_tpu_torch.models.unet import (AddPrior, BatchNorm, ConvDec,
                                           ConvEnc, _conv_layer,
                                           _lecun_normal, get_activation)

__all__ = ['Dense', 'SingleAE', 'AE', 'ae', 'single_ae']

_MODES = ('full', 'encode', 'decode')


class Dense(nn.Module):
    """flax `nn.Dense`: x @ kernel + bias, with the kernel [in, out] in
    flax's layout (so `convert` copies it as it is), lecun-normal kernel and
    zero bias; the compute type is that of x and the kernel promoted."""

    flax_same_layout = True

    def __init__(self, in_features, features, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Draw the kernel (lecun normal) from `generator`; zero the bias."""
        with torch.no_grad():
            self.kernel.copy_(_lecun_normal(tuple(self.kernel.shape),
                                            self.kernel.shape[0], generator))
            self.bias.zero_()

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


def _bn_features(shape, axis):
    """The size of `axis` (of the batched tensor) for an unbatched shape."""
    full = (1, *shape)
    return int(full[axis])


class SingleAE(nn.Module):
    """
    Single-bottleneck auto-encoder (input -> encoding -> output), dense or
    conv type, optionally variational.

    forward(x, training, mode, out_shape, generator, noise,
    return_intermediates): mode 'full' (encode and decode), 'encode' (x ->
    z, the sample or mu) or 'decode' (z -> reconstruction of
    `input_shape`; `out_shape`, which the JAX module needs, must match it
    when given).

    Parity: reference `neurite/tf/models.py:438-646`.
    """

    def __init__(self, input_shape, enc_size, ae_type='dense', conv_size=None,
                 enc_lambda_layers=None, batch_norm=None, padding='same',
                 activation=None, include_mu_shift_layer=False, do_vae=False,
                 generator=None, device=None):
        super().__init__()
        if ae_type not in ('dense', 'conv'):
            raise ValueError(f"ae_type must be 'dense' or 'conv', got "
                             f"{ae_type!r}")
        generator = generator or torch.Generator().manual_seed(0)
        self.input_shape = tuple(int(s) for s in input_shape)
        self.enc_size = list(enc_size)
        self.ae_type, self.batch_norm = ae_type, batch_norm
        self.enc_lambda_layers = list(enc_lambda_layers or [])
        self.act = get_activation(activation)
        self.include_mu_shift_layer, self.do_vae = include_mu_shift_layer, \
            do_vae
        shape = self.input_shape
        nb_feats = shape[-1]
        ndims = len(shape) - 1
        enc = self.enc_size

        def conv(cin, nf):
            if conv_size is None:
                raise ValueError('with conv ae, need conv_size')
            return _conv_layer('auto', cin, nf, ndims, conv_size, padding, 1,
                               torch.float32, generator)

        tags = ('mu', 'sigma') if do_vae else ('mu',)
        self.resize = ae_type == 'conv' and enc[:-1] != list(shape[:-1])
        if ae_type == 'dense':
            if len(enc) != 1:
                raise ValueError('enc_size should be of length 1 for dense '
                                 'layer')
            for tag in tags:
                self.add_module(f'ae_{tag}_enc_dense', Dense(
                    math.prod(shape), enc[0], generator))
            latent = (enc[0],)
        else:
            if len(enc) != len(shape):
                raise ValueError(f'encoding size does not match input shape '
                                 f'{len(enc)} {len(shape)}')
            if self.resize:
                for tag in tags:
                    self.add_module(f'ae_{tag}_enc_conv',
                                    conv(nb_feats, enc[-1]))
                latent = tuple(enc)
            elif enc[-1] is None:
                if do_vae:   # the sigma branch is a conv of its own
                    self.ae_sigma_enc = conv(nb_feats, nb_feats)
                latent = shape
            else:
                for tag in tags:
                    self.add_module(f'ae_{tag}_enc', conv(nb_feats, enc[-1]))
                latent = (*shape[:-1], enc[-1])
        if self.enc_lambda_layers:   # the shape the lambda layers give
            t = torch.zeros((1, *latent))
            for fcn in self.enc_lambda_layers:
                t = fcn(t)
            latent = tuple(t.shape[1:])
        self.latent_shape = tuple(int(s) for s in latent)
        if batch_norm is not None:
            for tag in tags:
                self.add_module(f'ae_{tag}_bn', BatchNorm(
                    _bn_features(latent, batch_norm), axis=batch_norm))
        if include_mu_shift_layer:
            self.ae_mu_shift = local.LocalBias(latent, generator=generator,
                                               device=device)
            self.ae_sample_shift = local.LocalBias(
                latent, generator=generator, device=device)
        if do_vae:
            self.ae_sample_layer = SampleNormalLogVar()
        if ae_type == 'dense':
            self.ae_dense_dec = Dense(latent[-1], math.prod(shape), generator)
        else:
            self.ae_conv_dec = conv(latent[-1], nb_feats)
        if batch_norm is not None:
            self.bn_ae_dec = BatchNorm(_bn_features(shape, batch_norm),
                                       axis=batch_norm)
        self.to(backend.resolve_device(device))

    def _conv_act(self, name, t):
        t = getattr(self, name)(t)
        return self.act(t) if self.act is not None else t

    def _encode(self, tag, pre, training):
        enc = self.enc_size
        if self.ae_type == 'dense':
            t = getattr(self, f'ae_{tag}_enc_dense')(pre)
        elif self.resize:
            t = self._conv_act(f'ae_{tag}_enc_conv', pre)
            t = Resize([e / s for e, s in zip(enc[:-1], t.shape[1:-1])])(t)
        elif enc[-1] is None:
            t = pre if tag == 'mu' else self._conv_act('ae_sigma_enc', pre)
        else:
            t = self._conv_act(f'ae_{tag}_enc', pre)
        for fcn in self.enc_lambda_layers:
            t = fcn(t)
        if self.batch_norm is not None:
            t = getattr(self, f'ae_{tag}_bn')(t, training)
        return t

    def forward(self, x, training=None, mode='full', out_shape=None,
                generator=None, noise=None, return_intermediates=False):
        if mode not in _MODES:
            raise ValueError(f'mode must be one of {_MODES}, got {mode!r}')
        training = self.training if training is None else training
        shape = self.input_shape
        inter = {}
        if mode == 'decode':
            if out_shape is not None and tuple(out_shape) != shape:
                raise ValueError(f'this AE reconstructs {shape}, not '
                                 f'{tuple(out_shape)}')
            t = x
        else:
            pre = (x.reshape(x.shape[0], -1)
                   if self.ae_type == 'dense' and len(shape) > 1 else x)
            t = self._encode('mu', pre, training)
            if self.include_mu_shift_layer:
                t = self.ae_mu_shift(t)
            inter['ae_mu'] = t
            if self.do_vae:
                log_var = self._encode('sigma', pre, training)
                inter['ae_sigma'] = log_var
                layer = self.ae_sample_layer
                if noise is None:
                    noise = layer.draw(t.shape, generator, t.device)
                t = layer.apply([t, log_var], noise)
                inter['ae_sample'] = t
            if mode == 'encode':
                return (t, inter) if return_intermediates else t

        if self.include_mu_shift_layer:
            t = self.ae_sample_shift(t)
        if self.ae_type == 'dense':
            t = self.ae_dense_dec(t)
            if len(shape) > 1:
                t = t.reshape(-1, *shape)
        else:
            if self.resize:
                t = Resize([s / e for s, e in zip(shape[:-1],
                                                  self.enc_size[:-1])])(t)
            t = self._conv_act('ae_conv_dec', t)
        if self.batch_norm is not None:
            t = self.bn_ae_dec(t, training)
        return (t, inter) if return_intermediates else t


def _enc_out_shape(enc, spatial):
    """(*spatial, C) of ConvEnc `enc`'s output for an input of `spatial`:
    'valid' convs shrink each axis by (k - 1), and each pool but the last
    level's divides it by the window (ceil under SAME, floor under VALID)."""
    spatial = list(spatial)
    for level, feats in enumerate(enc.level_feats):
        for c in range(len(feats)):
            conv = getattr(enc, f'conv_downarm_{level}_{c}')
            if getattr(conv, 'padding', 'same') == 'valid':
                spatial = [s - (k - 1) * conv.dilation
                           for s, k in zip(spatial, conv.kernel_size)]
        if level < enc.nb_levels - 1:
            p = enc.pool_size
            spatial = ([-(-s // w) for s, w in zip(spatial, p)]
                       if enc.pool_padding == 'SAME' else
                       [(s - w) // w + 1 for s, w in zip(spatial, p)])
    return (*spatial, enc.out_channels)


class AE(nn.Module):
    """
    Convolutional auto-encoder: ConvEnc -> SingleAE bottleneck -> ConvDec
    (no skips), optionally variational, optionally with a prior head, for
    inputs of `input_shape` (*spatial, C).

    forward(x, prior, training, return_parts, mode, enc_shape, generator,
    noise, return_intermediates): return_parts=True returns (out, mid_out,
    enc_out); mode 'encode' returns the latent z and 'decode' maps z to the
    output (`enc_shape`, which the JAX module needs, must match the
    encoder's output shape when given). `generator` draws the dropout masks
    and the sample noise. `dtype` is the encoder's compute type, as in the
    JAX package (its decoder has none: float32 from the float32 latent);
    `pool_impl` picks the pool ('auto', 'kernel' or 'plain').

    Parity: reference `neurite/tf/models.py:249-375`.
    """

    def __init__(self, input_shape, nb_features, nb_levels, conv_size,
                 nb_labels, enc_size, feat_mult=1, pool_size=2, padding='same',
                 activation='elu', use_residuals=False, nb_conv_per_level=1,
                 batch_norm=None, enc_batch_norm=None, ae_type='conv',
                 enc_lambda_layers=None, add_prior_layer=False, use_logp=True,
                 conv_dropout=0, include_mu_shift_layer=False,
                 final_pred_activation='softmax', do_vae=False, dtype=None,
                 pool_impl='auto', generator=None, device=None):
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        device = backend.resolve_device(device)
        input_shape = tuple(int(s) for s in input_shape)
        ndims = len(input_shape) - 1
        nb_levels = (len(nb_features) if isinstance(nb_features, (list, tuple))
                     else nb_levels)
        self.add_prior_layer = add_prior_layer
        self.enc = ConvEnc(
            input_shape[-1], ndims, nb_features, nb_levels, conv_size,
            feat_mult=feat_mult, pool_size=pool_size, padding=padding,
            activation=activation, use_residuals=use_residuals,
            nb_conv_per_level=nb_conv_per_level, conv_dropout=conv_dropout,
            batch_norm=batch_norm, dtype=dtype, pool_impl=pool_impl,
            generator=generator, device=device)
        self.enc_shape = _enc_out_shape(self.enc, input_shape[:-1])
        self.mid = SingleAE(
            self.enc_shape, enc_size, ae_type=ae_type, conv_size=conv_size,
            enc_lambda_layers=enc_lambda_layers, batch_norm=enc_batch_norm,
            padding=padding, include_mu_shift_layer=include_mu_shift_layer,
            do_vae=do_vae, generator=generator, device=device)
        self.dec = ConvDec(
            self.enc_shape[-1], ndims, nb_features, nb_levels, conv_size,
            nb_labels, feat_mult=feat_mult, pool_size=pool_size,
            use_skip_connections=False, padding=padding,
            activation=activation, use_residuals=use_residuals,
            final_pred_activation=('linear' if add_prior_layer
                                   else final_pred_activation),
            nb_conv_per_level=nb_conv_per_level, batch_norm=batch_norm,
            conv_dropout=conv_dropout, generator=generator, device=device)
        if add_prior_layer:
            self.prior = AddPrior(use_logp=use_logp,
                                  final_pred_activation=final_pred_activation)
        self.to(device)

    def forward(self, x, prior=None, training=None, return_parts=False,
                mode='full', enc_shape=None, generator=None, noise=None,
                return_intermediates=False):
        if mode not in _MODES:
            raise ValueError(f'mode must be one of {_MODES}, got {mode!r}')
        training = self.training if training is None else training
        kw = dict(training=training, generator=generator, noise=noise,
                  return_intermediates=True)
        if mode == 'decode':
            if enc_shape is not None and tuple(enc_shape) != self.enc_shape:
                raise ValueError(f'the encoder gives {self.enc_shape}, not '
                                 f'{tuple(enc_shape)}')
            enc_out = None
            mid_out, inter = self.mid(x, mode='decode', **kw)
        else:
            enc_out, _ = self.enc(x, training=training, generator=generator)
            if mode == 'encode':
                z, inter = self.mid(enc_out, mode='encode', **kw)
                return (z, inter) if return_intermediates else z
            mid_out, inter = self.mid(enc_out, **kw)
        out = self.dec(mid_out, training=training, generator=generator)
        if self.add_prior_layer:
            if prior is None:
                raise ValueError('add_prior_layer requires a prior input')
            out = self.prior(out, prior)
        if return_parts:
            out = (out, mid_out, enc_out)
        return (out, inter) if return_intermediates else out


def ae(nb_features, input_shape, nb_levels, conv_size, nb_labels, enc_size,
       name='ae', prefix=None, feat_mult=1, pool_size=2, padding='same',
       activation='elu', use_residuals=False, nb_conv_per_level=1,
       batch_norm=None, enc_batch_norm=None, ae_type='conv',
       enc_lambda_layers=None, add_prior_layer=False, add_prior_layer_reg=0,
       use_logp=True, conv_dropout=0, include_mu_shift_layer=False,
       single_model=False, final_pred_activation='softmax', src=None,
       src_input=None, do_vae=False, dtype=None, pool_impl='auto',
       generator=None, device=None):
    """Build an AE module (reference `models.py:249-375` knob set) for
    inputs of `input_shape` (*spatial, C), on `device` (the card unless
    'cpu'); `generator` draws the initial parameters."""
    del name, prefix, add_prior_layer_reg, src, src_input
    del single_model    # the module always gives its parts (return_parts)
    return AE(input_shape, nb_features, nb_levels, conv_size, nb_labels,
              enc_size, feat_mult=feat_mult, pool_size=pool_size,
              padding=padding, activation=activation,
              use_residuals=use_residuals,
              nb_conv_per_level=nb_conv_per_level, batch_norm=batch_norm,
              enc_batch_norm=enc_batch_norm, ae_type=ae_type,
              enc_lambda_layers=enc_lambda_layers,
              add_prior_layer=add_prior_layer, use_logp=use_logp,
              conv_dropout=conv_dropout,
              include_mu_shift_layer=include_mu_shift_layer,
              final_pred_activation=final_pred_activation, do_vae=do_vae,
              dtype=dtype, pool_impl=pool_impl, generator=generator,
              device=device)


def single_ae(enc_size, input_shape, name='single_ae', prefix=None,
              ae_type='dense', conv_size=None, input_model=None,
              enc_lambda_layers=None, batch_norm=True, padding='same',
              activation=None, include_mu_shift_layer=False, do_vae=False,
              generator=None, device=None):
    """Build a SingleAE module (reference `models.py:438-646` knob set);
    batch_norm=True, the reference's default, is the last axis."""
    del name, prefix, input_model
    if batch_norm is True:
        batch_norm = -1
    return SingleAE(input_shape, enc_size, ae_type=ae_type,
                    conv_size=conv_size, enc_lambda_layers=enc_lambda_layers,
                    batch_norm=batch_norm, padding=padding,
                    activation=activation,
                    include_mu_shift_layer=include_mu_shift_layer,
                    do_vae=do_vae, generator=generator, device=device)
