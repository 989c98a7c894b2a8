"""
Randomized augmentation layers; counterpart of `neurite_tpu/layers/random.py`
(reference `neurite/tf/layers.py`).

Each layer splits its randomness in two: `draw(shape, generator, device)`
returns the random tensors (on `device`, from a `torch.Generator` there),
and `apply(x, draws)` is deterministic. `forward(x, generator)` is
`apply(x, draw(x.shape, generator, x.device))`. The tests hand the JAX
package's draws to `apply`, since JAX keys and torch generators draw
different numbers.
"""

import warnings

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch.py.utils import normalize_axes
from neurite_tpu_torch.utils import augment as aug
from neurite_tpu_torch.utils import core

__all__ = ['GaussianBlur', 'GaussianNoise', 'Subsample', 'RandomCrop',
           'RandomClip', 'SampleNormalLogVar', 'PerlinNoise']


def _need(generator):
    if generator is None:
        raise ValueError('a random layer needs a torch.Generator')
    return generator


class GaussianBlur(nn.Module):
    """
    Blur with a (possibly random, possibly anisotropic) Gaussian kernel; a
    random sigma is uniform in [min_sigma, sigma) per axis and the window is
    sized from `sigma`. `level` works as documented: sigma = (level - 1)**2.

    Parity: reference `layers.py:251-364`.
    """

    def __init__(self, sigma=None, level=None, random=False, min_sigma=0,
                 isotropic=False):
        super().__init__()
        if sigma is None and level is None:
            raise ValueError('sigma or level must be provided')
        if sigma is not None and level is not None:
            raise ValueError('only sigma or level must be provided')
        if level is not None:
            warnings.warn('`level` is deprecated; use `sigma` instead.')
            if level < 1:
                raise ValueError('Gaussian blur level must not be less than 1')
            if random:
                raise ValueError('level argument incompatible with random '
                                 'blurring')
            sigma = (level - 1) ** 2
        if isotropic and not random:
            raise ValueError('For non-random blurring, isotropy is implicitly '
                             'controlled by the number of sigmas provided. '
                             'Set `isotropic` only for random blur.')
        self.sigma, self.min_sigma = sigma, min_sigma
        self.random, self.isotropic = random, isotropic

    def _sigmas(self, ndims):
        """(sigma, min_sigma) as per-axis lists (one entry if isotropic)."""
        out = []
        for s in (self.sigma, self.min_sigma):
            s = [float(v) for v in np.ravel(s)]
            if len(s) not in (1, ndims):
                raise ValueError(f'1 or {ndims} sigmas expected in {ndims}D '
                                 f'space, got {len(s)}')
            if any(v < 0 for v in s):
                raise ValueError('Gaussian blur sigma must not be less than 0')
            if len(s) > 1 and self.isotropic:
                raise ValueError(f'random isotropic blur requires a single '
                                 f'sigma, got {len(s)}')
            out.append(s * ndims if len(s) == 1 else s)
        if self.isotropic:
            out = [s[:1] for s in out]
        return out

    def draw(self, shape, generator, device):
        """The random sigma of each axis (0-d tensors), or None."""
        sigma, min_sigma = self._sigmas(len(shape) - 2)
        if not self.random or not any(s > 0 for s in sigma):
            return None
        _need(generator)
        eps = float(torch.finfo(torch.float32).eps)
        return [core.uniform(generator, (), max(lo, eps), max(hi, eps),
                             device) for lo, hi in zip(min_sigma, sigma)]

    def apply(self, x, draws):
        ndims = x.ndim - 2
        sigma, _ = self._sigmas(ndims)
        if not any(s > 0 for s in sigma):
            return x
        eps = float(torch.finfo(x.dtype).eps)
        width = [int(np.round(max(s, eps) * 3) * 2 + 1) for s in sigma]
        kernel = core.gaussian_kernel(
            sigma=draws if self.random else sigma,
            windowsize=width, separate=True, dtype=x.dtype, device=x.device)
        if not isinstance(kernel, list):
            kernel = [kernel]
        if self.isotropic:
            kernel = kernel * ndims
        return core.separable_conv(x, kernel, batched=True)

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x.shape, generator, x.device))


class GaussianNoise(nn.Module):
    """
    Additive Gaussian noise with an SD uniform in [noise_min, noise_max),
    relative to max|x| unless `absolute`, drawn separately along `axes`.

    Parity: reference `layers.py:2305-2403`.
    """

    def __init__(self, noise_min=0.01, noise_max=0.10, noise_only=False,
                 absolute=False, axes=(0, -1)):
        super().__init__()
        self.noise_min, self.noise_max = noise_min, noise_max
        self.noise_only, self.absolute = noise_only, absolute
        self.axes = axes

    def _off(self):
        return self.noise_max == 0 and not self.noise_only

    def draw(self, shape, generator, device, dtype=torch.float32):
        """(unit SD of shape_sd, standard normal of `shape`; a second
        normal for the imaginary part of a complex dtype), or None."""
        if self._off():
            return None
        _need(generator)
        nd = len(shape)
        axes = [ax + nd if ax < 0 else ax for ax in np.ravel(self.axes)]
        if not all(0 <= ax < nd for ax in axes):
            raise ValueError(f'invalid axes {self.axes}')
        real = torch.float32 if dtype.is_complex else dtype
        shape_sd = tuple(shape[i] if i in axes else 1 for i in range(nd))
        sd = core.uniform(generator, shape_sd, float(self.noise_min),
                          float(self.noise_max), device, real)
        n = [torch.randn(tuple(shape), generator=generator, device=device,
                         dtype=real) for _ in range(2 if dtype.is_complex
                                                    else 1)]
        return (sd, *n)

    def apply(self, x, draws):
        if self._off():
            return x
        sd, *n = draws
        if not self.absolute:
            sd = sd * torch.max(torch.abs(x))
        noise = (torch.complex(sd * n[0], sd * n[1]) if x.is_complex()
                 else sd * n[0])
        return noise if self.noise_only else x + noise

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x.shape, generator, x.device, x.dtype))


class Subsample(nn.Module):
    """
    Random thick slices along a random spatial axis, resampled back to the
    input shape (static shape: one composed gather per candidate axis).

    Parity: reference `layers.py:367-443`.
    """

    def __init__(self, stride_min=1, stride_max=8, axes=None, prob=1,
                 upsample=True):
        super().__init__()
        self.stride_min, self.stride_max = stride_min, stride_max
        self.axes, self.prob, self.upsample = axes, prob, upsample

    def _axes(self, shape):
        ndims = len(shape) - 2
        if ndims not in (1, 2, 3):
            raise ValueError('only 1D, 2D, or 3D supported')
        return list(normalize_axes(self.axes, shape,
                                   allowed=range(1, ndims + 1),
                                   none_means_all=True))

    def draw(self, shape, generator, device):
        """(axis index among the candidates, thickness), or None."""
        axes = self._axes(shape)
        if self.prob == 0 or self.stride_max == 1:
            return None
        if not 0 < self.stride_min <= self.stride_max:
            raise ValueError('invalid strides')
        return core.draw_subsample(_need(generator), len(axes),
                                   self.stride_min, self.stride_max,
                                   self.prob, device)

    def apply(self, x, draws):
        axes = self._axes(x.shape)
        if draws is None:
            return x
        if not self.upsample:
            raise NotImplementedError(
                'Subsample(upsample=False) changes the shape with the draw; '
                'use core.subsample_axis')
        return core.apply_subsample(x, *draws, axes)

    def forward(self, x, generator=None):
        if not self.upsample and self.prob != 0 and self.stride_max != 1:
            return core.subsample_axis(
                x, stride_min=self.stride_min, stride_max=self.stride_max,
                axes=self._axes(x.shape), prob=self.prob, upsample=False,
                seed=_need(generator))
        return self.apply(x, self.draw(x.shape, generator, x.device))


class RandomCrop(nn.Module):
    """
    Random multiplicative field-of-view crop along a random spatial axis.

    Parity: reference `layers.py:446-519`.
    """

    def __init__(self, crop_min=0, crop_max=0.5, axis=None, prob=1,
                 bilateral=False):
        super().__init__()
        self.crop_min, self.crop_max = crop_min, crop_max
        self.axis, self.prob, self.bilateral = axis, prob, bilateral

    def _axis(self, shape):
        return list(normalize_axes(self.axis, shape,
                                   allowed=range(1, len(shape) - 1),
                                   none_means_all=True))

    def draw(self, shape, generator, device):
        """(low cut, kept proportion, axis index), or None."""
        axis = self._axis(shape)
        if self.prob == 0:
            return None
        return aug.draw_crop_params(_need(generator), len(axis),
                                    self.crop_min, self.crop_max, self.prob,
                                    self.bilateral, device)

    def apply(self, x, draws):
        axis = self._axis(x.shape)
        if draws is None:
            return x
        return x * aug.crop_mask(x.shape, axis, *draws, x.dtype, x.device)

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x.shape, generator, x.device))


class RandomClip(nn.Module):
    """
    Random lower and upper clipping. Each side's threshold is `clip_min`
    (`clip_max`) where that is a number, or uniform in its (lo, hi) pair,
    drawn separately along `axes`; with probability 1 - `prob_min`
    (`prob_max`), drawn along the same axes, a side keeps the minimum
    (maximum) of x and so clips nothing.

    Parity: reference `layers.py:522-628`.
    """

    def __init__(self, clip_min=None, clip_max=None, prob_min=1, prob_max=1,
                 axes=0):
        super().__init__()
        for prob in (prob_min, prob_max):
            if not 0 <= prob <= 1:
                raise ValueError(f'{prob} is not a probability')
        self.sides = (('low', clip_min, prob_min), ('upp', clip_max,
                                                    prob_max))
        self.axes = axes

    def _off(self):
        return all(prob == 0 for _, _, prob in self.sides)

    def draw(self, shape, generator, device):
        """{'low' | 'upp': (threshold uniform or None, gate uniform or
        None)}, each of x's shape but 1 off `axes` (a side whose bounds are
        None or whose prob is 0 draws neither), or None."""
        if self._off():
            return None
        axes = normalize_axes(self.axes, shape, none_means_all=False)
        shape = tuple(shape[i] if i in axes else 1 for i in range(len(shape)))
        out = {}
        for side, bounds, prob in self.sides:
            if bounds is None or prob == 0:
                out[side] = (None, None)
                continue
            _need(generator)
            val = (None if np.isscalar(bounds) else core.uniform(
                generator, shape, float(bounds[0]), float(bounds[1]), device))
            gate = (torch.rand(shape, generator=generator, device=device)
                    if prob < 1 else None)
            out[side] = (val, gate)
        return out

    def apply(self, x, draws):
        if self._off():
            return x
        axes = normalize_axes(self.axes, x.shape, none_means_all=False)
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.ndim))
        thresh = {}
        for (side, bounds, prob), no_clip in zip(self.sides,
                                                 (x.min(), x.max())):
            val, gate = draws[side]
            if bounds is None or prob == 0:
                thresh[side] = no_clip
                continue
            at = (torch.full(shape, float(bounds), dtype=x.dtype,
                             device=x.device) if val is None
                  else val.to(x.dtype))
            if gate is not None:
                bit = (gate < prob).to(x.dtype)
                at = bit * at + (1 - bit) * no_clip
            thresh[side] = at
        return torch.minimum(torch.maximum(x, thresh['low']), thresh['upp'])

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x.shape, generator, x.device))


class SampleNormalLogVar(nn.Module):
    """
    Reparameterization sampler: z = mu + exp(log_var / 2) * N(0, 1) for
    x = [mu, log_var]. The noise is float32 whatever mu's dtype, so a
    bfloat16 mu gives a float32 z, as in the JAX package.

    Parity: reference `layers.py:2261-2302`.
    """

    def draw(self, shape, generator, device):
        """The standard normal noise, float32 of mu's shape."""
        return torch.randn(tuple(shape), generator=_need(generator),
                           device=device, dtype=torch.float32)

    def apply(self, x, noise):
        mu, log_var = x
        return mu + torch.exp(log_var / 2.0) * noise

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x[0].shape, generator, x[0].device))


class PerlinNoise(nn.Module):
    """
    Perlin noise (`augment.draw_perlin_full`) for each batch item of x, of
    x's shape without the batch axis unless `shape` is given.

    Parity: reference `layers.py:2406-2508`.
    """

    def __init__(self, shape=None, noise_min=0.01, noise_max=1, fwhm_min=4,
                 fwhm_max=32, isotropic=False, reduce=aug.std,
                 out_type=torch.float32, axes=None):
        super().__init__()
        self.shape, self.noise_min, self.noise_max = shape, noise_min, \
            noise_max
        self.fwhm_min, self.fwhm_max = fwhm_min, fwhm_max
        self.isotropic, self.reduce = isotropic, reduce
        self.out_type, self.axes = out_type, axes

    def forward(self, x, generator=None):
        in_shape = tuple(x.shape)
        axes = normalize_axes(self.axes, in_shape, range(1, len(in_shape)),
                              none_means_all=False)
        shape = in_shape[1:] if self.shape is None else tuple(self.shape)
        gen = _need(generator)
        return torch.stack([aug.draw_perlin_full(
            shape, noise_min=self.noise_min, noise_max=self.noise_max,
            isotropic=self.isotropic, fwhm_min=self.fwhm_min,
            fwhm_max=self.fwhm_max, batched=False, featured=True,
            dtype=self.out_type, seed=gen, axes=[ax - 1 for ax in axes],
            reduce=self.reduce, device=x.device) for _ in range(in_shape[0])])
