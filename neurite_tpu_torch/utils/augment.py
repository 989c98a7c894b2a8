"""
Randomized augmentation ops; counterpart of `neurite_tpu/utils/augment.py`
(reference `neurite/tf/utils/augment.py`).

`seed` is a `torch.Generator` on the device the result goes to (or an int).
Every draw stays on the device: random blur widths are static (sized from
the largest sigma) and the taps are computed from the drawn sigma there, so
nothing waits for the host.
"""

import numpy as np
import torch

from neurite_tpu_torch import backend
from neurite_tpu_torch.py.utils import normalize_axes
from neurite_tpu_torch.utils import core

__all__ = ['draw_perlin', 'random_blur_rescale', 'draw_perlin_full',
           'draw_crop_mask', 'blur_rescale', 'draw_perlin_levels',
           'perlin_from_levels', 'draw_perlin_scales', 'perlin_from_scales',
           'std']


def std(x):
    """Population standard deviation of all of x (jnp.std, ddof 0): the
    default `reduce` of the Perlin draws."""
    return torch.std(x, correction=0)


def draw_perlin(out_shape, scales, min_std=0, max_std=1, dtype=torch.float32,
                seed=None, device=None):
    """
    Perlin-style noise: normal noise drawn at each `scale` (relative
    resolution), upsampled to `out_shape` (N spatial sizes and a trailing
    feature count) and summed; each scale's SD is uniform in [min_std,
    max_std). `draw_perlin_scales` and `perlin_from_scales` are its draw
    and its apply.

    Parity: reference `neurite/tf/utils/augment.py:7-62`.
    """
    draws = draw_perlin_scales(out_shape, scales, min_std, max_std, dtype,
                               seed, device)
    return perlin_from_scales(out_shape, draws)


def draw_perlin_scales(out_shape, scales, min_std=0, max_std=1,
                       dtype=torch.float32, seed=None, device=None):
    """The draws of `draw_perlin`: per scale, its SD (0-d) and its standard
    normal field of ceil(spatial / scale) voxels and the trailing feature
    count, as a list of (sd, noise)."""
    device = backend.resolve_device(device)
    out_shape = [int(s) for s in out_shape]
    if np.isscalar(scales):
        scales = [scales]
    gen = core.as_generator(seed, device)
    draws = []
    for scale in scales:
        sample = [int(s) for s in np.ceil(np.asarray(out_shape[:-1]) / scale)]
        sd = core.uniform(gen, (), float(min_std), float(max_std), device,
                          dtype)
        draws.append((sd, torch.randn((*sample, out_shape[-1]), generator=gen,
                                      device=device, dtype=dtype)))
    return draws


def perlin_from_scales(out_shape, draws):
    """The apply of `draw_perlin`: each scale's sd * noise, resized to
    `out_shape` where its shape differs, summed."""
    out_shape = [int(s) for s in out_shape]
    out = 0
    for sd, noise in draws:
        gauss = sd * noise
        if list(gauss.shape) != out_shape:
            gauss = core.resize(gauss, [o / s for o, s in
                                        zip(out_shape[:-1], gauss.shape)],
                                new_shape=out_shape[:-1])
        out = out + gauss
    if not torch.is_tensor(out):
        raise ValueError('draw_perlin needs at least one scale')
    return out


def draw_blur_kernels(n_dim, std_min, std_max, isotropic, seed, device,
                      dtype=torch.float32):
    """The draw of `random_blur_rescale`: one Gaussian tap vector per
    spatial axis, sigma uniform in [std_min, std_max), window sized from
    std_max (all axes share the first one when isotropic)."""
    kernels = [core.gaussian_kernel(sigma=std_max, separate=True, random=True,
                                    min_sigma=std_min, dtype=dtype, seed=seed,
                                    device=device) for _ in range(n_dim)]
    return kernels[:1] * n_dim if isotropic else kernels


def blur_rescale(x, kernels, reduce=std, batched=False):
    """The apply of `random_blur_rescale`: blur the spatial axes of x
    separably with `kernels`, then rescale so that `reduce(x)` is kept."""
    before = reduce(x)
    x = core.separable_conv(x, kernels, batched=batched)
    after = reduce(x)
    zero = after == 0
    scale = torch.where(zero, torch.zeros_like(after),
                        before / torch.where(zero, torch.ones_like(after),
                                             after))
    return x * scale


def random_blur_rescale(x, std_min=8 / 2.355, std_max=32 / 2.355,
                        isotropic=False, seed=None, reduce=std,
                        batched=False):
    """
    Random separable Gaussian blur of the spatial axes of x, rescaled so
    that a global statistic (`reduce`, default the SD) is preserved.

    Parity: reference `neurite/tf/utils/augment.py:65-112`.
    """
    n_dim = x.ndim - 1 - int(batched)
    gen = core.as_generator(seed, x.device)
    kernels = draw_blur_kernels(n_dim, std_min, std_max, isotropic, gen,
                                x.device, x.dtype)
    return blur_rescale(x, kernels, reduce=reduce, batched=batched)


def draw_perlin_full(shape, noise_min=0.01, noise_max=1, fwhm_min=4,
                     fwhm_max=32, isotropic=False, batched=False,
                     featured=False, reduce=std, dtype=torch.float32,
                     axes=None, seed=None, device=None):
    """
    Perlin noise without interpolation: at each level draw full-size normal
    noise with a random SD (a separate SD along `axes`), blur it with a
    random-FWHM Gaussian that keeps `reduce`, and average the levels.

    Parity: reference `neurite/tf/utils/augment.py:115-218`.
    """
    levels = draw_perlin_levels(shape, noise_min, noise_max, fwhm_min,
                                fwhm_max, isotropic, batched, featured, dtype,
                                axes, seed, device)
    return perlin_from_levels(levels, reduce, batched, featured)


def draw_perlin_levels(shape, noise_min=0.01, noise_max=1, fwhm_min=4,
                       fwhm_max=32, isotropic=False, batched=False,
                       featured=False, dtype=torch.float32, axes=None,
                       seed=None, device=None):
    """The draws of `draw_perlin_full`: per level, the normal noise scaled
    by its random SD (with a batch and a feature axis, [B, *spatial, F])
    and its blur taps, as a list of (noise, kernels)."""
    if not 0 < noise_min <= noise_max:
        raise ValueError(f'invalid noise-SD bounds {(noise_min, noise_max)}')
    device = backend.resolve_device(device)
    gen = core.as_generator(seed, device)
    axes = normalize_axes(axes, shape, none_means_all=False)
    shape = [int(s) for s in shape]
    if not batched:
        shape = [1] + shape
        axes = [ax + 1 for ax in axes]
    if not featured:
        shape = shape + [1]
    shape_sd = tuple(shape[i] if i in axes else 1 for i in range(len(shape)))
    if not hasattr(fwhm_min, '__iter__'):
        fwhm_min = [fwhm_min]
    if not hasattr(fwhm_max, '__iter__'):
        fwhm_max = [fwhm_max]
    if len(fwhm_min) != len(fwhm_max):
        raise ValueError('different number of lower and upper bounds')

    levels = []
    for low, upp in zip(fwhm_min, fwhm_max):
        noise_sd = core.uniform(gen, shape_sd, float(noise_min),
                                float(noise_max), device, dtype)
        noise = noise_sd * torch.randn(shape, generator=gen, device=device,
                                       dtype=dtype)
        levels.append((noise, draw_blur_kernels(
            len(shape) - 2, low / 2.355, upp / 2.355, isotropic, gen, device,
            dtype)))
    return levels


def perlin_from_levels(levels, reduce=std, batched=False, featured=False):
    """The apply of `draw_perlin_full`: blur each level's noise with its
    taps keeping `reduce`, average the levels, and drop the batch and
    feature axes that `draw_perlin_levels` added."""
    out = torch.mean(torch.stack([blur_rescale(noise, kernels, reduce=reduce,
                                               batched=True)
                                  for noise, kernels in levels]), dim=0)
    if not batched:
        out = out[0]
    if not featured:
        out = out[..., 0]
    return out


def draw_crop_params(generator, n_axes, crop_min, crop_max, prob, bilateral,
                     device):
    """The draws of `draw_crop_mask`: the low cut and the kept proportion,
    and the index of the cropped axis among the candidates (0-d tensors)."""
    if not 0 <= crop_min <= crop_max <= 1:
        raise ValueError(f'invalid proportions {crop_min}, {crop_max}')
    if not 0 <= prob <= 1:
        raise ValueError(f'{prob} not a probability')
    prop_cut = torch.full((), float(crop_max), device=device)
    if crop_min < crop_max:
        prop_cut = core.uniform(generator, (), float(crop_min),
                                float(crop_max), device)
    if prob < 1:
        gate = torch.rand((), generator=generator, device=device) < prob
        prop_cut = prop_cut * gate.to(prop_cut.dtype)
    rand_prop = torch.rand((), generator=generator, device=device)
    if not bilateral:
        rand_prop = (rand_prop < 0.5).to(prop_cut.dtype)
    ind = torch.randint(0, n_axes, (), generator=generator, device=device)
    return prop_cut * rand_prop, 1 - prop_cut, ind


def crop_mask(shape, axis, prop_low, prop_cen, ind, dtype, device):
    """The apply of `draw_crop_mask`: along axis[ind], keep the positions p
    with prop_low <= p / width < prop_low + prop_cen; a mask broadcastable
    to `shape` (every other axis all ones)."""
    mask = torch.ones((), dtype=dtype, device=device)
    for i, ax in enumerate(axis):
        width = shape[ax]
        prop = torch.arange(width, dtype=torch.float32, device=device) / width
        m = (prop >= prop_low) & (prop < prop_low + prop_cen)
        m = torch.where(ind == i, m.to(dtype), torch.ones((), dtype=dtype,
                                                           device=device))
        bshape = [1] * len(shape)
        bshape[ax] = width
        mask = mask * m.reshape(bshape)
    return mask


def draw_crop_mask(x, crop_min=0, crop_max=0.5, axis=None, prob=1,
                   bilateral=False, seed=None):
    """
    A binary field-of-view crop mask along one randomly drawn axis: a
    proportion in [crop_min, crop_max) of the axis is zeroed, from one end
    (or split between both ends when `bilateral`), gated by `prob`. Like the
    JAX package, the mask spans all candidate axes, the others all ones, so
    its shape does not depend on the draw.

    Parity: reference `neurite/tf/utils/augment.py:221-287`.
    """
    axis = normalize_axes(axis, x.shape, none_means_all=True)
    gen = core.as_generator(seed, x.device)
    prop_low, prop_cen, ind = draw_crop_params(
        gen, len(axis), crop_min, crop_max, prob, bilateral, x.device)
    return crop_mask(x.shape, axis, prop_low, prop_cen, ind, x.dtype,
                     x.device)
