"""
On-device label map -> image synthesis (SynthMorph/Brainstorm style);
counterpart of `neurite_tpu/models/synth.py` (reference
`neurite/tf/models.py`, `labels_to_image_new:920-1301`).

`LabelsToImage` runs the reference's stages in its order: affine draw ->
matrix -> origin/centre algebra -> flip/swap -> Perlin SVF -> scaling and
squaring -> x2 rescale -> affine o SVF (closed form) -> one nearest label
warp -> crop -> generation LUT -> per-label means -> Perlin bias -> noise
-> background -> blur -> thick slices -> min-max and gamma -> output
LUT/one-hot. Its warps run K4 (`ops.warp`) and its blurs K6 (`ops.blur`)
on the card.

Randomness: each named component of `_COMPONENTS_NEW` draws from its own
`torch.Generator` on the module's device, seeded on the host from the
caller's generator's `initial_seed()` and the component's index (as
`training.step_generator` derives a step's seed), so nothing syncs;
`seeds={name: int}` pins components (the JAX package's pop-and-assert-empty
semantics). `draw()` returns the random tensors, `perlin()` blurs the
Perlin draws into the velocity and bias fields, and `apply()` runs the rest;
the last two are deterministic, so a test can hand the JAX package's fields
to `apply()`, or one set of draws to `perlin()` and `apply()` on two devices.
"""

import zlib

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch import backend, training
from neurite_tpu_torch.layers.random import (GaussianBlur, GaussianNoise,
                                             Subsample)
from neurite_tpu_torch.utils import augment as aug
from neurite_tpu_torch.utils import core, spatial

_COMPONENTS_NEW = ('shift', 'rot', 'scale', 'shear', 'flip', 'swap', 'warp',
                   'crop', 'mean', 'bias', 'noise', 'background', 'blur',
                   'slice', 'gamma')
_WARP_IMPLS = ('auto', 'window', 'onehot', 'gather')


def _component_generators(base_seed, names, seeds, device):
    """One generator per named component; `seeds` pins components by name
    (a name without a value gets a fixed hash of the name)."""
    if seeds is None:
        seeds = {}
    elif isinstance(seeds, tuple):
        seeds = dict(seeds)
    elif isinstance(seeds, str):
        seeds = {seeds: zlib.crc32(seeds.encode()) % (2 ** 31)}
    elif not isinstance(seeds, dict):
        seeds = {f: zlib.crc32(str(f).encode()) % (2 ** 31) for f in seeds}
    else:
        seeds = dict(seeds)
    gens = {}
    for i, name in enumerate(names):
        if name in seeds:
            gens[name] = torch.Generator(device=device).manual_seed(
                int(seeds.pop(name)))
        else:
            gens[name] = training.step_generator(base_seed, i, device)
    if seeds:
        raise ValueError(f'unknown seeds {seeds}')
    return gens


def _lut_dict(labels):
    """A label list as the identity map; a dict as it is."""
    if isinstance(labels, dict):
        return dict(labels)
    return {int(i): int(i) for i in labels}


class LabelsToImage(nn.Module):
    """
    Synthesis from an integer label map [B, *in_shape, 1]: forward(labels,
    generator) returns a dict with keys among 'image', 'map', 'vel', 'def',
    'aff', 'mean', 'bias' per the return_* flags. Every knob of the JAX
    `LabelsToImage` is here with its default.

    `warp_impl` and `label_warp_impl` accept every JAX value ('auto',
    'window', 'onehot', 'gather'); all of them run the exact warp (K4 on the
    card), so the JAX package's eligibility limits of its TPU engines do not
    apply. `warp_max_disp` keeps its meaning as the clip of the drawn field.
    `device` is where draws and outputs live (the card unless 'cpu').
    """

    def __init__(self, labels_in, labels_out=None, out_shape=None,
                 num_chan=1, aff_shift=0, aff_rotate=0, aff_scale=0,
                 aff_shear=0, aff_normal_shift=False, aff_normal_rotate=False,
                 aff_normal_scale=False, aff_normal_shear=False,
                 axes_flip=False, axes_swap=False, warp_min=0.01, warp_max=2,
                 warp_blur_min=(8, 8), warp_blur_max=(32, 32),
                 warp_zero_mean=False, crop_min=0, crop_max=0.2, crop_prob=0,
                 crop_axes=None, mean_min=None, mean_max=None, noise_min=0.1,
                 noise_max=0.2, zero_background=0, blur_min=0, blur_max=1,
                 bias_min=0.01, bias_max=0.1, bias_blur_min=32,
                 bias_blur_max=64, bias_func=torch.exp, slice_stride_min=1,
                 slice_stride_max=8, slice_prob=0, slice_axes=None,
                 normalize=True, gamma=0.5, one_hot=True, half_res=False,
                 warp_impl='auto', warp_max_disp=None, label_warp_impl='auto',
                 seeds=None, return_im=True, return_map=True,
                 return_vel=False, return_def=False, return_aff=False,
                 return_mean=False, return_bias=False, device=None):
        super().__init__()
        for name, impl in (('warp_impl', warp_impl),
                           ('label_warp_impl', label_warp_impl)):
            if impl not in _WARP_IMPLS:
                raise ValueError(f'{name} must be one of {_WARP_IMPLS}, got '
                                 f'{impl!r}')
        if gamma > 0 and not 0 < gamma < 1:
            raise ValueError(f'gamma value {gamma} outside interval [0, 1)')
        self.labels_in, self.labels_out = labels_in, labels_out
        self.out_shape, self.num_chan = out_shape, num_chan
        self.aff = dict(shift=(aff_shift, aff_normal_shift),
                        rot=(aff_rotate, aff_normal_rotate),
                        scale=(aff_scale, aff_normal_scale),
                        shear=(aff_shear, aff_normal_shear))
        self.axes_flip, self.axes_swap = axes_flip, axes_swap
        self.warp_min, self.warp_max = warp_min, warp_max
        self.warp_blur_min, self.warp_blur_max = warp_blur_min, warp_blur_max
        self.warp_zero_mean, self.warp_max_disp = warp_zero_mean, warp_max_disp
        self.crop_min, self.crop_max = crop_min, crop_max
        self.crop_prob, self.crop_axes = crop_prob, crop_axes
        self.mean_min, self.mean_max = mean_min, mean_max
        self.zero_background = zero_background
        self.bias_min, self.bias_max = bias_min, bias_max
        self.bias_blur_min, self.bias_blur_max = bias_blur_min, bias_blur_max
        self.bias_func = bias_func
        self.normalize, self.gamma = normalize, gamma
        self.one_hot, self.half_res = one_hot, half_res
        self.warp_impl, self.label_warp_impl = warp_impl, label_warp_impl
        self.seeds = seeds
        self.returns = [('image', return_im), ('map', return_map),
                        ('vel', return_vel), ('def', return_def),
                        ('aff', return_aff), ('mean', return_mean),
                        ('bias', return_bias)]
        self.device = backend.resolve_device(device)
        self.noise = GaussianNoise(noise_min=noise_min, noise_max=noise_max)
        self.blur = GaussianBlur(sigma=blur_max, min_sigma=blur_min,
                                 random=True)
        div = 2 if half_res else 1
        self.slice_prob = slice_prob
        self.slice = Subsample(prob=slice_prob,
                               stride_min=max(1, slice_stride_min / div),
                               stride_max=max(1, slice_stride_max / div),
                               axes=slice_axes)

    # --- shapes and label tables ------------------------------------------

    def _shapes(self, labels_shape):
        """(in_shape, out_shape, num_dim, batch) as numpy/int."""
        in_shape = np.asarray(labels_shape[1:-1])
        out_shape = in_shape if self.out_shape is None \
            else np.asarray(self.out_shape)
        out_shape = out_shape // (2 if self.half_res else 1)
        return in_shape, out_shape, len(in_shape), int(labels_shape[0])

    def _labels_gen(self):
        labels_in = _lut_dict(self.labels_in)
        return labels_in, list(dict.fromkeys(labels_in.values()))

    # --- draws -------------------------------------------------------------

    def draw(self, labels_shape, generator):
        """
        Every random tensor of one call, on the module's device: 'aff'
        [B, N+1, N+1], 'flip', 'swap' (when enabled), 'vel_levels' and
        'bias_levels' (per batch item, the raw noise and blur taps of each
        Perlin level, which `perlin` blurs), 'crop' (the crop mask), 'mean'
        [B, num_chan, L], and the draws of the noise, background, blur,
        slice and gamma stages (None where a stage is off).
        """
        if generator is None:
            raise ValueError('LabelsToImage draws from a generator: pass a '
                             'torch.Generator or an int seed')
        base = (int(generator) if isinstance(generator, (int, np.integer))
                else generator.initial_seed())
        dev = self.device
        gens = _component_generators(base, _COMPONENTS_NEW, self.seeds, dev)
        in_shape, out_shape, num_dim, batch = self._shapes(labels_shape)
        n_rot = 1 if num_dim == 2 else 3
        d = {}

        par = []
        for name, n in (('shift', num_dim), ('rot', n_rot),
                        ('scale', num_dim), ('shear', n_rot)):
            bound, use_normal = self.aff[name]
            b = core.device_constant(np.broadcast_to(
                np.asarray(bound, np.float32), (n,)), dev)
            if use_normal:
                v = spatial.truncated_normal(gens[name], (batch, n), dev)
                par.append(v * (b / 2))
            else:
                par.append(core.uniform(gens[name], (batch, n), -1., 1., dev)
                           * b)
        d['aff'] = spatial.params_to_affine_matrix(
            par=torch.cat(par, -1), ndims=num_dim, deg=True,
            shift_scale=True, last_row=True)
        if self.axes_flip:
            d['flip'] = torch.stack([spatial.draw_flip_matrix(
                gens['flip'], out_shape, shift_center=False, device=dev)
                for _ in range(batch)])
        if self.axes_swap:
            d['swap'] = torch.stack([spatial.draw_swap_matrix(
                gens['swap'], num_dim, device=dev) for _ in range(batch)])

        if self.warp_max > 0:
            vel_shape = (*(out_shape // (1 if self.half_res else 2)), num_dim)
            d['vel_levels'] = [aug.draw_perlin_levels(
                vel_shape, noise_min=self.warp_min, noise_max=self.warp_max,
                isotropic=False,
                fwhm_min=np.asarray(self.warp_blur_min) / 2,
                fwhm_max=np.asarray(self.warp_blur_max) / 2,
                batched=False, featured=True, axes=[len(vel_shape) - 1],
                seed=gens['warp'], device=dev) for _ in range(batch)]

        out_sp = tuple(int(s) for s in out_shape)
        if self.crop_prob > 0:
            axes = (list(self.crop_axes) if self.crop_axes is not None
                    else list(range(1, num_dim + 1)))
            d['crop'] = aug.crop_mask(
                (batch, *out_sp, 1), axes, *aug.draw_crop_params(
                    gens['crop'], len(axes), self.crop_min, self.crop_max,
                    self.crop_prob, False, dev), torch.float32, dev)

        _, labels_gen = self._labels_gen()
        num_label = len(labels_gen)
        mean_min = np.asarray([0] * num_label if self.mean_min is None
                              else self.mean_min, np.float32)
        mean_max = np.asarray([1] * num_label if self.mean_max is None
                              else self.mean_max, np.float32)
        lo = core.device_constant(mean_min, dev)
        d['mean'] = lo + torch.rand(
            (batch, self.num_chan, num_label), generator=gens['mean'],
            device=dev) * (core.device_constant(mean_max, dev) - lo)

        image_shape = (batch, *out_sp, self.num_chan)
        if self.bias_max > 0:
            div = 2 if self.half_res else 1
            d['bias_levels'] = [aug.draw_perlin_levels(
                image_shape[1:], noise_min=self.bias_min,
                noise_max=self.bias_max, isotropic=False,
                fwhm_min=self.bias_blur_min / div,
                fwhm_max=self.bias_blur_max / div, batched=False,
                featured=True, seed=gens['bias'], device=dev)
                for _ in range(batch)]
        d['noise'] = self.noise.draw(image_shape, gens['noise'], dev)
        if self.zero_background > 0:
            d['background'] = torch.rand((batch, *[1] * num_dim, 1),
                                         generator=gens['background'],
                                         device=dev)
        d['blur'] = self.blur.draw(image_shape, gens['blur'], dev)
        if self.slice_prob > 0:
            d['slice'] = self.slice.draw(image_shape, gens['slice'], dev)
        if self.gamma > 0:
            d['gamma'] = core.uniform(
                gens['gamma'], (batch, *[1] * num_dim, self.num_chan),
                1 - self.gamma, 1 + self.gamma, dev)
        return d

    # --- the deterministic pipeline ------------------------------------------

    def perlin(self, draws):
        """`draws` with the Perlin fields made from their levels (the blurs
        of the path: K6 on the card): 'vel' [B, *vel_shape, N] (before
        zero-mean and clip) and 'bias' (bias_func of the field,
        [B, *out_shape, num_chan])."""
        d = {k: v for k, v in draws.items() if not k.endswith('_levels')}
        if 'vel_levels' in draws:
            d['vel'] = torch.stack([aug.perlin_from_levels(
                lv, reduce=torch.max, featured=True)
                for lv in draws['vel_levels']])
        if 'bias_levels' in draws:
            d['bias'] = self.bias_func(torch.stack([aug.perlin_from_levels(
                lv, reduce=torch.max, featured=True)
                for lv in draws['bias_levels']]))
        return d

    def apply(self, labels, draws):
        """The synthesis of integer labels [B, *in_shape, 1] given `draws`
        with their Perlin fields (as `perlin(draw(...))` returns them)."""
        in_shape, out_shape, num_dim, batch = self._shapes(labels.shape)
        dev = labels.device
        out_sp = tuple(int(s) for s in out_shape)
        outputs = {}

        # affine: origin/centre/half-res algebra (ref :1107-1117)
        affine = draws['aff']
        outputs['aff'] = affine
        origin = np.eye(num_dim + 1)
        origin[:num_dim, -1] = -0.5 * (in_shape - 1)
        center = np.eye(num_dim + 1)
        center[:num_dim, -1] = np.round(
            0.5 * (in_shape - (2 if self.half_res else 1) * out_shape))
        scale = np.diag((*[2 if self.half_res else 1] * num_dim, 1))
        post = core.device_constant((origin @ center @ scale).astype(
            np.float32), dev)
        pre = core.device_constant(np.linalg.inv(origin).astype(np.float32),
                                   dev)
        trans = pre @ affine @ post
        if self.axes_flip:
            trans = trans @ draws['flip']
        if self.axes_swap:
            if not all(x == out_shape[0] for x in out_shape):
                raise ValueError('axes_swap needs an isotropic output shape')
            trans = trans @ draws['swap']

        # diffeomorphic deformation
        vel_field = def_field = None
        if self.warp_max > 0:
            vel_field = draws['vel']
            if self.warp_zero_mean:
                vel_field = vel_field - vel_field.mean(
                    dim=tuple(range(1, num_dim + 1)), keepdim=True)
            wdisp = (self.warp_max_disp if self.warp_max_disp is not None
                     else 4. * float(self.warp_max))
            vel_field = vel_field.clamp(-wdisp, wdisp)
            def_field = spatial.batch_integrate_vec(vel_field, nb_steps=5)
            if not self.half_res:
                def_field = torch.stack([spatial.rescale_dense_transform(
                    f, 2) for f in def_field])
                full = (2. * self.warp_max_disp
                        if self.warp_max_disp is not None
                        else 4. * float(self.warp_max))
                def_field = def_field.clamp(-full, full)
            trans_dense = spatial.compose_affine_dense(trans, def_field,
                                                       out_sp)
        else:
            trans_dense = torch.stack([spatial.affine_to_dense_shift(
                m[:num_dim], out_sp, shift_center=False) for m in trans])
        outputs['vel'], outputs['def'] = vel_field, def_field

        # one nearest label warp
        labels = spatial.batch_transform(
            labels.to(torch.float32), trans_dense, interp_method='nearest',
            fill_value=0).to(torch.int32)
        if self.crop_prob > 0:
            labels = (labels.to(torch.float32) * draws['crop']).to(
                torch.int32)

        # generation labels and intensity means
        labels_in, labels_gen = self._labels_gen()
        ind = {gen: i for i, gen in enumerate(labels_gen)}
        lut = core.device_constant(np.asarray(
            [ind.get(labels_in.get(i), 0) for i in range(max(labels_in) + 1)],
            np.int64), dev)
        indices = lut[labels.long().clamp(0, lut.numel() - 1)]
        mean = draws['mean']
        outputs['mean'] = mean
        num_label = len(labels_gen)
        off_chan = torch.arange(self.num_chan, device=dev) * num_label
        off_batch = (torch.arange(batch, device=dev) * self.num_chan
                     * num_label).reshape(-1, *[1] * num_dim, 1)
        flat = mean.reshape(-1)
        image = flat[(indices + off_batch + off_chan).clamp(
            0, flat.numel() - 1)]

        # bias, noise, background, blur, thick slices
        bias_field = None
        if self.bias_max > 0:
            bias_field = draws['bias']
            image = image * bias_field
        outputs['bias'] = bias_field
        image = self.noise.apply(image, draws['noise'])
        if self.zero_background > 0:
            bg_zero = (labels == 0) & (draws['background']
                                       < self.zero_background)
            image = image * (~bg_zero).to(image.dtype)
        image = self.blur.apply(image, draws['blur'])
        if self.slice_prob > 0:
            image = self.slice.apply(image, draws['slice'])

        # intensity
        if self.normalize:
            image = core.minmax_norm(image, axis=tuple(range(1, image.ndim)))
        if self.gamma > 0:
            image = torch.pow(image, draws['gamma'])
        outputs['image'] = image

        # output labels
        out_lut_src = _lut_dict(list(labels_in) if self.labels_out is None
                                else self.labels_out)
        labels_out_set = list(dict.fromkeys(out_lut_src.values()))
        lut_map = dict(out_lut_src)
        if self.one_hot:
            ind_out = {out: i for i, out in enumerate(labels_out_set)}
            lut_map = {inp: ind_out[out] for inp, out in lut_map.items()}
        if any(k != lut_map[k] for k in lut_map) or \
                set(labels_in) - set(lut_map):
            lut_arr = core.device_constant(np.asarray(
                [lut_map.get(i, -1 if self.one_hot else 0)
                 for i in range(max(labels_in) + 1)], np.int32), dev)
            labels = lut_arr[labels.long().clamp(0, lut_arr.numel() - 1)]
        if self.one_hot:
            classes = torch.arange(len(labels_out_set), device=dev,
                                   dtype=labels.dtype)
            labels = (labels[..., 0, None] == classes).to(torch.float32)
        outputs['map'] = labels

        return {k: outputs[k] for k, w in self.returns if w}

    def forward(self, labels, generator=None):
        return self.apply(labels, self.perlin(self.draw(labels.shape,
                                                        generator)))


def labels_to_image_new(labels_in, labels_out=None, in_shape=None,
                        out_shape=None, input_model=None, device=None,
                        **kwargs):
    """Build a LabelsToImage module (ref `models.py:920-1301` knob set) on
    `device` (the card unless 'cpu')."""
    del in_shape, input_model
    kwargs.pop('id', None)
    for k in ('mean_min', 'mean_max', 'warp_blur_min', 'warp_blur_max',
              'blur_min', 'blur_max', 'slice_axes', 'crop_axes'):
        if k in kwargs and isinstance(kwargs[k], (list, np.ndarray)):
            kwargs[k] = tuple(np.ravel(kwargs[k]).tolist())
    if isinstance(labels_in, (list, range, np.ndarray)):
        labels_in = tuple(int(v) for v in labels_in)
    if isinstance(labels_out, (list, range, np.ndarray)):
        labels_out = tuple(int(v) for v in labels_out)
    if out_shape is not None:
        out_shape = tuple(int(v) for v in out_shape)
    return LabelsToImage(labels_in=labels_in, labels_out=labels_out,
                         out_shape=out_shape, device=device, **kwargs)
