"""
On-device label map -> image synthesis (SynthMorph/Brainstorm style) and the
SynthStrip model; counterpart of `neurite_tpu/models/synth.py` (reference
`neurite/tf/models.py`, `labels_to_image:649-917`,
`labels_to_image_new:920-1301`, `SynthStrip:1888-1965`).

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
`LabelsToImageV1`, the legacy generator that `SynthStripModule` runs, has
the same three stages over `_COMPONENTS_V1`.
"""

import zlib

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch import backend, trace, training
from neurite_tpu_torch.layers.random import (GaussianBlur, GaussianNoise,
                                             Subsample)
from neurite_tpu_torch.models.unet import UNet
from neurite_tpu_torch.parallel import spatial as sharding
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

    Under spatial sharding (`parallel.spatial`) `forward` and `apply` take
    this rank's block of the labels: it is gathered, the synthesis runs on
    the whole volume with the given (or equal) draws on every rank, and
    each volume output is the rank's block (the gather rule).
    """

    spatial_rule = 'gather'

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

    @sharding.gathers
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

    @sharding.gathers
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


###############################################################################
# the legacy (v1) generator and SynthStrip
###############################################################################

_COMPONENTS_V1 = ('warp', 'mean', 'std', 'noise', 'background', 'blur',
                  'bias', 'gamma', 'dc_offset')
_IMPLS = ('auto', 'plain')


def _batch_warp(vol, field, interp_method, fill_value, impl):
    """`spatial.batch_transform` of vol by the dense shift `field`; with
    impl='plain' the plain gather chain (K4's plain version) on any
    device."""
    if impl == 'auto':
        return spatial.batch_transform(vol, field, interp_method=interp_method,
                                       fill_value=fill_value)
    loc = core.grid_points(field.shape[1:-1], field.device,
                           field.dtype) + field
    return core.interpn_plain(vol, loc, interp_method, fill_value,
                              batched=True)


class LabelsToImageV1(nn.Module):
    """
    Legacy Brainstorm-style synthesis, the generator of SynthStrip: a Perlin
    velocity field at half resolution, integrated (5 squarings), doubled
    and resized x2, warps the integer label map [B, *in_shape, 1] (nearest,
    fill 0); each label draws a mean and an SD per channel, the image is
    their normal noise, then zero background, a random Gaussian blur, a
    Perlin bias field (exp), a clip to [0, 255], min-max, a log-normal gamma
    and a DC offset; the labels go through the output LUT (one-hot or not).
    forward(labels, generator) returns {'image', 'map'} and 'vel' and 'def'
    per the return_* flags.

    On the card the integration and the warp run K4 and the blur K6;
    impl='plain' runs their plain versions on any device instead (the check
    of the kernels). The split is that of `LabelsToImage`: `draw()` makes
    every random tensor (from one generator per `_COMPONENTS_V1` name;
    `seeds` pins components), `perlin()` sums the Perlin draws into the
    velocity and bias fields, and `apply()` is the rest, deterministic.

    Parity: reference `neurite/tf/models.py:649-917`.
    """

    def __init__(self, in_label_list, out_label_list=None, out_shape=None,
                 num_chan=1, mean_min=None, mean_max=None, std_min=None,
                 std_max=None, zero_background=0.2, warp_res=(16,),
                 warp_std=0.5, warp_modulate=True, bias_res=40, bias_std=0.3,
                 bias_modulate=True, blur_std=1, blur_modulate=True,
                 normalize=True, gamma_std=0.25, dc_offset=0, one_hot=True,
                 seeds=None, return_vel=False, return_def=False, impl='auto',
                 device=None):
        super().__init__()
        if impl not in _IMPLS:
            raise ValueError(f'impl must be one of {_IMPLS}, got {impl!r}')
        self.in_label_list = np.int32(np.unique(np.asarray(in_label_list)))
        self.out_label_list = out_label_list
        self.out_shape, self.num_chan = out_shape, num_chan
        self.mean_min, self.mean_max = mean_min, mean_max
        self.std_min, self.std_max = std_min, std_max
        self.zero_background = zero_background
        self.warp_res, self.warp_std = warp_res, warp_std
        self.warp_modulate = warp_modulate
        self.bias_res, self.bias_std = bias_res, bias_std
        self.bias_modulate = bias_modulate
        self.blur_std, self.blur_modulate = blur_std, blur_modulate
        self.normalize, self.gamma_std = normalize, gamma_std
        self.dc_offset, self.one_hot, self.seeds = dc_offset, one_hot, seeds
        self.return_vel, self.return_def = return_vel, return_def
        self.impl = impl
        self.device = backend.resolve_device(device)

    # --- shapes and label tables ------------------------------------------

    def _shapes(self, labels_shape):
        """(in_shape, out_shape, num_dim, batch, the warped map's shape)."""
        in_shape = np.asarray(labels_shape[1:-1])
        out_shape = in_shape if self.out_shape is None \
            else np.asarray(self.out_shape)
        map_shape = (out_shape // 2) * 2 if self.warp_std > 0 else in_shape
        return (in_shape, out_shape, len(in_shape), int(labels_shape[0]),
                tuple(int(s) for s in map_shape))

    def _bounds(self, value, default):
        return np.asarray(default if value is None else value, np.float32)

    def _out_lut(self):
        """(LUT from the rebased labels to the output labels, number of
        one-hot classes or None): a label outside `out_label_list` maps to
        0, and to -1 (a zero one-hot row) when 0 is no output label."""
        out = self.out_label_list
        if out is None:
            out = self.in_label_list
        if isinstance(out, (tuple, list, range, np.ndarray)):
            out = {int(lab): int(lab) for lab in out}
        lut = np.zeros(len(self.in_label_list), np.int32)
        for i, lab in enumerate(self.in_label_list):
            if lab in out:
                lut[i] = out[lab]
        if not self.one_hot:
            return lut, None
        hot = np.unique(list(out.values()))
        hot_lut = np.full(hot[-1] + 1, -1, np.int32)
        for i, lab in enumerate(hot):
            hot_lut[lab] = i
        return hot_lut[lut], len(hot)

    # --- draws -------------------------------------------------------------

    def draw(self, labels_shape, generator):
        """
        Every random tensor of one call, on the module's device: 'warp' and
        'bias' (per batch item, each scale's SD and normal field of
        `augment.draw_perlin`, which `perlin` sums), 'mean' and 'std'
        [B, num_chan, L], 'noise' [B, *map_shape, num_chan], 'background',
        'gamma' and 'dc_offset' [B, 1, .., 1, num_chan] (raw uniform,
        standard normal and offset), 'blur' (each axis' sigma, 0-d); a
        stage that is off draws nothing.
        """
        if generator is None:
            raise ValueError('LabelsToImageV1 draws from a generator: pass a '
                             'torch.Generator or an int seed')
        base = (int(generator) if isinstance(generator, (int, np.integer))
                else generator.initial_seed())
        dev = self.device
        gens = _component_generators(base, _COMPONENTS_V1, self.seeds, dev)
        _, out_shape, num_dim, batch, map_shape = self._shapes(labels_shape)
        num_label = len(self.in_label_list)
        ones = (batch, *[1] * num_dim, self.num_chan)
        d = {}
        if self.warp_std > 0:
            vel_shape = (*(out_shape // 2), num_dim)
            d['warp'] = [aug.draw_perlin_scales(
                vel_shape, scales=list(np.asarray(self.warp_res) / 2),
                min_std=0 if self.warp_modulate else self.warp_std,
                max_std=self.warp_std, seed=gens['warp'], device=dev)
                for _ in range(batch)]
        for name, lo, hi in (
                ('mean', self._bounds(self.mean_min,
                                      [0] + [25] * (num_label - 1)),
                 self._bounds(self.mean_max, [225] * num_label)),
                ('std',
                 self._bounds(self.std_min, [0] + [5] * (num_label - 1)),
                 self._bounds(self.std_max, [25] * num_label))):
            lo_t = core.device_constant(lo, dev)
            d[name] = lo_t + torch.rand(
                (batch, self.num_chan, num_label), generator=gens[name],
                device=dev) * (core.device_constant(hi, dev) - lo_t)
        d['noise'] = torch.randn((batch, *map_shape, self.num_chan),
                                 generator=gens['noise'], device=dev)
        if self.zero_background > 0:
            d['background'] = torch.rand(ones, generator=gens['background'],
                                         device=dev)
        if self.blur_std > 0 and self.blur_modulate:
            eps = float(torch.finfo(torch.float32).eps)
            d['blur'] = [core.uniform(gens['blur'], (), eps,
                                      max(float(self.blur_std), eps), dev)
                         for _ in range(num_dim)]
        if self.bias_std > 0:
            d['bias'] = [aug.draw_perlin_scales(
                (*out_shape, 1), scales=self.bias_res,
                min_std=0 if self.bias_modulate else self.bias_std,
                max_std=self.bias_std, seed=gens['bias'], device=dev)
                for _ in range(batch)]
        if self.gamma_std > 0:
            d['gamma'] = torch.randn(ones, generator=gens['gamma'],
                                     device=dev)
        if self.dc_offset > 0:
            d['dc_offset'] = core.uniform(gens['dc_offset'], ones, 0.,
                                          float(self.dc_offset), dev)
        return d

    # --- the deterministic pipeline ------------------------------------------

    def perlin(self, draws, labels_shape):
        """`draws` with the Perlin fields summed from their scales: 'warp'
        becomes 'vel' [B, *out_shape // 2, N] and 'bias' the log-bias field
        [B, *out_shape, 1]."""
        _, out_shape, num_dim, _, _ = self._shapes(labels_shape)
        d = dict(draws)
        for key, name, shape in (('warp', 'vel', (*(out_shape // 2), num_dim)),
                                 ('bias', 'bias', (*out_shape, 1))):
            if key in d:
                d[name] = torch.stack([aug.perlin_from_scales(shape, scales)
                                       for scales in d.pop(key)])
        return d

    def apply(self, labels, draws):
        """The synthesis of integer labels [B, *in_shape, 1] given `draws`
        with their Perlin fields (as `perlin(draw(...))` returns them)."""
        _, _, num_dim, batch, _ = self._shapes(labels.shape)
        dev = labels.device
        if labels.is_floating_point():
            labels = labels.to(torch.int32)
        in_lut = np.zeros(int(np.max(self.in_label_list)) + 1, np.int64)
        for i, lab in enumerate(self.in_label_list):
            in_lut[lab] = i
        in_lut = core.device_constant(in_lut, dev)
        labels = in_lut[labels.long().clamp(0, in_lut.numel() - 1)]

        vel_field = def_field = None
        if self.warp_std > 0:
            vel_field = draws['vel']
            vec = vel_field / 2. ** 5                  # VecInt, 5 squarings
            for _ in range(5):
                vec = vec + _batch_warp(vec, vec, 'linear', None, self.impl)
            def_field = torch.stack([core.resize(f, [2] * num_dim)
                                     for f in vec * 2])
            labels = _batch_warp(labels.to(torch.float32), def_field,
                                 'nearest', 0., self.impl)
        labels = labels.to(torch.int64)

        # per-label normal intensities: mean + std * noise
        num_label = len(self.in_label_list)
        index = torch.cat([labels + i * num_label
                           for i in range(self.num_chan)], -1)
        flat = index.reshape(batch, -1).clamp(0, self.num_chan * num_label - 1)
        mean_vox, std_vox = (torch.gather(draws[k].reshape(batch, -1), 1,
                                          flat).reshape(index.shape)
                             for k in ('mean', 'std'))
        image = draws['noise'] * std_vox + mean_vox

        if self.zero_background > 0:
            flip = draws['background'] < self.zero_background
            image = image * (1. - ((labels == 0) & flip).to(image.dtype))
        if self.blur_std > 0:
            eps = float(torch.finfo(image.dtype).eps)
            sigma = max(float(self.blur_std), eps)
            kernels = core.gaussian_kernel(
                draws['blur'] if self.blur_modulate else [sigma] * num_dim,
                windowsize=[int(np.round(sigma * 3) * 2 + 1)] * num_dim,
                separate=True, dtype=image.dtype, device=dev)
            if not isinstance(kernels, list):
                kernels = [kernels]
            image = core.separable_conv(image, kernels, batched=True,
                                        impl=self.impl)
        if self.bias_std > 0:
            image = image * torch.exp(draws['bias'])
        image = torch.clamp(image, 0, 255)
        if self.normalize:
            image = core.minmax_norm(image, axis=tuple(range(1, image.ndim)))
        if self.gamma_std > 0:
            image = torch.pow(image, torch.exp(self.gamma_std
                                               * draws['gamma']))
        if self.dc_offset > 0:
            image = image + draws['dc_offset']

        # output LUT (a label outside the list: 0, or a zero one-hot row)
        lut, nb_hot = self._out_lut()
        lut = core.device_constant(lut, dev)
        labels = lut[labels.clamp(0, lut.numel() - 1)]
        if self.one_hot:
            classes = torch.arange(nb_hot, device=dev, dtype=labels.dtype)
            labels = (labels[..., 0, None] == classes).to(torch.float32)

        outputs = {'image': image, 'map': labels}
        if self.return_vel:
            outputs['vel'] = vel_field
        if self.return_def:
            outputs['def'] = def_field
        return outputs

    def forward(self, labels, generator=None):
        with trace.span('synth/draw'):
            draws = self.draw(labels.shape, generator)
        with trace.span('synth/perlin'):
            draws = self.perlin(draws, labels.shape)
        with trace.span('synth/apply'):
            return self.apply(labels, draws)


class SynthStripModule(nn.Module):
    """
    SynthStrip: the v1 generator (one_hot=False) synthesizes an image and
    its brain map from the label map, a UNet (conv_size 3, one linear
    output channel) predicts the mask, and the output is concat([pred,
    map], -1), so that the loss sees the ground truth. forward(labels,
    training, generator) draws the synthesis from `generator` (as
    `training.make_train_step` passes it: a new generator each step, as
    `training.fit` makes them) or takes `draws` (raw, as
    `gen.draw` returns them). `ndims` stands for the label map's rank,
    which flax infers; impl='plain' runs the plain versions of K1, K2, K4
    and K6 on any device. While a profiler records, the synthesis opens
    the spans 'neurite/synth/draw' (only when it draws), 'synth/perlin'
    and 'synth/apply' (`trace.span`), as `LabelsToImageV1.forward` does.

    Parity: reference `neurite/tf/models.py:1888-1965`.
    """

    def __init__(self, labels_in, labels_out, nb_unet_features=None,
                 nb_unet_levels=None, unet_feat_mult=1,
                 nb_unet_conv_per_level=1, src_feats=1, gen_args=None,
                 ndims=3, impl='auto', generator=None, device=None):
        super().__init__()
        del src_feats   # unused, as in the reference: the UNet sees the image
        if ndims not in (1, 2, 3):
            raise ValueError(f'ndims should be one of 1, 2, or 3. found: '
                             f'{ndims}')
        device = backend.resolve_device(device)
        gen_args = dict(gen_args or {})
        self.gen = LabelsToImageV1(in_label_list=labels_in,
                                   out_label_list=labels_out, one_hot=False,
                                   return_def=False, impl=impl, device=device,
                                   **gen_args)
        self.unet = UNet(
            gen_args.get('num_chan', 1), ndims, nb_unet_features,
            None if isinstance(nb_unet_features, (list, tuple))
            else nb_unet_levels, 3, 1, feat_mult=unet_feat_mult,
            nb_conv_per_level=nb_unet_conv_per_level,
            final_pred_activation='linear', pool_impl=impl,
            generator=generator, device=device)

    def forward(self, labels, training=None, generator=None, draws=None):
        if draws is None:
            with trace.span('synth/draw'):
                draws = self.gen.draw(labels.shape, generator)
        with torch.no_grad():
            with trace.span('synth/perlin'):
                draws = self.gen.perlin(draws, labels.shape)
            with trace.span('synth/apply'):
                out = self.gen.apply(labels, draws)
        pred = self.unet(out['image'], training=training, generator=generator)
        return torch.cat([pred, out['map'].to(torch.float32)], dim=-1)


def labels_to_image(in_shape, in_label_list, out_label_list=None,
                    out_shape=None, num_chan=1, input_model=None, device=None,
                    **kwargs):
    """Build the legacy generator (ref `models.py:649-917` knob set) on
    `device` (the card unless 'cpu')."""
    del in_shape, input_model
    kwargs.pop('id', None)
    for k in ('mean_min', 'mean_max', 'std_min', 'std_max', 'warp_res'):
        if k in kwargs and isinstance(kwargs[k], (list, np.ndarray)):
            kwargs[k] = tuple(np.ravel(kwargs[k]).tolist())
    if isinstance(in_label_list, (list, range, np.ndarray)):
        in_label_list = tuple(int(v) for v in in_label_list)
    if isinstance(out_label_list, (list, range, np.ndarray)):
        out_label_list = tuple(int(v) for v in out_label_list)
    if out_shape is not None:
        out_shape = tuple(int(v) for v in out_shape)
    return LabelsToImageV1(in_label_list=in_label_list,
                           out_label_list=out_label_list, out_shape=out_shape,
                           num_chan=num_chan, device=device, **kwargs)


def SynthStrip(inshape, labels_in, labels_out, nb_unet_features=None,
               nb_unet_levels=None, unet_feat_mult=1, nb_unet_conv_per_level=1,
               src_feats=1, gen_args=None, impl='auto', generator=None,
               device=None):
    """Build a SynthStrip module (ref `models.py:1888-1965` knob set) for
    label maps of spatial shape `inshape`, on `device` (the card unless
    'cpu'); `generator` draws the UNet's initial weights."""
    return SynthStripModule(
        labels_in=labels_in, labels_out=labels_out,
        nb_unet_features=nb_unet_features, nb_unet_levels=nb_unet_levels,
        unet_feat_mult=unet_feat_mult,
        nb_unet_conv_per_level=nb_unet_conv_per_level, src_feats=src_feats,
        gen_args=gen_args, ndims=len(inshape), impl=impl, generator=generator,
        device=device)
