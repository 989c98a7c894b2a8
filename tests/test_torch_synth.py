"""
The PyTorch port's synthesis path (`neurite_tpu_torch.utils.spatial`,
`utils.augment`, `layers.random`, `models.synth`) against the JAX package's.

JAX keys and torch generators draw different numbers, so the parity tests
hand the JAX run's draws (reproduced from its keys, or returned by the JAX
model) to the port's deterministic `apply` stages; the port's own draws are
checked against their ranges and formulas. Tolerances: 1e-5 absolute in
float32; label maps exact where the port's warp is fed the JAX field.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.layers import random as jrandom  # noqa: E402
from neurite_tpu.utils import augment as jaug  # noqa: E402
from neurite_tpu.utils import core as jcore  # noqa: E402
from neurite_tpu.utils import spatial as jsp  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import backend, convert, training  # noqa: E402
from neurite_tpu_torch.layers import random as trandom  # noqa: E402
from neurite_tpu_torch.utils import augment as taug  # noqa: E402
from neurite_tpu_torch.utils import core as tcore  # noqa: E402
from neurite_tpu_torch.utils import spatial as tsp  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _jx(fn, *arrays, **static):
    """fn(*arrays, **static) of the JAX package as one jitted program (op
    by op, every op compiles on its own)."""
    return jax.jit(functools.partial(fn, **static))(*arrays)


def _field(seed, shape, amp=2.):
    rng = np.random.default_rng(seed)
    return (amp * rng.normal(size=shape)).astype(np.float32)


###############################################################################
# spatial
###############################################################################

@pytest.mark.parametrize('nb_steps', [1, 5])
def test_integrate_vec(nb_steps):
    vec = _field(0, (8, 9, 10, 3))
    want = jsp.integrate_vec(jnp.asarray(vec), nb_steps=nb_steps)
    _close(tsp.integrate_vec(_t(vec), nb_steps=nb_steps), want)
    vb = np.stack([vec, _field(1, (8, 9, 10, 3))])
    want = jsp.batch_integrate_vec(jnp.asarray(vb), nb_steps=nb_steps)
    _close(tsp.batch_integrate_vec(_t(vb), nb_steps=nb_steps,
                                   impl='window', max_disp=1.), want)


def test_integrate_vec_2d_and_transform():
    vec = _field(2, (10, 12, 2))
    _close(tsp.integrate_vec(_t(vec), nb_steps=4),
           _jx(jsp.integrate_vec, vec, nb_steps=4))
    vol = _field(3, (10, 12, 3), 1.)
    for method in ('linear', 'nearest'):
        _close(tsp.transform(_t(vol), _t(vec), interp_method=method,
                             fill_value=0.),
               _jx(jsp.transform, vol, vec, interp_method=method,
                   fill_value=0.))


def test_rescale_dense_transform_and_rescale_transform():
    f = _field(4, (6, 7, 8, 3))
    _close(tsp.rescale_dense_transform(_t(f), 2),
           _jx(jsp.rescale_dense_transform, f, factor=2))
    m = np.eye(4, dtype=np.float32)[:3] + _field(5, (3, 4), .1)
    _close(tsp.rescale_transform(_t(m), 2),
           _jx(jsp.rescale_transform, m, factor=2))


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_resize_separable_and_interp_matrix_match_jax(method):
    """ops.resize against JAX `ops/resize_mm.py`: both impls, up and down,
    and the 1-D matrices."""
    from neurite_tpu.ops import resize_mm
    from neurite_tpu_torch.ops import resize as tresize
    f = _field(24, (6, 7, 8, 3))
    for new_shape in [(12, 14, 16), (3, 9, 5)]:
        for impl in ('take', 'matmul'):
            _close(tresize.resize_separable(_t(f), new_shape, method, impl),
                   resize_mm.resize_separable(jnp.asarray(f), new_shape,
                                              method, impl))
    for n, m in ((12, 6), (5, 9)):
        np.testing.assert_array_equal(
            tresize.interp_matrix(n, m, method, device='cpu').numpy(),
            np.asarray(resize_mm.interp_matrix(n, m, method)))


def _affine(seed):
    rng = np.random.default_rng(seed)
    par = rng.uniform(-1, 1, size=12) * np.asarray(
        [3, 3, 3, 20, 20, 20, .1, .1, .1, .1, .1, .1])
    return par.astype(np.float32)


def test_params_to_affine_matrix_rotation_shear():
    par = _affine(6)
    for kw in (dict(shift_scale=True, last_row=True), dict(deg=False)):
        want = _jx(lambda p: jsp.params_to_affine_matrix(par=p, **kw), par)
        _close(tsp.params_to_affine_matrix(par=_t(par), **kw), want)
    # components one by one, 2-D, and a batch of parameter vectors
    _close(tsp.params_to_affine_matrix(rotation=[30.], translation=[1., 2.],
                                       scaling=[1.1, .9], shear=[.2],
                                       ndims=2),
           jsp.params_to_affine_matrix(rotation=[30.], translation=[1., 2.],
                                       scaling=[1.1, .9], shear=[.2],
                                       ndims=2))
    pb = np.stack([_affine(7), _affine(8)])
    got = tsp.params_to_affine_matrix(par=_t(pb), last_row=True)
    for i in range(2):
        _close(got[i], _jx(jsp.params_to_affine_matrix, pb[i],
                           last_row=True))
    _close(tsp.angles_to_rotation_matrix(_t([10., -20., 5.])),
           jsp.angles_to_rotation_matrix(jnp.asarray([10., -20., 5.])))


@pytest.mark.parametrize('shift_center', [True, False])
def test_affine_to_dense_shift_and_compose(shift_center):
    shape = (6, 7, 8)
    m = np.asarray(jsp.params_to_affine_matrix(par=jnp.asarray(_affine(9))))
    _close(tsp.affine_to_dense_shift(_t(m), shape, shift_center=shift_center),
           _jx(jsp.affine_to_dense_shift, m, shape=shape,
               shift_center=shift_center), 1e-4)
    d = _field(10, (*shape, 3))
    _close(tsp.compose_affine_dense(_t(m), _t(d), shape),
           _jx(jsp.compose_affine_dense, m, d, shape=shape))
    _close(tsp.compose_transforms([_t(m), _t(d)], shift_center=shift_center),
           _jx(lambda a, b: jsp.compose_transforms(
               [a, b], shift_center=shift_center), m, d), 1e-4)
    # batched closed form
    mb = np.stack([np.asarray(jsp.make_square_affine(jnp.asarray(m)))] * 2)
    db = np.stack([d, _field(11, (*shape, 3))])
    got = tsp.compose_affine_dense(_t(mb), _t(db), shape)
    for i in range(2):
        _close(got[i], _jx(jsp.compose_affine_dense, mb[i], db[i],
                           shape=shape))


def test_flip_and_swap_matrices():
    gen = torch.Generator().manual_seed(0)
    shape = (5, 6, 7)
    seen_flip, seen_perm = set(), set()
    for _ in range(40):
        f = tsp.draw_flip_matrix(gen, shape, device='cpu')
        flips = tuple(bool(v) for v in torch.diagonal(f)[:3] < 0)
        seen_flip.add(flips)
        want = np.eye(4, dtype=np.float32)
        for ax, fl in enumerate(flips):
            if fl:
                want[ax, ax], want[ax, 3] = -1., shape[ax] - 1.
        np.testing.assert_array_equal(f.numpy(), want)
        s = tsp.draw_swap_matrix(gen, 3, device='cpu').numpy()
        assert s[3, 3] == 1 and (s.sum(0) == 1).all() and (s.sum(1) == 1).all()
        seen_perm.add(tuple(s[:3, :3].argmax(1)))
    assert len(seen_flip) > 4 and len(seen_perm) == 6
    c = tsp.draw_flip_matrix(gen, shape, shift_center=True, device='cpu')
    assert (c[:3, 3] == 0).all()


def test_draw_affine_params_ranges():
    gen = torch.Generator().manual_seed(1)
    for normal in (False, True):
        p = torch.stack([tsp.draw_affine_params(
            gen, shift=3., rot=10., scale=.1, shear=.2, normal_shift=normal,
            normal_rot=normal, normal_scale=normal, normal_shear=normal,
            device='cpu') for _ in range(50)])
        assert p.shape == (50, 12)
        assert p[:, :3].abs().max() <= 3 and p[:, 3:6].abs().max() <= 10
        assert (p[:, 6:9] - 1).abs().max() <= .1
        assert p[:, 9:].abs().max() <= .2
        assert p[:, :3].abs().max() > 1


###############################################################################
# augment and layers
###############################################################################

def _jax_blur_kernels(key, n_dim, std_min, std_max):
    """The kernels `augment.random_blur_rescale` draws from `key`."""
    out = []
    for k in jax.random.split(key, n_dim):
        kern = jcore.gaussian_kernel(sigma=std_max, separate=True,
                                     random=True, min_sigma=std_min, seed=k)
        out.append(kern[0] if isinstance(kern, list) else kern)
    return out


@pytest.mark.parametrize('reduce', ['std', 'max'])
@pytest.mark.parametrize('batched', [False, True])
def test_random_blur_rescale_with_given_kernels(reduce, batched):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 10, 11, 12, 3) if batched
                   else (10, 11, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jred, tred = {'std': (jnp.std, taug.std), 'max': (jnp.max, torch.max)}[
        reduce]
    want = jax.jit(lambda a, k: jaug.random_blur_rescale(
        a, std_min=1., std_max=3., seed=k, reduce=jred, batched=batched))(
        x, key)
    ks = [_t(k) for k in _jax_blur_kernels(key, 3, 1., 3.)]
    got = taug.blur_rescale(_t(x), ks, reduce=tred, batched=batched)
    _close(got, want)


def test_perlin_draws():
    gen = torch.Generator().manual_seed(2)
    v = taug.draw_perlin_full((8, 9, 10, 3), noise_min=.5, noise_max=2.,
                              fwhm_min=(2, 2), fwhm_max=(6, 6),
                              featured=True, axes=[3], reduce=torch.max,
                              seed=gen, device='cpu')
    assert v.shape == (8, 9, 10, 3) and torch.isfinite(v).all()
    # the draw and the apply of draw_perlin_full, split
    levels = taug.draw_perlin_levels(
        (8, 9, 10, 3), noise_min=.5, noise_max=2., fwhm_min=(2, 2),
        fwhm_max=(6, 6), featured=True, axes=[3],
        seed=torch.Generator().manual_seed(2), device='cpu')
    assert len(levels) == 2 and levels[0][0].shape == (1, 8, 9, 10, 3)
    assert torch.equal(taug.perlin_from_levels(levels, torch.max,
                                               featured=True), v)
    b = taug.draw_perlin_full((8, 9, 10), seed=gen, device='cpu')
    assert b.shape == (8, 9, 10)
    p = taug.draw_perlin((8, 9, 10, 2), scales=[1, 2, 4], max_std=2.,
                         seed=gen, device='cpu')
    assert p.shape == (8, 9, 10, 2) and p.std() > 0
    layer = trandom.PerlinNoise(fwhm_min=2, fwhm_max=4)
    assert layer(torch.zeros(2, 8, 8, 8, 1), gen).shape == (2, 8, 8, 8, 1)
    with pytest.raises(ValueError, match='noise-SD'):
        taug.draw_perlin_full((8, 8), noise_min=0, seed=gen, device='cpu')


def test_gaussian_blur_layer_fixed_sigma():
    x = _field(13, (2, 10, 11, 12, 2), 1.)
    for kw in (dict(sigma=1.2), dict(sigma=[0.5, 1., 0.]), dict(level=2)):
        want = jax.jit(jrandom.GaussianBlur(**kw).apply)({}, x)
        _close(trandom.GaussianBlur(**kw)(_t(x)), want)


def test_gaussian_blur_layer_random_sigma_given():
    """The random sigma drawn by JAX, handed to the port's apply."""
    x = _field(14, (1, 10, 11, 12, 1), 1.)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda a, k: jrandom.GaussianBlur(
        sigma=2., min_sigma=.5, random=True).apply({}, a, key=k))(x, key)
    eps = float(np.finfo(np.float32).eps)
    sig = [jax.random.uniform(k, (), minval=.5, maxval=2.)
           for k in jax.random.split(key, 3)]
    layer = trandom.GaussianBlur(sigma=2., min_sigma=.5, random=True)
    _close(layer.apply(_t(x), [_t(s) for s in sig]), want)
    drawn = layer.draw(x.shape, torch.Generator().manual_seed(0), 'cpu')
    assert all(.5 - eps <= float(s) < 2. for s in drawn)


def test_gaussian_noise_layer_formula():
    x = _field(15, (2, 6, 7, 8, 2), 1.)
    key = jax.random.PRNGKey(5)
    want = jrandom.GaussianNoise(noise_min=.1, noise_max=.3).apply(
        {}, jnp.asarray(x), key=key)
    k_sd, k_re, _ = jax.random.split(key, 3)
    sd = jax.random.uniform(k_sd, (2, 1, 1, 1, 2), minval=.1, maxval=.3)
    n = jax.random.normal(k_re, x.shape)
    layer = trandom.GaussianNoise(noise_min=.1, noise_max=.3)
    _close(layer.apply(_t(x), (_t(sd), _t(n))), want)
    gen = torch.Generator().manual_seed(3)
    sd_t, n_t = layer.draw(x.shape, gen, 'cpu')
    assert sd_t.shape == (2, 1, 1, 1, 2)
    assert ((sd_t >= .1) & (sd_t < .3)).all()
    out = layer.apply(_t(x), (sd_t, n_t))
    torch.testing.assert_close(out, _t(x) + sd_t * _t(np.abs(x).max()) * n_t)
    assert trandom.GaussianNoise(noise_max=0)(_t(x)) is not None
    assert torch.equal(trandom.GaussianNoise(noise_max=0)(_t(x)), _t(x))


@pytest.mark.parametrize('prob', [1., .5])
def test_subsample_matches_jax_draws(prob):
    x = _field(16, (1, 12, 10, 9, 1), 1.)
    key = jax.random.PRNGKey(6)
    axes = [1, 2, 3]
    want = jcore.subsample_axis(jnp.asarray(x), stride_min=2, stride_max=5,
                                axes=axes, prob=prob, seed=key)
    k_ax, k_thick, k_prob = jax.random.split(key, 3)
    ind = jax.random.randint(k_ax, (), 0, len(axes))
    thick = jax.random.uniform(k_thick, (), minval=2., maxval=5.)
    if prob < 1:
        thick = jnp.where(jax.random.uniform(k_prob, ()) < prob, thick, 1.)
    got = tcore.apply_subsample(_t(x), _t(ind), _t(thick), axes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    layer = trandom.Subsample(stride_min=2, stride_max=5, prob=prob)
    assert layer(_t(x), torch.Generator().manual_seed(0)).shape == x.shape


@pytest.mark.parametrize('bilateral', [False, True])
def test_crop_mask_matches_jax_draws(bilateral):
    x = _field(17, (1, 12, 10, 9, 1), 1.)
    key = jax.random.PRNGKey(7)
    axis = [1, 2, 3]
    want = jaug.draw_crop_mask(jnp.asarray(x), crop_min=.1, crop_max=.4,
                               axis=axis, prob=.8, bilateral=bilateral,
                               seed=key)
    k_cut, k_prob, k_prop, k_axis = jax.random.split(key, 4)
    cut = jax.random.uniform(k_cut, (), minval=.1, maxval=.4)
    cut = cut * (jax.random.uniform(k_prob, ()) < .8)
    prop = jax.random.uniform(k_prop, ())
    if not bilateral:
        prop = (prop < .5).astype(jnp.float32)
    ind = jax.random.randint(k_axis, (), 0, 3)
    got = taug.crop_mask(x.shape, axis, _t(cut * prop), _t(1 - cut), _t(ind),
                         torch.float32, 'cpu')
    np.testing.assert_array_equal(
        np.broadcast_to(got.numpy(), x.shape),
        np.broadcast_to(np.asarray(want), x.shape))
    gen = torch.Generator().manual_seed(1)
    for _ in range(10):
        m = taug.draw_crop_mask(_t(x), crop_min=.1, crop_max=.4, axis=axis,
                                bilateral=bilateral, seed=gen)
        kept = float(np.broadcast_to(m.numpy(), x.shape).mean())
        assert .6 - .1 <= kept <= .9 + .1
    layer = trandom.RandomCrop(crop_max=.3)
    assert layer(_t(x), gen).shape == x.shape


###############################################################################
# LabelsToImage against JAX
###############################################################################

SYNTH_KW = dict(noise_max=0, gamma=0, blur_min=1, blur_max=1,
                warp_impl='gather', label_warp_impl='gather', return_vel=True,
                return_def=True, return_aff=True, return_mean=True,
                return_bias=True)


def _jax_synth(labels, **kw):
    model = ne.models.labels_to_image_new(**kw)
    return jax.jit(lambda lab, k: model.apply({}, lab, key=k))(
        jnp.asarray(labels), jax.random.PRNGKey(3))


def _port_apply(labels, jout, **kw):
    """The port's pipeline given the JAX run's draws."""
    model = nt.models.labels_to_image_new(device='cpu', **kw)
    draws = model.perlin(model.draw(labels.shape,
                                    torch.Generator().manual_seed(0)))
    for k in ('aff', 'vel', 'mean', 'bias'):
        if jout.get(k) is not None:
            draws[k] = _t(jout[k])
    return model, model.apply(_t(labels), draws)


def _close_where_maps_agree(timg, jimg, tmap, jmap, radius=3):
    """The images agree to ATOL away from the voxels whose labels differ (a
    nearest tie), and from their neighbours within the image blur's
    `radius`, which spreads a voxel's intensity."""
    bad = torch.from_numpy(np.any(np.asarray(tmap) != np.asarray(jmap), -1))
    near = torch.nn.functional.max_pool3d(
        bad[:, None].float(), 2 * radius + 1, stride=1, padding=radius)[:, 0]
    keep = (near == 0).numpy()
    assert keep.mean() > .5, f'only {keep.mean():.3f} of voxels compared'
    _close(np.asarray(timg)[keep], np.asarray(jimg)[keep])


@pytest.fixture(scope='module')
def synth6():
    labels = np.random.default_rng(20).integers(0, 6, size=(1, 16, 16, 16, 1))
    kw = dict(labels_in=range(6), aff_shift=3., aff_rotate=10., **SYNTH_KW)
    return labels, kw, _jax_synth(labels, **kw)


def test_labels_to_image_matches_jax(synth6):
    labels, kw, jout = synth6
    _, tout = _port_apply(labels, jout, **kw)
    assert set(tout) == set(jout)
    for k in ('vel', 'aff', 'mean', 'bias'):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    _close(tout['def'], jout['def'])
    jmap, tmap = np.asarray(jout['map']), tout['map'].numpy()
    assert tmap.shape == jmap.shape == (1, 16, 16, 16, 6)
    mismatch = np.mean(jmap.argmax(-1) != tmap.argmax(-1))
    assert mismatch < 0.02, f'{mismatch:.4f} of voxels differ'
    _close_where_maps_agree(tout['image'], jout['image'], tmap, jmap)


def test_label_warp_fed_jax_def_is_exact(synth6):
    labels, kw, jout = synth6
    shape = np.asarray(labels.shape[1:-1])
    origin = np.eye(4)
    origin[:3, -1] = -0.5 * (shape - 1)
    trans = (np.linalg.inv(origin) @ np.asarray(jout['aff'][0])
             @ origin).astype(np.float32)
    dense = tsp.compose_affine_dense(_t(trans), _t(jout['def'][0]),
                                     tuple(shape))
    warped = tsp.batch_transform(_t(labels).float(), dense[None],
                                 interp_method='nearest', fill_value=0)
    np.testing.assert_array_equal(warped[..., 0].long().numpy(),
                                  np.asarray(jout['map']).argmax(-1))


# Dict LUTs: the JAX module's dict knobs become flax FrozenDicts once bound,
# which `isinstance(.., dict)` rejects, so the JAX model reads them as label
# lists (ROADMAP Queue 3). The port keeps the reference's dict semantics; a
# dict case is compared with a JAX run of the same function in list knobs:
# generation labels folded into pinned means (mean_min == mean_max), and the
# output LUT applied to the JAX run's raw warped labels.
GEN_MEANS = [.2, .5, .9]


@pytest.mark.parametrize('kw,jax_kw,out_lut', [
    (dict(labels_in={0: 0, 1: 1, 2: 1, 3: 2, 5: 2}, labels_out=[0, 1, 2],
          mean_min=GEN_MEANS, mean_max=GEN_MEANS),
     dict(labels_in=range(6), labels_out=[0, 1, 2],
          mean_min=[GEN_MEANS[i] for i in (0, 1, 1, 2, 0, 2)],
          mean_max=[GEN_MEANS[i] for i in (0, 1, 1, 2, 0, 2)]), None),
    (dict(labels_in=range(6), labels_out={0: 0, 1: 4, 2: 4, 3: 7},
          one_hot=False),
     dict(labels_in=range(6), labels_out=range(6), one_hot=False),
     np.asarray([0, 4, 4, 7, 0, 0])),
    (dict(labels_in=range(6), num_chan=2, mean_min=[0] * 6,
          mean_max=[5] * 6, out_shape=(12, 14, 16)), {}, None),
])
def test_labels_to_image_luts_and_shapes_match_jax(kw, jax_kw, out_lut):
    labels = np.random.default_rng(21).integers(0, 6, size=(1, 16, 16, 16, 1))
    full = {**SYNTH_KW, 'bias_max': 0, **kw}
    jout = _jax_synth(labels, **{**full, **jax_kw})
    jmap = np.asarray(jout['map'])
    if out_lut is not None:
        jmap = out_lut[jmap]
    if 'mean_min' in jax_kw:    # pinned; the port draws its own 3 means
        jout = {k: v for k, v in jout.items() if k != 'mean'}
    _, tout = _port_apply(labels, jout, **full)
    assert tout['map'].shape == jmap.shape
    assert tout['image'].shape == jout['image'].shape
    tmap = tout['map'].numpy()
    assert np.mean(jmap != tmap) < 0.02
    _close_where_maps_agree(tout['image'], jout['image'], tmap, jmap)


###############################################################################
# LabelsToImage: the port's own draws
###############################################################################

def _synth(labels_shape=(2, 16, 16, 16, 1), seed=0, **kw):
    model = nt.models.labels_to_image_new(
        labels_in=range(4), device='cpu', warp_blur_min=(2, 2),
        warp_blur_max=(4, 4), bias_blur_min=4, bias_blur_max=8, **kw)
    labels = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, size=labels_shape))
    return model, labels


def test_draw_ranges_and_outputs():
    model, labels = _synth(aff_shift=2., aff_rotate=5., aff_scale=.1,
                           return_vel=True, return_def=True, return_aff=True,
                           return_mean=True, return_bias=True)
    d = model.perlin(model.draw(labels.shape, torch.Generator().manual_seed(1)))
    assert d['aff'].shape == (2, 4, 4) and d['vel'].shape == (2, 8, 8, 8, 3)
    assert d['mean'].shape == (2, 1, 4)
    assert ((d['mean'] >= 0) & (d['mean'] < 1)).all()
    assert (d['bias'] > 0).all() and d['bias'].shape == (2, 16, 16, 16, 1)
    assert d['aff'][:, :3, 3].abs().max() <= 2.
    lin = d['aff'][:, :3, :3]
    sv = torch.linalg.svdvals(lin)
    assert sv.min() >= .9 - 1e-5 and sv.max() <= 1.1 + 1e-5
    sd, n = d['noise']
    assert ((sd >= .1) & (sd < .2)).all() and n.shape == (2, 16, 16, 16, 1)
    assert ((d['gamma'] >= .5) & (d['gamma'] < 1.5)).all()
    assert all(0 < float(s) < 1 for s in d['blur'])
    out = model.apply(labels, d)
    img = out['image']
    assert img.shape == (2, 16, 16, 16, 1) and torch.isfinite(img).all()
    assert float(img.min()) >= 0 and float(img.max()) <= 1
    assert out['map'].shape == (2, 16, 16, 16, 4)
    assert torch.equal(out['map'].sum(-1), torch.ones(2, 16, 16, 16))
    assert out['vel'].abs().max() <= 8.
    assert out['def'].abs().max() <= 8.


def test_noise_gamma_background_formulas():
    """Each stage alone, against its formula (`models/synth.py:460-500`)."""
    model, labels = _synth(warp_max=0, bias_max=0, blur_max=0,
                           zero_background=1., return_mean=True)
    d = model.perlin(model.draw(labels.shape, torch.Generator().manual_seed(2)))
    out = model.apply(labels, d)
    # no warp: the label map is the input; means gathered per label
    img = d['mean'][torch.arange(2)[:, None, None, None], 0,
                    labels[..., 0]][..., None]
    sd, n = d['noise']
    img = img + sd * img.abs().max() * n
    img = img * (labels != 0)              # zero_background=1: always
    img = tcore.minmax_norm(img, axis=(1, 2, 3, 4))
    img = img ** d['gamma']
    torch.testing.assert_close(out['image'], img)


def test_crop_and_slices():
    model, labels = _synth(crop_prob=1., crop_min=.2, crop_max=.4,
                           slice_prob=1., slice_stride_min=2,
                           slice_stride_max=4, warp_max=0)
    d = model.perlin(model.draw(labels.shape, torch.Generator().manual_seed(3)))
    m = d['crop'].expand(labels.shape)
    assert .6 - 1 / 16 <= float(m.mean()) <= .8 + 1 / 16  # whole voxels
    out = model.apply(labels, d)
    cropped = out['map'][..., 0][m[..., 0] == 0]
    assert (cropped == 1).all()             # cropped voxels are label 0
    ind, thick = d['slice']
    assert 0 <= int(ind) < 3 and 2 <= float(thick) < 4


def test_seeds_pin_components_and_generators_reproduce():
    model, labels = _synth(seeds={'warp': 5, 'mean': 6}, return_vel=True,
                           return_mean=True, return_bias=True)
    a = model(labels, torch.Generator().manual_seed(1))
    b = model(labels, torch.Generator().manual_seed(2))
    c = model(labels, torch.Generator().manual_seed(1))
    assert torch.equal(a['vel'], b['vel']) and torch.equal(a['mean'],
                                                           b['mean'])
    assert not torch.equal(a['bias'], b['bias'])
    for k in a:
        assert torch.equal(a[k], c[k]), k
    assert torch.equal(model(labels, 1)['image'], c['image'])
    bad, _ = _synth(seeds={'warpp': 1})
    with pytest.raises(ValueError, match='unknown seeds'):
        bad(labels, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='generator'):
        model(labels)


def test_knobs_flip_swap_half_res_and_impls():
    for impl in ('auto', 'window', 'onehot', 'gather'):
        model, labels = _synth(axes_flip=True, axes_swap=True, warp_impl=impl,
                               label_warp_impl=impl, return_def=True)
        out = model(labels, torch.Generator().manual_seed(4))
        assert out['map'].shape == (2, 16, 16, 16, 4)
    model, labels = _synth(half_res=True, return_def=True)
    out = model(labels, torch.Generator().manual_seed(5))
    assert out['image'].shape == (2, 8, 8, 8, 1)
    assert out['def'].shape == (2, 8, 8, 8, 3)
    with pytest.raises(ValueError, match='warp_impl'):
        _synth(warp_impl='pallas')
    with pytest.raises(ValueError, match='gamma'):
        _synth(gamma=1.5)


def test_synthesis_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.default_device()
    with pytest.raises(RuntimeError, match='CUDA'):
        nt.models.labels_to_image_new(labels_in=range(4))
    with pytest.raises(RuntimeError, match='CUDA'):
        nt.models.unet(4, (8, 8, 8, 1), 2, 3, 2)
    assert backend.resolve_device('cpu') == torch.device('cpu')


###############################################################################
# one config-#5-shaped step
###############################################################################

UNET = dict(nb_features=16, nb_levels=4, feat_mult=2, nb_conv_per_level=2,
            conv_size=3, nb_labels=16, input_shape=(16, 16, 16, 1))


def test_synth_train_step_loss_matches_jax():
    """Config #5 at 16^3: labels 0-15, default knobs but for the stages
    whose draws the JAX model does not return (noise, gamma, blur sigma);
    the UNet at config #5's widths in float32 with converted weights. The
    port's step loss is within 1e-5 of the JAX loss on the JAX synthesis."""
    labels = np.random.default_rng(22).integers(0, 16, size=(1, 16, 16, 16, 1))
    kw = dict(labels_in=range(16), out_shape=(16,) * 3, one_hot=True,
              **SYNTH_KW)
    jout = _jax_synth(labels, **kw)
    _, tout = _port_apply(labels, jout, **kw)

    tm = nt.models.unet(device='cpu', **UNET,
                        generator=torch.Generator().manual_seed(0))
    jm = ne.models.unet(**UNET)
    params = convert.to_flax_params(tm)
    jloss = ne.losses.SoftDice(check_input_limits=False).loss
    lj = jax.jit(lambda p, x, y: jloss(y, jm.apply({'params': p}, x,
                                                   training=True)))(
        params, jout['image'], jout['map'])

    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    _, m = step(state, (tout['image'], tout['map']),
                torch.Generator().manual_seed(0))
    assert np.isfinite(float(m['loss']))
    np.testing.assert_allclose(float(m['loss']), float(lj), rtol=0,
                               atol=1e-5)
