"""
The PyTorch port's SynthStrip path (`utils.augment.draw_perlin`,
`models.LabelsToImageV1`, `labels_to_image`, `SynthStripModule`,
`SynthStrip`) against the JAX package's.

JAX keys and torch generators draw different numbers, so the parity tests
recompute the JAX run's raw draws from its keys (`_component_keys` and the
splits of `draw_perlin` and `gaussian_kernel`) and hand them to the port's
deterministic `perlin` and `apply` stages. Tolerances: the Perlin fields
within 1e-6, the deformation within 1e-5 (five squaring warps, summed in
another order), images within 1e-5 away from the voxels whose nearest label
differs (a tie), the SynthStrip step at float32 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.models import synth as jsynth  # noqa: E402
from neurite_tpu.utils import augment as jaug  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import backend, convert, training  # noqa: E402
from neurite_tpu_torch.utils import augment as taug  # noqa: E402

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _jax_perlin_draws(key, out_shape, scales, min_std, max_std):
    """The raw draws `neurite_tpu.utils.augment.draw_perlin` makes from
    `key`: per scale, its SD and its standard normal field."""
    out_shape = np.asarray(out_shape)
    scales = [scales] if np.isscalar(scales) else scales
    draws = []
    for scale in scales:
        key, k_std, k_noise = jax.random.split(key, 3)
        sample = (*np.int32(np.ceil(out_shape[:-1] / scale)), out_shape[-1])
        std = jax.random.uniform(k_std, (), minval=min_std, maxval=max_std)
        draws.append((_t(std), _t(jax.random.normal(
            k_noise, tuple(int(s) for s in sample)))))
    return draws


@pytest.mark.parametrize('out_shape,scales', [
    ((12, 10, 9, 3), [2., 4.]), ((16, 16, 16, 1), 40), ((8, 9, 2), [1, 3])])
def test_draw_perlin_from_jax_draws(out_shape, scales):
    key = jax.random.PRNGKey(1)
    want = jaug.draw_perlin(out_shape, scales, min_std=.2, max_std=.7,
                            seed=key)
    draws = _jax_perlin_draws(key, out_shape, scales, .2, .7)
    _close(taug.perlin_from_scales(out_shape, draws), want, 1e-6)
    # the port's own draw: shapes, SD range, and draw_perlin = its split
    got = taug.draw_perlin_scales(out_shape, scales, .2, .7, seed=3,
                                  device='cpu')
    for (sd, noise), (_, jn) in zip(got, draws):
        assert .2 <= float(sd) < .7 and noise.shape == jn.shape
    torch.testing.assert_close(
        taug.draw_perlin(out_shape, scales, .2, .7, seed=3, device='cpu'),
        taug.perlin_from_scales(out_shape, got), rtol=0, atol=0)


###############################################################################
# LabelsToImageV1 against JAX
###############################################################################

def _jax_v1_draws(key, model, labels_shape):
    """Every raw draw the JAX `LabelsToImageV1` makes from `key`, in the
    port's layout (`LabelsToImageV1.draw`)."""
    keys = jsynth._component_keys(key, jsynth._COMPONENTS_V1, None)
    _, out_shape, nd, batch, map_shape = model._shapes(labels_shape)
    ones = (batch, *[1] * nd, model.num_chan)
    num_label = len(model.in_label_list)
    d = {}
    if model.warp_std > 0:
        d['warp'] = [_jax_perlin_draws(
            k, (*(out_shape // 2), nd), list(np.asarray(model.warp_res) / 2),
            0 if model.warp_modulate else model.warp_std, model.warp_std)
            for k in jax.random.split(keys['warp'], batch)]
    for name, lo, hi in (
            ('mean', [0] + [25] * (num_label - 1), [225] * num_label),
            ('std', [0] + [5] * (num_label - 1), [25] * num_label)):
        lo, hi = np.float32(lo), np.float32(hi)
        u = jax.random.uniform(keys[name], (batch, model.num_chan, num_label))
        d[name] = _t(lo + u * (hi - lo))
    d['noise'] = _t(jax.random.normal(keys['noise'],
                                      (batch, *map_shape, model.num_chan)))
    if model.zero_background > 0:
        d['background'] = _t(jax.random.uniform(keys['background'], ones))
    if model.blur_std > 0 and model.blur_modulate:
        d['blur'] = [_t(jax.random.uniform(k, (), minval=EPS,
                                           maxval=model.blur_std))
                     for k in jax.random.split(keys['blur'], nd)]
    if model.bias_std > 0:
        d['bias'] = [_jax_perlin_draws(
            k, (*out_shape, 1), model.bias_res,
            0 if model.bias_modulate else model.bias_std, model.bias_std)
            for k in jax.random.split(keys['bias'], batch)]
    if model.gamma_std > 0:
        d['gamma'] = _t(jax.random.normal(keys['gamma'], ones))
    if model.dc_offset > 0:
        d['dc_offset'] = _t(jax.random.uniform(keys['dc_offset'], ones,
                                               maxval=model.dc_offset))
    return d


def _close_where_maps_agree(timg, jimg, tmap, jmap, radius=3):
    """Images within 1e-5 away from the voxels whose labels differ (a
    nearest tie) and from their neighbours within the blur's radius."""
    bad = torch.from_numpy(np.any(np.asarray(tmap) != np.asarray(jmap), -1))
    near = torch.nn.functional.max_pool3d(
        bad[:, None].float(), 2 * radius + 1, stride=1, padding=radius)[:, 0]
    keep = (near == 0).numpy()
    assert keep.mean() > .5, f'only {keep.mean():.3f} of voxels compared'
    _close(np.asarray(timg)[keep], np.asarray(jimg)[keep], 1e-5)


V1_CASES = {
    'list one-hot': dict(in_label_list=range(6), out_label_list=[0, 2, 3]),
    'dict, a label outside, one-hot': dict(
        in_label_list=[0, 1, 2, 3, 5, 7], out_label_list={1: 4, 2: 4, 3: 9},
        dc_offset=.3),
    'dict no one-hot': dict(in_label_list=range(6),
                            out_label_list={l: 1 for l in range(1, 4)},
                            one_hot=False, num_chan=2),
    'float labels, no warp, fixed blur': dict(
        in_label_list=range(6), warp_std=0, blur_modulate=False,
        bias_modulate=False, gamma_std=0, zero_background=0),
}


@pytest.mark.parametrize('case', list(V1_CASES))
def test_labels_to_image_v1_matches_jax(case):
    kw = dict(V1_CASES[case], return_vel=True, return_def=True)
    labels = np.random.default_rng(30).integers(0, 8, size=(2, 16, 16, 16, 1))
    if case.startswith('float'):
        labels = labels.astype(np.float32) + .25
    key = jax.random.PRNGKey(4)
    jm = ne.models.labels_to_image((16,) * 3, **kw)
    jout = jax.jit(lambda lab, k: jm.apply({}, lab, key=k))(
        jnp.asarray(labels), key)
    tm = nt.models.labels_to_image((16,) * 3, device='cpu', **kw)
    draws = _jax_v1_draws(key, tm, labels.shape)
    tout = tm.apply(_t(labels), tm.perlin(draws, labels.shape))
    assert set(tout) == {'image', 'map', 'vel', 'def'}
    if tm.warp_std > 0:
        _close(tout['vel'], jout['vel'], 1e-6)
        _close(tout['def'], jout['def'], 1e-5)
    else:
        assert tout['vel'] is None and jout['vel'] is None
        assert tout['def'] is None and jout['def'] is None
    jmap, tmap = np.asarray(jout['map']), tout['map'].numpy()
    assert tmap.shape == jmap.shape and tmap.dtype == jmap.dtype
    mismatch = np.mean(np.any(tmap != jmap, -1))
    assert mismatch < 1e-3, f'{mismatch:.4f} of voxels differ'
    assert tout['image'].shape == jout['image'].shape
    _close_where_maps_agree(tout['image'], jout['image'], tmap, jmap)
    if case.startswith('dict, a label'):
        # labels 0, 5 and 7 are in no output class (classes 4 and 9): their
        # one-hot rows are all zero, as jax.nn.one_hot(-1) gives
        assert tmap.shape[-1] == 2 and (tmap.sum(-1) == 0).any()
        assert set(np.unique(tmap.sum(-1))) == {0., 1.}


def test_labels_to_image_v1_own_draws_and_knobs():
    gen = torch.Generator().manual_seed(1)
    labels = torch.from_numpy(np.random.default_rng(31).integers(
        0, 4, size=(2, 16, 16, 16, 1)))
    tm = nt.models.labels_to_image((16,) * 3, in_label_list=range(4),
                                   out_shape=(12, 12, 12), dc_offset=.1,
                                   return_vel=True, return_def=True,
                                   device='cpu')
    d = tm.draw(labels.shape, gen)
    assert len(d['warp']) == 2 and d['warp'][0][0][1].shape == (1, 1, 1, 3)
    assert d['noise'].shape == (2, 12, 12, 12, 1)
    for name, lo, hi in (('mean', 25, 225), ('std', 5, 25)):
        assert (d[name][..., 0] >= 0).all() and (d[name] < hi).all()
        assert (d[name][..., 1:] >= lo).all()
    assert all(EPS <= float(s) < 1 for s in d['blur'])
    out = tm.apply(labels, tm.perlin(d, labels.shape))
    assert out['image'].shape == (2, 12, 12, 12, 1)
    assert out['vel'].shape == (2, 6, 6, 6, 3)
    assert out['def'].shape == (2, 12, 12, 12, 3)
    assert torch.isfinite(out['image']).all()
    assert out['map'].shape == (2, 12, 12, 12, 4)
    # impl='plain' (the kernels' plain versions) gives the same result here
    plain = nt.models.labels_to_image((16,) * 3, in_label_list=range(4),
                                      out_shape=(12, 12, 12), dc_offset=.1,
                                      impl='plain', device='cpu')
    pout = plain.apply(labels, plain.perlin(d, labels.shape))
    torch.testing.assert_close(pout['image'], out['image'], rtol=0, atol=0)
    # one generator per component; `seeds` pins components
    pinned = nt.models.labels_to_image((16,) * 3, in_label_list=range(4),
                                       seeds={'warp': 5, 'mean': 6},
                                       return_vel=True, device='cpu')
    a = pinned(labels, torch.Generator().manual_seed(1))
    b = pinned(labels, torch.Generator().manual_seed(2))
    c = pinned(labels, 1)
    assert torch.equal(a['vel'], b['vel'])
    assert not torch.equal(a['image'], b['image'])
    assert torch.equal(a['image'], c['image'])
    with pytest.raises(ValueError, match='unknown seeds'):
        nt.models.labels_to_image((16,) * 3, in_label_list=range(4),
                                  seeds={'wrap': 1}, device='cpu')(labels, 0)
    with pytest.raises(ValueError, match='generator'):
        pinned(labels)
    with pytest.raises(ValueError, match='impl'):
        nt.models.labels_to_image((16,) * 3, in_label_list=range(4),
                                  impl='pallas', device='cpu')


###############################################################################
# SynthStrip
###############################################################################

FULL = dict(labels_in=range(16), labels_out={l: 1 for l in range(1, 12)},
            nb_unet_features=[16, 32, 64, 64, 64, 64, 64],
            nb_unet_conv_per_level=2)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_synthstrip_full_width_parameter_tree_matches_jax():
    """FreeSurfer's mri_synthstrip widths in 3-D: the flax tree from
    `jax.eval_shape` (no compute) against the port's, name by name."""
    jm = ne.models.SynthStrip(inshape=(128,) * 3, **FULL)
    lab = jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.int32)
    shapes = jax.eval_shape(lambda k, x: jm.init(
        {'params': k, 'augment': k}, x), jax.random.PRNGKey(0), lab)
    want = {p: tuple(v.shape) for p, v in _leaves(shapes['params']).items()}
    tm = nt.models.SynthStrip(inshape=(128,) * 3, device='cpu', **FULL)
    got = {p: tuple(v.shape) for p, v in
           _leaves(convert.to_flax_params(tm)).items()}
    assert got == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert n == sum(p.numel() for p in tm.parameters()) == 2566145


def _soft_dice(xp, out, axes):
    """examples/synthstrip_training.py's loss: sigmoid soft Dice of channel
    0 against channel 1."""
    pred, truth = out[..., :1], out[..., 1:]
    p = 1 / (1 + xp.exp(-pred))
    top = 2 * (p * truth).sum(axes)
    bot = (p * p).sum(axes) + (truth * truth).sum(axes)
    return -(top / xp.maximum(bot, xp.full_like(bot, 1e-7))).mean()


def test_synthstrip_forward_and_adam_step_match_jax():
    """16^3, three levels: the JAX model's forward and one Adam step on
    its loss, against the port's from the same weights
    (`load_flax_params`) and the same synthesis draws."""
    kw = dict(labels_in=range(6), labels_out=[1, 2], nb_unet_features=8,
              nb_unet_levels=3, nb_unet_conv_per_level=2)
    labels = np.random.default_rng(32).integers(0, 6, size=(1, 16, 16, 16, 1))
    jm = ne.models.SynthStrip(inshape=(16,) * 3, **kw)
    key = jax.random.PRNGKey(5)
    params = jax.jit(jm.init)({'params': jax.random.PRNGKey(0),
                               'augment': key}, jnp.asarray(labels))['params']

    @jax.jit
    def fwd_grad(p):
        def loss(q):
            out = jm.apply({'params': q}, jnp.asarray(labels), key=key,
                           training=True)
            return _soft_dice(jnp, out, (1, 2, 3, 4)), out
        return jax.value_and_grad(loss, has_aux=True)(p)

    (lj, jout), gj = fwd_grad(params)

    tm = nt.models.SynthStrip(inshape=(16,) * 3, device='cpu', **kw)
    convert.load_flax_params(tm, params)
    draws = _jax_v1_draws(key, tm.gen, labels.shape)
    state = training.create_train_state(tm, training.adam(1e-3))
    tout = tm(_t(labels), training=True, draws=draws)
    loss = _soft_dice(torch, tout, (1, 2, 3, 4))
    loss.backward()
    state.optimizer.step()
    tout = tout.detach()

    assert tout.shape == (1, 16, 16, 16, 2)
    np.testing.assert_array_equal(tout[..., 1].numpy(),
                                  np.asarray(jout[..., 1]))
    _close(tout, jout, 1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    gt = _leaves(convert.to_flax_params(tm, grad=True))
    gjl = _leaves(gj)
    assert gt.keys() == gjl.keys()
    for p, g in gt.items():
        # 1e-5 of the tensor's largest gradient: sums over 16^3 voxels in
        # another order
        scale = np.abs(np.asarray(gjl[p])).max()
        np.testing.assert_allclose(g, gjl[p], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg='/'.join(p))
    # Adam from the port's own gradients (see test_torch_training)
    tx = optax.adam(1e-3)

    @jax.jit
    def adam_step(g, q):
        upd, _ = tx.update(g, tx.init(q), q)
        return optax.apply_updates(q, upd)

    want = _leaves(adam_step(
        {'unet': convert.to_flax_params(tm.unet, grad=True)}, params))
    for p, v in _leaves(convert.to_flax_params(tm)).items():
        np.testing.assert_allclose(v, want[p], rtol=1e-6, atol=1e-8,
                                   err_msg='/'.join(p))


def test_synthstrip_train_step_and_defaults_to_the_card(monkeypatch):
    tm = nt.models.SynthStrip(inshape=(16,) * 3, labels_in=range(4),
                              labels_out={1: 1, 2: 1}, nb_unet_features=4,
                              nb_unet_levels=2, device='cpu')
    labels = torch.from_numpy(np.random.default_rng(33).integers(
        0, 4, size=(1, 16, 16, 16, 1)))
    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(
        lambda _, out: _soft_dice(torch, out, (1, 2, 3, 4)))
    losses = []
    for i in range(2):
        state, m = step(state, (labels, labels),
                        training.step_generator(0, i, 'cpu'))
        losses.append(float(m['loss']))
    assert all(np.isfinite(losses)) and state.step == 2
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        nt.models.SynthStrip(inshape=(16,) * 3, labels_in=range(4),
                             labels_out=[1], nb_unet_features=4,
                             nb_unet_levels=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.default_device()
