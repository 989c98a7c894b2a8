"""
The PyTorch port's auto-encoder path (`layers.random.RandomClip` and
`SampleNormalLogVar`, `layers.basic`, `models.ae`, `utils.vae`) against the
JAX package's.

JAX keys and torch generators draw different numbers, so the random layers
are fed the JAX run's draws (recomputed from its keys), and the VAEs the
JAX run's sample noise (recovered from its sown mu, log-var and sample).
Weights and BatchNorm statistics go across by `convert.load_flax_params`.
Tolerances: 1e-5 in float32 (outputs absolute, gradients of each tensor's
largest magnitude), 1e-6 for the elementwise layers.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.layers import basic as jbasic  # noqa: E402
from neurite_tpu.layers import random as jrandom  # noqa: E402
from neurite_tpu.utils import vae as jvae  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402
from neurite_tpu_torch.layers import basic as tbasic  # noqa: E402
from neurite_tpu_torch.layers import random as trandom  # noqa: E402
from neurite_tpu_torch.py.utils import normalize_axes  # noqa: E402
from neurite_tpu_torch.utils import vae as tvae  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _normal(seed, shape, scale=1.):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


###############################################################################
# layers
###############################################################################

def _jax_clip_draws(key, layer, shape):
    """RandomClip's draws from `key`, in the port's layout."""
    axes = normalize_axes(layer.axes, shape, none_means_all=False)
    shape = tuple(shape[i] if i in axes else 1 for i in range(len(shape)))
    out = {}
    for k, (side, bounds, prob) in zip(jax.random.split(key), layer.sides):
        if bounds is None or prob == 0:
            out[side] = (None, None)
            continue
        k_val, k_bit = jax.random.split(k)
        val = (None if np.isscalar(bounds) else _t(jax.random.uniform(
            k_val, shape, minval=bounds[0], maxval=bounds[1])))
        gate = _t(jax.random.uniform(k_bit, shape)) if prob < 1 else None
        out[side] = (val, gate)
    return out


@pytest.mark.parametrize('kw', [
    dict(clip_min=(-1., .5), clip_max=(1., 2.), prob_min=.5, prob_max=1),
    dict(clip_min=-.5, prob_min=.3, axes=(0, -1)),
    dict(clip_min=(-2., -1.), clip_max=.7, prob_max=.5, axes=None),
    dict(clip_max=(0., 1.), prob_min=0, prob_max=0),
    dict(clip_min=(-1., 0.), clip_max=(0., 1.), prob_min=0, axes=1),
])
def test_random_clip_given_jax_draws(kw):
    x = _normal(40, (4, 6, 7, 2), 2.)
    key = jax.random.PRNGKey(8)
    want = jrandom.RandomClip(**kw).apply({}, jnp.asarray(x), key=key)
    layer = trandom.RandomClip(**kw)
    got = layer.apply(_t(x), None if layer._off() else
                      _jax_clip_draws(key, layer, x.shape))
    _close(got, want, 0)
    # the port's own draws: thresholds in their bounds, gates by prob
    out = layer(_t(x), torch.Generator().manual_seed(0))
    assert out.shape == x.shape
    if kw.get('prob_min', 1) == kw.get('prob_max', 1) == 0:
        assert torch.equal(out, _t(x))
    lo, hi = kw.get('clip_min'), kw.get('clip_max')
    if isinstance(hi, tuple) and kw.get('prob_max', 1) == 1:
        assert float(out.max()) < hi[1]


def test_random_clip_checks_probabilities():
    with pytest.raises(ValueError, match='probability'):
        trandom.RandomClip(clip_min=0., prob_min=1.5)
    with pytest.raises(ValueError, match='Generator'):
        trandom.RandomClip(clip_min=(0., 1.))(torch.zeros(2, 3))


@pytest.mark.parametrize('dtype', [np.float32, 'bfloat16'])
def test_sample_normal_log_var_given_jax_noise(dtype):
    mu, lv = _normal(41, (2, 4, 4, 3)), _normal(42, (2, 4, 4, 3), .5)
    key = jax.random.PRNGKey(9)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    want = jrandom.SampleNormalLogVar().apply(
        {}, [jnp.asarray(mu, jdt), jnp.asarray(lv, jdt)], key=key)
    noise = _t(jax.random.normal(key, mu.shape, jnp.float32))
    layer = trandom.SampleNormalLogVar()
    got = layer.apply([_t(mu).to(tdt), _t(lv).to(tdt)], noise)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-6)
    z = layer([_t(mu).to(tdt), _t(lv).to(tdt)],
              torch.Generator().manual_seed(0))
    assert z.dtype == torch.float32 and z.shape == mu.shape


@pytest.mark.parametrize('zoom,method', [(2, 'linear'), ([.5, 2.], 'linear'),
                                         ([2, 1.5], 'nearest')])
def test_resize_zoom_matches_jax(zoom, method):
    x = _normal(43, (2, 6, 8, 3))
    want = jbasic.Resize(zoom_factor=zoom, interp_method=method).apply(
        {}, jnp.asarray(x))
    _close(tbasic.Resize(zoom, method)(_t(x)), want, 1e-6)
    _close(tbasic.Zoom(zoom, method)([_t(x)]), want, 1e-6)
    with pytest.raises(ValueError, match='zoom factor length'):
        tbasic.Resize([2, 2, 2])(_t(x))


def test_elementwise_layers_match_jax():
    x, y = _normal(44, (3, 5, 6, 2)), _normal(45, (3, 5, 6, 2))
    _close(tbasic.Negate()(_t(x)), jbasic.Negate().apply({}, x), 0)
    _close(tbasic.RescaleValues(2.5)(_t(x)),
           jbasic.RescaleValues(resize=2.5).apply({}, x), 1e-6)
    _close(tbasic.MSE()([_t(x), _t(y)]),
           jbasic.MSE().apply({}, [jnp.asarray(x), jnp.asarray(y)]), 1e-6)
    for kw in (dict(), dict(alpha=3., nb_bins=5, min_clip=-1., max_clip=1.),
               dict(bin_centers=[-1., 0., .5, 2.])):
        want = jbasic.SoftQuantize(**kw).apply({}, jnp.asarray(x))
        _close(tbasic.SoftQuantize(**kw)(_t(x)), want, 1e-6)
    assert nt.layers.Zoom is nt.layers.Resize


###############################################################################
# auto-encoders
###############################################################################

AE_CASES = {   # builder(models, **device) and the input shape
    'single dense vae bn shift': (
        lambda m, **d: m.single_ae([5], (4, 4, 4, 2), do_vae=True,
                                   include_mu_shift_layer=True, **d),
        (4, 4, 4, 2)),
    'single conv vae resize': (
        lambda m, **d: m.single_ae((2, 2, 2, 3), (4, 4, 4, 2),
                                   ae_type='conv', conv_size=3,
                                   activation='elu', do_vae=True, **d),
        (4, 4, 4, 2)),
    'single conv same size, no enc feats': (
        lambda m, **d: m.single_ae((4, 4, 4, None), (4, 4, 4, 2),
                                   ae_type='conv', conv_size=3,
                                   batch_norm=None, do_vae=True, **d),
        (4, 4, 4, 2)),
    'ae conv vae': (
        lambda m, **d: m.ae(nb_features=4, input_shape=(8, 8, 8, 1),
                            nb_levels=2, conv_size=3, nb_labels=1,
                            enc_size=(2, 2, 2, 4), feat_mult=2, do_vae=True,
                            final_pred_activation='linear', **d),
        (8, 8, 8, 1)),
}


def _grads_close(tm, gj):
    """The port's parameter gradients against JAX's: within 1e-5 of each
    tensor's largest. A gradient that is zero in exact arithmetic (a bias
    that BatchNorm follows, a parameter the mode does not use) is rounding
    noise or 0 in both: at most 1e-6 of the model's largest."""
    gt, gjl = _leaves(convert.to_flax_params(tm, grad=True)), _leaves(gj)
    assert gt.keys() == gjl.keys()
    top = max(np.abs(g).max() for g in gjl.values())
    for path, g in gt.items():
        want = gjl[path]
        if np.abs(want).max() <= 1e-6 * top:
            assert np.abs(g).max() <= 1e-6 * top, path
        else:
            _close(g, want, 1e-5 * np.abs(want).max())


def _backward(tm, loss):
    """loss.backward() into zeroed gradients of every parameter (those the
    mode does not reach stay 0, as JAX's are)."""
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    loss.backward()


@pytest.mark.parametrize('case', list(AE_CASES))
def test_autoencoder_modes_and_grads_match_jax(case):
    """Each mode's forward and parameter gradients from the same weights
    and the same sample noise: 'full' in training mode (BatchNorm's batch
    and running statistics), then 'encode' and 'decode' in eval mode."""
    make, shape = AE_CASES[case]
    jm = make(ne.models)
    x = _normal(46, (4, *shape))    # batch 4: BatchNorm's batch statistics
    variables = jax.jit(jm.init)({'params': jax.random.PRNGKey(0),
                                  'sample': jax.random.PRNGKey(1)},
                                 jnp.asarray(x))
    params = variables['params']
    stats = variables.get('batch_stats')
    key = jax.random.PRNGKey(2)

    @jax.jit
    def full(p):
        def loss(q):
            out, state = jm.apply(
                {'params': q, **({'batch_stats': stats} if stats else {})},
                jnp.asarray(x), training=True, rngs={'sample': key},
                mutable=['batch_stats', 'intermediates'])
            return jnp.mean(jnp.square(out - x)), (out, state)
        return jax.value_and_grad(loss, has_aux=True)(p)

    (lj, (jout, jstate)), gj = full(params)
    inter = jvae.flatten_intermediates(jstate['intermediates'])
    noise = ((inter['ae_sample'] - inter['ae_mu'])
             / jnp.exp(inter['ae_sigma'] / 2))

    tm = make(nt.models, device='cpu')
    convert.load_flax_params(tm, params, stats)
    tout, tinter = tm(_t(x), training=True, noise=_t(noise),
                      return_intermediates=True)
    loss = torch.mean(torch.square(tout - _t(x)))
    _backward(tm, loss)
    for k in ('ae_mu', 'ae_sigma', 'ae_sample'):
        _close(tinter[k], inter[k])
    _close(tout, jout)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    _grads_close(tm, gj)
    if stats:   # the running statistics of the training-mode call
        for path, v in _leaves(convert.to_flax_params(
                tm, 'batch_stats')).items():
            _close(v, _leaves(jstate['batch_stats'])[path])

    # 'encode' (the sample, from the same noise) and 'decode', eval mode
    # with the running statistics that the training-mode call updated;
    # each with the gradients of the sum of its output's squares
    dec_kw = ({'enc_shape': tm.enc_shape} if hasattr(tm, 'enc_shape')
              else {'out_shape': shape})
    jstats = {'batch_stats': jstate['batch_stats']} if stats else {}

    @jax.jit
    def enc_dec(p):
        def enc(q):
            z = jm.apply({'params': q, **jstats}, jnp.asarray(x),
                         mode='encode', rngs={'sample': key})
            return jnp.sum(jnp.square(z)), z

        def dec(q, z):
            y = jm.apply({'params': q, **jstats}, z, mode='decode', **dec_kw)
            return jnp.sum(jnp.square(y)), y
        (_, z), gz = jax.value_and_grad(enc, has_aux=True)(p)
        (_, y), gy = jax.value_and_grad(dec, has_aux=True)(p, z)
        return z, gz, y, gy

    z, gz, y, gy = enc_dec(params)
    tm.eval()
    tz = tm(_t(x), mode='encode', noise=_t(noise))
    _backward(tm, torch.sum(torch.square(tz)))
    _close(tz, z)
    _grads_close(tm, gz)
    ty = tm(_t(z), mode='decode', **dec_kw)
    _backward(tm, torch.sum(torch.square(ty)))
    _close(ty, y)
    _grads_close(tm, gy)
    with pytest.raises(ValueError, match='mode'):
        tm(_t(x), mode='sample')


def _leaves(tree, leaf=np.asarray, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, leaf, prefix + (k,)))
        else:
            out[prefix + (k,)] = leaf(v)
    return out


def test_config4_vae_tree_parts_and_dtypes():
    """bench.py's vae_rate model (config #4) at its full widths: the flax
    tree from `jax.eval_shape` (no compute) against the port's, 228,593
    parameters; and at 32^3 its parts and dtypes: a bfloat16 encoder, a
    float32 latent and decoder."""
    kw = dict(nb_features=8, nb_levels=4, conv_size=3, nb_labels=1,
              ae_type='conv', do_vae=True, feat_mult=2, single_model=True,
              final_pred_activation='linear')
    jm = ne.models.ae(input_shape=(128,) * 3 + (1,), enc_size=(8, 8, 8, 16),
                      dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(lambda k, x: jm.init(
        {'params': k, 'sample': k}, x), jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 128, 128, 128, 1), jnp.float32))
    want = {p: tuple(v) for p, v in
            _leaves(shapes['params'], np.shape).items()}
    tm = nt.models.ae(input_shape=(128,) * 3 + (1,), enc_size=(8, 8, 8, 16),
                      dtype=torch.bfloat16, device='cpu', **kw)
    got = {p: v.shape for p, v in _leaves(convert.to_flax_params(tm)).items()}
    assert got == want
    assert sum(p.numel() for p in tm.parameters()) == 228593
    assert tm.enc_shape == (16, 16, 16, 64)

    small = nt.models.ae(input_shape=(32,) * 3 + (1,), enc_size=(2, 2, 2, 16),
                         dtype=torch.bfloat16, device='cpu', **kw)
    x = torch.from_numpy(_normal(47, (1, 32, 32, 32, 1)))
    (out, mid, enc), inter = small(x, return_parts=True,
                                   generator=torch.Generator().manual_seed(0),
                                   return_intermediates=True)
    assert enc.dtype == torch.bfloat16 and enc.shape == (1, 4, 4, 4, 64)
    assert mid.dtype == out.dtype == torch.float32
    assert inter['ae_sample'].shape == (1, 2, 2, 2, 16)
    assert inter['ae_sample'].dtype == torch.float32


###############################################################################
# utils.vae
###############################################################################

def _tiny(do_vae):
    kw = dict(nb_features=4, input_shape=(8, 8, 1), nb_levels=2, conv_size=3,
              nb_labels=1, enc_size=[5], ae_type='dense',
              final_pred_activation='linear', do_vae=do_vae)
    jm = ne.models.ae(**kw)
    x = _normal(48, (4, 8, 8, 1))
    variables = jax.jit(jm.init)({'params': jax.random.PRNGKey(0),
                                  'sample': jax.random.PRNGKey(1)},
                                 jnp.asarray(x))
    tm = nt.models.ae(device='cpu', **kw)
    convert.load_flax_params(tm, variables['params'])
    return jm, variables, tm, x


def test_vae_utils_match_jax():
    jm, variables, tm, x = _tiny(do_vae=False)
    assert tvae.enc_output_shape(tm, x) == tuple(
        jvae.enc_output_shape(jm, variables, x)) == (4, 4, 4)
    jdec, jz_shape = jvae.extract_z_dec(jm, variables, x)
    tdec, tz_shape = tvae.extract_z_dec(tm, x)
    assert tz_shape == tuple(jz_shape) == (5,)
    z = _normal(49, (3, 5))
    _close(tdec(_t(z)), jdec(jnp.asarray(z)))
    _close(tvae.z_effect(tdec, _t(z)), jvae.z_effect(jdec, jnp.asarray(z)))
    _close(tvae.z_effect(tdec, _t(z), portion=.5),
           jvae.z_effect(jdec, jnp.asarray(z), portion=.5))
    tout, tzs = tvae.sample_dec(tdec, tz_shape, nb_samples=4, sweep_dim=2,
                                device='cpu')
    jout, jzs = jvae.sample_dec(jdec, jz_shape, nb_samples=4, sweep_dim=2)
    _close(tzs, jzs, 0)
    _close(tout, jout)
    out, zr = tvae.sample_dec(tdec, tz_shape, nb_samples=3, seed=1,
                              device='cpu')
    assert out.shape == (3, 8, 8, 1) and zr.shape == (3, 5)
    _close(tvae.sweep_dec_given_x(tm, tdec, x[:1], x[1:2], nb_steps=4)[0],
           jvae.sweep_dec_given_x(jm, variables, jdec, x[:1], x[1:2],
                                  nb_steps=4)[0])
    # PCA: the same activations give the same weights; end to end, the mu
    # kernel holds orthonormal axes
    acts = _normal(50, (16, 64))
    paths = (('mid', 'ae_mu_enc_dense'), ('mid', 'ae_dense_dec'))
    jnew = jvae.pca_init_dense_from_acts(variables, acts, *paths)
    tvae.pca_init_dense_from_acts(tm, acts, *paths)
    for path, v in _leaves(convert.to_flax_params(tm)).items():
        _close(v, _leaves(jnew['params'])[path], 1e-6)
    xb = _normal(51, (16, 8, 8, 1))
    tvae.pca_init_dense(tm, xb)
    k = tm.mid.ae_mu_enc_dense.kernel.detach().numpy()
    np.testing.assert_allclose(k.T @ k, np.eye(5), atol=1e-4)
    # model_output_pca of the same function
    fn = lambda v: v * 2.   # noqa: E731
    got = tvae.model_output_pca(fn, itertools.repeat(xb), 2, 3,
                                device='cpu')
    want = jvae.model_output_pca(fn, itertools.repeat(xb), 2, 3)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_vae_latent_stats_and_plots():
    jm, variables, tm, x = _tiny(do_vae=True)
    tstats = tvae.latent_stats(tm, itertools.repeat(x), nb_batches=2)
    jstats = jvae.latent_stats(jm, variables, itertools.repeat(x),
                               nb_batches=2)
    assert tstats['mu'].shape == tstats['logvar'].shape == (8, 5)
    _close(tstats['mu'], jstats['mu'])
    _close(tstats['logvar'], jstats['logvar'])
    assert tvae.flatten_intermediates({'a': {'ae_mu': (1, 2)}}) == \
        {'ae_mu': 2}
    import matplotlib
    matplotlib.use('Agg')
    fig, axes = tvae.latent_stats_plots(tstats)
    assert len(axes) == 3
    import matplotlib.pyplot as plt
    plt.close(fig)
