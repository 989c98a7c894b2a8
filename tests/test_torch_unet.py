"""
The PyTorch port's UNet (`neurite_tpu_torch.models.unet`) against the flax
UNet of the JAX package: the same parameters (moved by
`neurite_tpu_torch.convert`) and the same numpy input must give the same
prediction, at tiny sizes (16^3, nb_features 4, nb_levels 3, nb_labels 3).

Parameters are drawn by the port, exported to a flax tree whose paths and
shapes must equal `jax.eval_shape(model.init)`'s, and loaded into a second
port model through `load_flax_params`; only `model.apply` is compiled.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402
from neurite_tpu_torch.models.unet import (  # noqa: E402
    Conv, PointwiseConv, _dropout)

torch.set_num_threads(1)

BASE = dict(nb_features=4, nb_levels=3, conv_size=3, nb_labels=3,
            feat_mult=2, nb_conv_per_level=2)
# name -> (constructor overrides, input shape, training, prior)
CONFIGS = {
    'flagship': (dict(), (16, 16, 16, 1), False, False),
    'residuals': (dict(use_residuals=True), (16, 16, 16, 2), False, False),
    'list_of_lists': (dict(nb_features=[[4, 6], [8], [8, 8]], nb_levels=None),
                      (16, 16, 16, 1), False, False),
    'batch_norm': (dict(batch_norm=-1), (16, 16, 16, 1), True, False),
    'add_prior': (dict(add_prior_layer=True), (16, 16, 16, 1), False, True),
    'unet_2d': (dict(), (16, 16, 2), False, False),
    'knobs': (dict(layer_nb_feats=[3, 4, 5, 6, 7, 8, 6, 5, 4, 3],
                   activation='relu', final_pred_activation='sigmoid',
                   conv_impl='native', pool_size=(2, 2, 1), conv_size=(3, 3, 1),
                   dilation_rate_mult=2), (16, 16, 8, 1), False, False),
}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _paths_shapes(tree):
    return {p: tuple(v.shape) for p, v in _flat(tree).items()}


def _leaves(tree):
    return {p: np.asarray(v) for p, v in _flat(tree).items()}


def _assert_trees_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    for p in fa:
        np.testing.assert_array_equal(fa[p], fb[p], err_msg='/'.join(p))


def _models(name, dtype=(None, None)):
    kw, ishape, training, use_prior = CONFIGS[name]
    args = {**BASE, **kw, 'input_shape': ishape}
    jm = ne.models.unet(**args, dtype=dtype[1])
    tm = nt.models.unet(device='cpu', **args, dtype=dtype[0],
                        generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, *ishape)).astype(np.float32)
    prior = None
    if use_prior:
        prior = np.log(rng.dirichlet(np.ones(3), size=(1, *ishape[:-1]))
                       .astype(np.float32))
    return jm, tm, x, prior, training


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_unet_matches_flax(name):
    jm, tm, x, prior, training = _models(name)
    params = convert.to_flax_params(tm)
    stats = convert.to_flax_params(tm, 'batch_stats')
    jargs = (jnp.asarray(x),) + ((jnp.asarray(prior),) if prior is not None
                                 else ())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jargs)
    # the exported tree has exactly flax's paths and shapes
    assert _paths_shapes(params) == _paths_shapes(shapes['params'])
    assert _paths_shapes(stats) == _paths_shapes(shapes.get('batch_stats', {}))

    variables = {'params': params, **({'batch_stats': stats} if stats else {})}
    if training:
        yj, upd = jax.jit(lambda v, *a: jm.apply(
            v, *a, training=True, mutable=['batch_stats']))(variables, *jargs)
    else:
        yj = jax.jit(jm.apply)(variables, *jargs)

    # a second model, drawn from another seed, takes the tree by name
    tm2 = nt.models.unet(device='cpu', **{**BASE, **CONFIGS[name][0],
                            'input_shape': CONFIGS[name][1]},
                         generator=torch.Generator().manual_seed(8))
    convert.load_flax_params(tm2, params, stats or None)
    _assert_trees_equal(convert.to_flax_params(tm2), params)
    targs = (torch.from_numpy(x),) + ((torch.from_numpy(prior),)
                                      if prior is not None else ())
    yt = tm2(*targs, training=training)
    # rtol 1e-5 / atol 1e-6 in f32: the convs sum in another order
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-6)
    if training:
        got = convert.to_flax_params(tm2, 'batch_stats')
        want = _leaves(upd['batch_stats'])
        for p, v in _leaves(got).items():
            # batch mean/var over 4096 voxels in another order
            np.testing.assert_allclose(v, want[p], rtol=1e-5, atol=1e-7,
                                       err_msg='/'.join(p))


def test_unet_bf16_compute_close_to_flax():
    jm, tm, x, _, _ = _models('flagship', (torch.bfloat16, jnp.bfloat16))
    params = convert.to_flax_params(tm)
    yj = jax.jit(jm.apply)({'params': params}, jnp.asarray(x))
    yt = tm(torch.from_numpy(x), training=False)
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    # bf16 keeps 8 significant bits and the two frameworks round at other
    # places; 2e-2 on softmax outputs in [0, 1] still catches a wrong layer
    np.testing.assert_allclose(yt.float().detach().numpy(),
                               np.asarray(yj, np.float32), atol=2e-2)


def test_load_flax_params_round_trips_and_checks_names():
    _, tm, _, _, _ = _models('batch_norm')
    params = convert.to_flax_params(tm)
    stats = convert.to_flax_params(tm, 'batch_stats')
    tm2 = nt.models.unet(device='cpu', **{**BASE, **CONFIGS['batch_norm'][0],
                            'input_shape': (16, 16, 16, 1)},
                         generator=torch.Generator().manual_seed(9))
    convert.load_flax_params(tm2, params, stats)
    _assert_trees_equal(convert.to_flax_params(tm2), params)
    _assert_trees_equal(convert.to_flax_params(tm2, 'batch_stats'), stats)
    k = params['enc']['conv_downarm_0_0']['kernel']
    assert k.shape == (3, 3, 3, 1, 4)
    assert params['dec']['likelihood']['kernel'].shape == (1, 1, 1, 4, 3)
    extra = {**params, 'head': {'kernel': k}}
    with pytest.raises(KeyError, match='head'):
        convert.load_flax_params(tm2, extra)
    missing = {'enc': params['enc']}
    with pytest.raises(KeyError, match='no entry'):
        convert.load_flax_params(tm2, missing)


def test_module_names_layout_and_conv_impl():
    tm = nt.models.unet(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                        use_residuals=True)
    names = dict(tm.named_modules())
    for n in ('enc.conv_downarm_0_0', 'enc.conv_downarm_2_1',
              'enc.expand_down_merge_1', 'dec.conv_uparm_3_0',
              'dec.conv_uparm_4_1', 'dec.likelihood'):
        assert n in names, n
    w = tm.enc.conv_downarm_0_0.weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)
    assert isinstance(tm.dec.likelihood, PointwiseConv)
    # a 1x1x1 conv is a matmul under 'auto' and a conv under 'native'
    for impl, cls in (('auto', PointwiseConv), ('native', Conv)):
        m = nt.models.unet(device='cpu', **{**BASE, 'conv_size': 1},
                           input_shape=(8, 8, 8, 1), conv_impl=impl)
        assert isinstance(m.enc.conv_downarm_0_0, cls)
    # space_to_depth=2 folds 2^3 voxels into the first conv's inputs and
    # 3 * 2^3 head outputs back into 3 labels; remat keeps the modules
    m = nt.models.unet(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                       space_to_depth=2)
    assert m.enc.conv_downarm_0_0.weight.shape[1] == 8
    assert m.dec.likelihood.weight.shape == (4, 3 * 8)
    assert m(torch.zeros(1, 8, 8, 8, 1)).shape == (1, 8, 8, 8, 3)
    m = nt.models.unet(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                       remat=True)
    assert dict(m.named_modules()).keys() == dict(
        nt.models.unet(device='cpu', **BASE,
                       input_shape=(8, 8, 8, 1)).named_modules()).keys()


def test_same_seed_same_weights_and_constructors():
    a = nt.models.unet(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                       generator=torch.Generator().manual_seed(3))
    b = nt.models.dilation_net(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                               generator=torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert b.enc.conv_downarm_1_0.dilation == 2
    x = torch.zeros(2, 8, 8, 8, 1)
    enc = nt.models.conv_enc(4, (8, 8, 8, 1), 3, 3, feat_mult=2,
                             device='cpu')
    z, skips = enc(x)
    assert z.shape == (2, 2, 2, 2, 16)
    assert [s.shape[-1] for s in skips] == enc.skip_channels == [4, 8, 16]
    dec = nt.models.conv_dec(4, (2, 2, 2, 16), 3, 3, 5, feat_mult=2,
                             device='cpu', use_skip_connections=True,
                             skip_channels=enc.skip_channels)
    y = dec(z, skips)
    assert y.shape == (2, 8, 8, 8, 5)
    torch.testing.assert_close(y.sum(-1), torch.ones(2, 8, 8, 8))
    head = nt.models.add_prior(use_logp=False, final_pred_activation='linear')
    assert head(torch.zeros(1, 3), torch.ones(1, 3)).eq(.5).all()


def test_feature_dropout_broadcasts_over_space():
    x = torch.ones(2, 4, 4, 4, 6)
    g = torch.Generator().manual_seed(0)
    y = _dropout(x, .5, True, g, 3)
    # one keep/drop draw per (batch, channel), scaled by 1/keep
    assert set(torch.unique(y).tolist()) <= {0., 2.}
    assert torch.equal(y, y[:, :1, :1, :1, :].expand_as(y))
    y2 = _dropout(x, .5, True, torch.Generator().manual_seed(0), 3)
    assert torch.equal(y, y2)
    assert _dropout(x, .5, False, None, 3) is x
    with pytest.raises(ValueError, match='Generator'):
        _dropout(x, .5, True, None, 3)
    m = nt.models.unet(device='cpu', **BASE, input_shape=(8, 8, 8, 1),
                       conv_dropout=.3)
    out = m(torch.ones(1, 8, 8, 8, 1), training=True,
            generator=torch.Generator().manual_seed(1))
    assert out.shape == (1, 8, 8, 8, 3) and torch.isfinite(out).all()
