"""
The PyTorch port's model IO (`modelio`), model utilities (`utils.model`),
callbacks (through `training.fit`) and host helpers (`py.utils`,
`py.plot`) against the JAX package's.

A directory saved by one package loads in the other: JAX's `save_model`
into the port's `load_model`, the port's `save_model` into JAX's
`load_variables`; their models then agree within 1e-5 (float32). The
module paths of `module_paths`, `sub_apply` and `mod_submodel` are the same
strings in both packages, and the taps they give agree within 1e-5.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.py import utils as jpyutils  # noqa: E402
from neurite_tpu.utils import model as jmodel  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import callbacks, convert, modelio  # noqa: E402
from neurite_tpu_torch import training  # noqa: E402
from neurite_tpu_torch.py import utils as pyutils  # noqa: E402
from neurite_tpu_torch.utils import model as tmodel  # noqa: E402

torch.set_num_threads(1)

UNET = dict(nb_features=4, input_shape=(8, 8, 8, 1), nb_levels=3,
            conv_size=3, nb_labels=3, feat_mult=2, nb_conv_per_level=2)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _jax_unet(**kw):
    jm = ne.models.unet(**UNET, **kw)
    x = _normal(0, (1, 8, 8, 8, 1))
    return jm, jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), x


###############################################################################
# modelio
###############################################################################

def test_jax_saved_model_loads_into_the_port(tmp_path):
    jm, variables, x = _jax_unet(batch_norm=-1)
    cfg = dict(UNET, batch_norm=-1, builder='neurite_tpu.models.unet.unet',
               metadata={})
    ne.modelio.save_model(str(tmp_path), cfg, variables, step=7)
    tm = nt.modelio.load_model(str(tmp_path), device='cpu')
    assert isinstance(tm, nt.models.UNet)
    tm.eval()
    _close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)))
    assert nt.modelio.load_config(str(tmp_path))['metadata'] == {'step': 7}
    assert nt.modelio.load_train_state(str(tmp_path)) is None
    # JAX's pickled optax state needs JAX to read
    ne.modelio.save_model(str(tmp_path), cfg, variables, opt_state={})
    with pytest.raises(ValueError, match='optax'):
        nt.modelio.load_train_state(str(tmp_path))


def test_port_saved_model_loads_into_jax(tmp_path):
    build = nt.modelio.store_config_args(nt.models.unet)
    tm = build(**UNET, batch_norm=-1, dtype=torch.bfloat16, device='cpu',
               generator=torch.Generator().manual_seed(5))
    x = _normal(1, (2, 8, 8, 8, 1))
    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    y = np.eye(3, dtype=np.float32)[(x[..., 0] > 0).astype(int)]
    state, _ = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    nt.modelio.save_model(str(tmp_path), tm, train_state=state,
                          extra={'epoch': 1})

    cfg = json.load(open(os.path.join(tmp_path, 'config.json')))['config']
    assert cfg['builder'] == 'neurite_tpu_torch.models.unet.unet'
    assert cfg['dtype'] == 'torch.bfloat16'
    assert 'device' not in cfg and 'generator' not in cfg
    # JAX reads the variables: params and batch_stats by flax path
    jv = ne.modelio.load_variables(str(tmp_path))
    assert set(jv) == {'params', 'batch_stats'}
    jm = ne.models.unet(**UNET, batch_norm=-1, dtype=jnp.bfloat16)
    tm.eval()
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).float()
    got = jm.apply(jv, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got.astype(jnp.float32)),
                               want.numpy(), rtol=0, atol=2e-2)

    # and the port rebuilds it, with its dtype, weights and train state
    back = nt.modelio.load_model(str(tmp_path), device='cpu')
    assert back.dec.likelihood.dtype == torch.bfloat16
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), n
    ts = nt.modelio.load_train_state(str(tmp_path))
    assert ts['step'] == 1 and ts['extra'] == {'epoch': 1}
    opt = training.adam(1e-3)(back.parameters())
    opt.load_state_dict(ts['optimizer'])
    assert opt.state_dict()['state'][0]['step'] == 1


def test_stream_stats_round_trip(tmp_path):
    m = nt.layers.CovStream((3,), cap=4, device='cpu')
    m(torch.from_numpy(_normal(2, (5, 3))), training=True)
    nt.modelio.save_model(str(tmp_path), m, config={'input_shape': [3]})
    jv = ne.modelio.load_variables(str(tmp_path))
    assert set(jv) == {'stream_stats'}
    back = nt.layers.CovStream((3,), cap=4, device='cpu')
    modelio._load_into(back, nt.modelio.load_variables(str(tmp_path)))
    for name in ('mean', 'cov', 'count'):
        assert torch.equal(getattr(back, name), getattr(m, name))


class _Loadable(nt.modelio.LoadableModel):
    @nt.modelio.store_config_args
    def __init__(self, nb_features=4, nb_labels=3, device=None):
        super().__init__()
        self.net = nt.models.unet(**dict(UNET, nb_features=nb_features,
                                         nb_labels=nb_labels), device=device,
                                  generator=torch.Generator().manual_seed(9))

    def forward(self, x, training=None):
        return self.net(x, training=training)


def test_loadable_model(tmp_path):
    m = _Loadable(nb_labels=2, device='cpu')
    assert m.get_config()['nb_labels'] == 2
    with torch.no_grad():
        m.net.dec.likelihood.bias.fill_(.25)
    m.metadata = {'note': 'x'}
    m.save(str(tmp_path))
    back = _Loadable.load(str(tmp_path), device='cpu')
    assert back.metadata == {'note': 'x'}
    assert back.get_config()['nb_labels'] == 2
    x = torch.from_numpy(_normal(3, (1, 8, 8, 8, 1)))
    assert torch.equal(back(x), m(x))
    with pytest.raises(ValueError, match='no captured config'):
        nt.modelio.save_model(str(tmp_path),
                              nt.models.unet(**UNET, device='cpu'))


###############################################################################
# utils.model
###############################################################################

def _port_unet_of(variables):
    tm = nt.models.unet(**UNET, device='cpu')
    convert.load_flax_params(tm, variables['params'])
    return tm.eval()


def test_module_paths_are_the_flax_paths():
    jm, variables, x = _jax_unet()
    want = jmodel.module_paths(jm, jax.random.PRNGKey(3), x)
    tm = _port_unet_of(variables)
    assert tmodel.module_paths(tm, torch.from_numpy(x)) == want
    assert 'enc/conv_downarm_1_0' in want and 'dec/likelihood' in want


def test_sub_apply_and_mod_submodel_vs_jax():
    jm, variables, x = _jax_unet()
    tm = _port_unet_of(variables)
    tx = torch.from_numpy(x)
    path = 'enc/conv_downarm_1_0'
    _close(tmodel.sub_apply(tm, tx, until=path),
           jmodel.sub_apply(jm, variables, x, until=path))
    taps = tmodel.sub_apply(tm, tx, until=[path, 'dec/likelihood'])
    jtaps = jmodel.sub_apply(jm, variables, x, until=[path, 'dec/likelihood'])
    assert taps.keys() == jtaps.keys()
    for k in taps:
        _close(taps[k], jtaps[k])
    # inject: the module does not run, downstream sees the value
    z = _normal(4, (1, 4, 4, 4, 8))
    got = tmodel.sub_apply(tm, tx, inject={path: torch.from_numpy(z)})
    want = jmodel.sub_apply(jm, variables, x, inject={path: jnp.asarray(z)})
    _close(got, want)
    fn = tmodel.mod_submodel(tm, tx, from_layer=path,
                             to_layer='dec/conv_uparm_3_0')
    jfn = jmodel.mod_submodel(jm, variables, x, from_layer=path,
                              to_layer='dec/conv_uparm_3_0')
    _close(fn(torch.from_numpy(z)), jfn(jnp.asarray(z)))
    _close(tmodel.mod_submodel(tm, tx)(), jm.apply(variables, x))
    assert type(tm.enc.conv_downarm_1_0).forward is \
        tm.enc.conv_downarm_1_0.forward.__func__   # forward put back
    with pytest.raises(KeyError, match='not found'):
        tmodel.sub_apply(tm, tx, until='enc/nope')


def test_weight_utilities():
    jm, variables, x = _jax_unet()
    tm = _port_unet_of(variables)
    assert tmodel.param_count(tm) == jmodel.param_count(variables['params'])
    assert tmodel.param_count(convert.to_flax_params(tm)) == \
        tmodel.param_count(tm)
    # reset with seed 5 = built from seed 5
    fresh = nt.models.unet(**UNET, device='cpu',
                           generator=torch.Generator().manual_seed(5))
    tmodel.reset_weights(tm, torch.Generator().manual_seed(5))
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    # by name and shape: the 2-label head keeps tm's own weights
    other = nt.models.unet(**dict(UNET, nb_labels=2), device='cpu')
    head = tm.dec.likelihood.weight.clone()
    tmodel.copy_weights(other, tm)
    assert torch.equal(tm.enc.conv_downarm_0_0.weight,
                       other.enc.conv_downarm_0_0.weight)
    assert torch.equal(tm.dec.likelihood.weight, head)
    text = tmodel.diagram(tm, torch.from_numpy(x))
    assert 'enc/conv_downarm_0_0' in text and 'dec/likelihood' in text
    assert f'total parameters: {tmodel.param_count(tm)}' in text
    step = training.make_train_step(nt.losses.SoftDice().loss)
    assert tmodel.robust_multi_gpu(step, verbose=False) is step
    stacked = tmodel.stack_models([tm, lambda y: y.sum(-1)])
    _close(stacked(torch.from_numpy(x)), np.ones((1, 8, 8, 8), np.float32))


###############################################################################
# callbacks through fit
###############################################################################

def _fit(cbs, nb_steps=4, lr=3e-3):
    tm = nt.models.unet(**UNET, device='cpu')
    state = training.create_train_state(tm, training.adam(lr))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    x = _normal(6, (1, 8, 8, 8, 1))
    y = np.eye(3, dtype=np.float32)[(x[..., 0] > 0).astype(int)]
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    return training.fit(state, step, iter([batch] * nb_steps), nb_steps,
                        callbacks=cbs), batch


def test_callbacks_through_fit(tmp_path):
    wc = callbacks.ModelWeightCheck(weight_diff=True)
    trend = callbacks.CheckLossTrend(loss_window=2)
    th = callbacks.TimeHistory()
    lr = callbacks.LRLog()
    lrs = callbacks.LRLog(schedule=lambda s: 1e-3 / (1 + s))
    ck = callbacks.ModelCheckpoint(str(tmp_path / 'ck_{step}'), at_batch_end=2,
                                   config=dict(UNET))
    best = callbacks.ModelCheckpointParallel(
        str(tmp_path / 'best'), save_best_only=True, at_batch_end=1,
        config=dict(UNET))
    (state, history), _ = _fit([wc, trend, th, lr, ck, best, lrs])
    assert len(th.times) == 4 and all(t > 0 for t in th.times)
    assert all(h['lr'] == 1e-3 / (1 + i + 1) for i, h in enumerate(history))
    assert history[1]['max_diff'] > 0
    assert sorted(os.listdir(tmp_path)) == ['best', 'ck_2', 'ck_4']
    back = nt.modelio.load_model(str(tmp_path / 'ck_4'),
                                 builder=nt.models.unet, device='cpu')
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), n
    assert nt.modelio.load_train_state(str(tmp_path / 'ck_4'))['step'] == 4
    losses = [h['loss'] for h in history]
    assert nt.modelio.load_config(str(tmp_path / 'best'))['metadata'][
        'step'] == 1 + int(np.argmin(losses))
    with torch.no_grad():
        next(state.model.parameters())[0] = float('nan')
    with pytest.raises(FloatingPointError, match='nan'):
        wc.on_train_end(state)
    with pytest.raises(ValueError, match='much higher'):
        t = callbacks.CheckLossTrend(loss_window=2)
        for i, v in enumerate([1., 1., 1000.]):
            t.on_batch_end(i, logs={'loss': v})


def _dice(y_true, y_pred):
    """Per-label soft Dice of one batch."""
    top = 2 * (y_true * y_pred).sum((0, 1, 2, 3))
    return top / (y_true + y_pred).sum((0, 1, 2, 3)).clamp_min(1e-7)


def test_predict_metrics_and_plot_through_fit(tmp_path):
    (_, _), batch = _fit([], nb_steps=1)
    pm = callbacks.PredictMetrics(None, [_dice], iter([batch] * 4), 2, 3,
                                  at_batch_end=1)
    csv = callbacks.PredictMetrics(str(tmp_path / '{metric}_{step}.csv'),
                                   [_dice], iter([batch] * 2), 2, 3)
    (state, history), _ = _fit([pm, csv], nb_steps=2)
    assert state.model.training    # back in training mode after each run
    state.model.eval()
    with torch.no_grad():
        want = _dice(batch[1], state.model(batch[0])).numpy()
    np.testing.assert_allclose(
        [history[-1][f'_dice_label_{i}'] for i in range(3)], want, rtol=1e-6)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / '_dice_2.csv', delimiter=','),
        np.stack([want, want]), rtol=1e-5)

    pytest.importorskip('matplotlib')
    plot = callbacks.PlotTestSlices(str(tmp_path / 'slices_{step}.png'),
                                    iter([batch]), (8, 8, 8), at_batch_end=2)
    _fit([plot], nb_steps=2)
    assert os.path.getsize(tmp_path / 'slices_2.png') > 0


###############################################################################
# py.utils and py.plot
###############################################################################

LUT = """# a FreeSurfer-style lookup table
0   Unknown            0   0   0   0
2   Left-WM          245 245 245   0

17  Left-Hippocampus 220 216  20   0
"""


def test_py_utils_vs_jax(tmp_path, monkeypatch):
    monkeypatch.delenv('NEURITE_BACKEND', raising=False)
    assert pyutils.get_backend() == 'torch'
    monkeypatch.setenv('NEURITE_BACKEND', 'pytorch')
    assert pyutils.get_backend() == 'pytorch'
    x = _normal(7, (3, 4))
    np.testing.assert_array_equal(pyutils.softmax(x, 1),
                                  jpyutils.softmax(x, 1))
    labels = np.array([3, 7, 7, 2, 9])
    for g, w in zip(pyutils.rebase_lab(labels), jpyutils.rebase_lab(labels)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match='non-integer'):
        pyutils.rebase_lab([1.5])
    path = tmp_path / 'lut.txt'
    path.write_text(LUT)
    lut = pyutils.load_fs_lut(str(path))
    assert lut == jpyutils.load_fs_lut(str(path))
    assert lut[17] == {'name': 'Left-Hippocampus', 'color': [220, 216, 20]}
    seg = np.array([[0, 2], [17, 5]])
    np.testing.assert_array_equal(pyutils.seg_to_rgb_fs_lut(seg, lut),
                                  jpyutils.seg_to_rgb_fs_lut(seg, lut))
    pytest.importorskip('matplotlib')
    np.testing.assert_array_equal(pyutils.fs_lut_to_cmap(str(path)).colors,
                                  jpyutils.fs_lut_to_cmap(str(path)).colors)


def test_py_plot_agg():
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from neurite_tpu_torch import plot

    fig, axs = plot.slices([_normal(8, (6, 5)), _normal(9, (6, 5))],
                           titles=['a', 'b'], do_colorbars=True, grid=True,
                           show=False)
    assert axs.shape == (1, 2)
    plt.close(fig)
    fig, axs = plot.volume3D(_normal(10, (6, 5, 4)), show=False)
    assert axs.shape == (1, 3)
    plt.close(fig)
    fig, axs = plot.flow([_normal(11, (5, 5, 2))], show=False)
    plt.close(fig)
    with pytest.raises(ValueError, match='2d or RGB'):
        plot.slices([_normal(12, (2, 3, 4))], show=False)
