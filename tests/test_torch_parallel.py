"""
The port's data parallelism (`neurite_tpu_torch.parallel.mesh`, the
`axis_name` of `training.make_train_step` and the stream layers,
`utils.model.robust_multi_gpu`, `callbacks.ModelCheckpointParallel`) over a
real process group: 4 gloo ranks on the CPU, started once for the file
(`tests/torch_ranks.py`), each running every case on seeded numpy inputs.
This process computes the expected values with the JAX package on its 8
virtual CPU devices (`tests/conftest.py`), through `neurite_tpu.parallel`
where the case has a counterpart there, and each test compares one case.
Tolerances: the parity contract's rtol 1e-5 on losses; JAX's own
`tests/test_parallel.py` bounds (rtol 2e-4, atol 2e-6) on parameters after
a step; equal where the same arithmetic runs on every rank.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu import parallel, training  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402

import torch_ranks  # noqa: E402

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

WORLD = 4


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _dp_port_model():
    return nt.models.unet(nb_features=4, input_shape=(16, 16, 16, 1),
                          nb_levels=2, conv_size=3, nb_labels=2,
                          nb_conv_per_level=1, device='cpu',
                          generator=torch.Generator().manual_seed(0))


def _as_flax(out, prefix):
    """A rank's state dict (keys prefix + name) as a flax params tree."""
    model = _dp_port_model()
    model.load_state_dict({k[len(prefix):]: torch.from_numpy(v)
                           for k, v in out.items() if k.startswith(prefix)})
    return convert.to_flax_params(model)


@functools.cache
def _dp_setup():
    """JAX's `tests/test_parallel.py` setup with the port model's weights."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 16, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(8, 16, 16, 16))]
    model = ne.models.unet(nb_features=4, input_shape=(16, 16, 16, 1),
                           nb_levels=2, conv_size=3, nb_labels=2,
                           nb_conv_per_level=1)
    state = training.create_train_state(model, jax.random.PRNGKey(0), x,
                                        optax.sgd(1e-2))
    state = state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, convert.to_flax_params(_dp_port_model())))
    step = training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss)
    return state, step, x, y


@functools.cache
def _jax_dp(data, steps):
    """JAX's DP step over a 'data' mesh: (params after the first step, the
    losses of `steps` calls)."""
    state, step, x, y = _dp_setup()
    mesh = parallel.create_mesh(data=data, space=1)
    run = parallel.make_sharded_train_step(step, mesh, space_axis=None,
                                           donate_state=False)
    batch = parallel.shard_batch((x, y), mesh, space_axis=None)
    losses = []
    for i in range(steps):
        state, m = run(state, batch, jax.random.PRNGKey(i))
        losses.append(float(m['loss']))
        if i == 0:
            first = jax.device_get(state.params)
    return first, losses


@functools.cache
def _mp_setup():
    """tests/test_multiprocess.py's model, weights and global batch."""
    model = ne.models.unet(nb_features=2, input_shape=(8, 8, 1), nb_levels=2,
                           conv_size=3, nb_labels=2)
    state = training.create_train_state(model, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8, 8, 1)),
                                        optax.sgd(1e-2))
    rng = np.random.default_rng(7)
    gx = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    gy = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=(4, 8, 8))]
    return state, gx, gy


@functools.cache
def _c5_setup():
    """Config #5 at 8^3, batch 4 (`test_synth_train_step_data_parallel_
    matches_single_device`'s sizes): JAX's synthesis with the draws it
    returns, and the UNet with the port model's weights."""
    labels = np.random.default_rng(0).integers(0, 4, size=(4, 8, 8, 8, 1))
    gen = ne.models.labels_to_image_new(labels_in=range(4), out_shape=(8,) * 3,
                                        one_hot=True, **torch_ranks.SYNTH_KW)
    jout = jax.jit(lambda lab, k: gen.apply({}, lab, key=k))(
        jnp.asarray(labels), jax.random.PRNGKey(3))
    tm = nt.models.unet(nb_features=2, input_shape=(8, 8, 8, 1), nb_levels=2,
                        conv_size=3, nb_labels=4, device='cpu',
                        generator=torch.Generator().manual_seed(0))
    return labels, jax.device_get(jout), convert.to_flax_params(tm)


class _LCHead(nn.Module):
    @nn.compact
    def __call__(self, x, training=False):
        return ne.layers.LocallyConnected3D(filters=1, kernel_size=3,
                                            padding='same', name='lc_head')(x)


@functools.cache
def _lc_setup():
    """JAX's `test_lc_head_tensor_parallel_weights` inputs and state."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 8, 2)).astype(np.float32)
    y = rng.normal(size=(4, 8, 8, 8, 1)).astype(np.float32)
    state = training.create_train_state(_LCHead(), jax.random.PRNGKey(0), x,
                                        optax.adam(torch_ranks.LC_HEAD_LR))
    return state, x, y


def _inputs():
    _, _, x, y = _dp_setup()
    mp_state, gx, gy = _mp_setup()
    labels, jout, _ = _c5_setup()
    lc_state, lx, ly = _lc_setup()
    inp = {'dp_x': x, 'dp_y': y,
           'mh_x': np.random.default_rng(0).normal(
               size=(8, 6, 6, 1)).astype(np.float32),
           'mp_gx': gx, 'mp_gy': gy,
           'c5_labels': labels,
           'stream_MeanStream': np.random.default_rng(0).normal(
               size=(8, 5)).astype(np.float32),
           'stream_CovStream': np.random.default_rng(1).normal(
               size=(8, 4)).astype(np.float32),
           'lc_kernel': np.asarray(lc_state.params['lc_head']['kernel']),
           'lc_bias': np.asarray(lc_state.params['lc_head']['bias']),
           'lc_x': lx, 'lc_y': ly}
    inp.update({f'c5_{k}': np.asarray(jout[k])
                for k in ('aff', 'vel', 'mean', 'bias')})
    inp.update({'mp_params/' + '/'.join(k): v
                for k, v in _leaves(jax.device_get(mp_state.params)).items()})
    return inp


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return torch_ranks.launch('parallel', WORLD, _inputs(),
                              str(tmp_path_factory.mktemp('parallel')))


def _case(ranks, name, rank=0):
    pre = name + '.'
    return {k[len(pre):]: v for k, v in ranks[rank].items()
            if k.startswith(pre)}


def _close_params(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=2e-4, atol=2e-6,
                                   err_msg='/'.join(k))


@pytest.mark.parametrize('data', [2, 4])
def test_dp_step_matches_jax(ranks, data):
    """The DP step over 2 and 4 ranks against JAX's DP step over a 'data'
    mesh (the single-device step's numbers): loss and parameters; every
    rank of the mesh ends with the same parameters."""
    want_params, want_losses = _jax_dp(data, 3 if data == 4 else 1)
    name = f'dp{data}'
    out = _case(ranks, name)
    assert int(out['local_batch']) == 8 // data
    np.testing.assert_allclose(out['losses'][0], want_losses[0], rtol=1e-5)
    _close_params(_as_flax(out, 'params/'), want_params)
    for r in range(1, data):
        other = _case(ranks, name, r)
        for k, v in out.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    for r in range(data, WORLD):
        assert not _case(ranks, name, r)       # off the mesh: no work


def test_sharded_step_built_once(ranks):
    """3 calls of one wrapper: the gradient hook registered once (JAX's one
    trace for 3 calls), and the 3 losses JAX's."""
    out = _case(ranks, 'dp4')
    assert int(out['calls']) == 3 and int(out['hooks']) == 1
    np.testing.assert_allclose(out['losses'], _jax_dp(4, 3)[1], rtol=1e-5)


def test_robust_multi_gpu_in_a_group_of_4(ranks):
    state, step, x, y = _dp_setup()
    wrapped = ne.utils.model.robust_multi_gpu(step, verbose=False,
                                              space_axis=None,
                                              donate_state=False)
    _, m = wrapped(state, parallel.shard_batch((x, y), wrapped.mesh,
                                               space_axis=None),
                   jax.random.PRNGKey(1))
    for r in range(WORLD):
        out = _case(ranks, 'robust', r)
        assert tuple(out['mesh']) == (WORLD, 1)
        np.testing.assert_allclose(out['loss'], float(m['loss']), rtol=1e-5)


def test_make_train_step_axis_name(ranks):
    """make_train_step(axis_name='data') on each rank's quarter against
    JAX's make_train_step(axis_name='data') under shard_map over 4
    devices: loss and parameters. shard_map runs with check_vma=False,
    pmap's semantics, which the step's pmean is written for: with the vma
    check on, the replicated parameters' gradients arrive summed over the
    axis already, and the pmean then leaves them 4 times the global
    batch's (0.00051 of the parameters after one step; ROADMAP Queue 3)."""
    state, _, x, y = _dp_setup()
    step = training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss, axis_name='data')
    mesh = Mesh(np.asarray(jax.devices()[:4]), ('data',))
    run = jax.jit(shard_map(lambda st, b: step(st, b, jax.random.PRNGKey(1)),
                            mesh=mesh, in_specs=(P(), P('data')),
                            out_specs=(P(), P()), check_vma=False))
    s2, m2 = run(state, (x, y))
    for r in range(WORLD):
        out = _case(ranks, 'train_step_axis', r)
        np.testing.assert_allclose(out['loss'], float(m2['loss']), rtol=1e-5)
        _close_params(_as_flax(out, 'params/'), jax.device_get(s2.params))


def test_shard_batch_multihost_matches_shard_batch(ranks):
    x = np.random.default_rng(0).normal(size=(8, 6, 6, 1)).astype(np.float32)
    for r in range(WORLD):
        out = _case(ranks, 'multihost', r)
        d, s = divmod(r, 2)
        assert bool(out['equal'])
        np.testing.assert_array_equal(out['block'],
                                      x[d * 4:(d + 1) * 4, s * 3:(s + 1) * 3])


def test_two_process_dp_step_matches_jax_single_program(ranks):
    """tests/test_multiprocess.py: 2 ranks fed by shard_batch_multihost
    against the loss of its SINGLE program (a 4-device 'data' mesh)."""
    state, gx, gy = _mp_setup()
    mesh = parallel.create_mesh(data=4)
    step = parallel.make_sharded_train_step(training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss), mesh)
    batch = parallel.shard_batch_multihost((gx, gy), mesh, space_axis=None)
    _, m = step(state, batch, jax.random.PRNGKey(1))
    losses = [float(_case(ranks, 'multiprocess', r)['loss']) for r in (0, 1)]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], float(m['loss']), rtol=1e-5)


def test_config5_dp_step_matches_jax(ranks):
    """Config #5's DP step: the draws made for the global batch of 4, each
    rank applying its slice, against JAX's DP step of the same synthesis
    (rtol 1e-4, as JAX's own config #5 DP test: the nearest label warp
    may break a tie apart)."""
    labels, jout, params = _c5_setup()
    unet = ne.models.unet(nb_features=2, input_shape=(8, 8, 8, 1),
                          nb_levels=2, conv_size=3, nb_labels=4)
    state = training.create_train_state(
        unet, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)),
        optax.adam(1e-3))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    mesh = parallel.create_mesh(data=4, space=1)
    run = parallel.make_sharded_train_step(training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss), mesh,
        space_axis=None)
    _, m = run(state, parallel.shard_batch(
        (jout['image'], jout['map']), mesh, space_axis=None),
        jax.random.PRNGKey(2))
    for r in range(WORLD):
        np.testing.assert_allclose(_case(ranks, 'config5', r)['loss'],
                                   float(m['loss']), rtol=1e-4)


@pytest.mark.parametrize('name', ['MeanStream', 'CovStream'])
def test_stream_axis_name_matches_jax(ranks, name):
    """Each rank's quarter with axis_name='data' against JAX's layer under
    shard_map with axis_name='data' on 4 devices (the global batch)."""
    x = np.random.default_rng(0 if name == 'MeanStream' else 1).normal(
        size=(8, 5 if name == 'MeanStream' else 4)).astype(np.float32)
    layer = getattr(ne.layers, name)(cap=10, axis_name='data')
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), training=True)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ('data',))

    def step(xs):
        _, vs = layer.apply(v, xs, training=True, mutable=['stream_stats'])
        return vs['stream_stats']

    want = jax.jit(shard_map(step, mesh=mesh, in_specs=P('data'),
                             out_specs=P()))(jnp.asarray(x))
    for r in range(WORLD):
        out = _case(ranks, 'stream', r)
        for k, w in want.items():
            np.testing.assert_allclose(out[f'{name}/{k}'], np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        stat = out[f'{name}/{"mean" if name == "MeanStream" else "cov"}']
        scale = min(1., float(out[f'{name}/count'][0]) / 10)
        np.testing.assert_allclose(out[f'{name}/out'][0], scale * stat,
                                   rtol=1e-6)


def test_lc_head_z_sharded_weights_step(ranks):
    """JAX's `test_lc_head_tensor_parallel_weights` on a 2 x 2 mesh: each
    rank holds the z block of the LC head's kernel and bias with Adam
    moments of the block's shape; after one step each block against JAX's
    sharded step (`make_sharded_train_step` with `param_specs`)."""
    state, x, y = _lc_setup()
    step = training.make_train_step(
        lambda t, p: jnp.mean((p - t) ** 2))
    mesh = parallel.create_mesh(data=4, space=2)
    specs = {"['kernel']": P(None, None, 'space'), "['bias']": P('space')}
    run = parallel.make_sharded_train_step(step, mesh, space_axis=1,
                                           donate_state=False,
                                           param_specs=specs)
    s2, m2 = run(state, parallel.shard_batch((x, y), mesh, space_axis=1),
                 jax.random.PRNGKey(1))
    kernel = np.asarray(s2.params['lc_head']['kernel']).reshape(1, 54, 8, 64)
    bias = np.asarray(s2.params['lc_head']['bias'])
    for r in range(WORLD):
        out = _case(ranks, 'lc_head', r)
        z = slice(4 * (r % 2), 4 * (r % 2) + 4)
        assert bool(out['moments_match'])
        assert str(out['placements']) == '(Replicate(), Shard(dim=2))'
        assert out['kernel'].shape == (1, 54, 4, 64)
        np.testing.assert_allclose(out['loss'], float(m2['loss']), rtol=1e-5)
        np.testing.assert_allclose(out['kernel'], kernel[:, :, z], rtol=2e-4,
                                   atol=2e-6)
        np.testing.assert_allclose(out['bias'], bias[z], rtol=2e-4,
                                   atol=2e-6)


def test_space_axis_raises_not_implemented(ranks):
    """GSPMD's whole-model spatial sharding has no torch counterpart: a
    'space' dim of 2 raises, naming the halo route and ROADMAP item 9c."""
    msg = str(_case(ranks, 'space_raises')['message'])
    assert 'space' in msg and 'parallel.halo' in msg and '9c' in msg


def test_model_checkpoint_parallel_writes_on_rank_0_only(ranks):
    for r in range(WORLD):
        assert list(_case(ranks, 'checkpoint', r)['written']) == \
            [True] + [False] * (WORLD - 1)
