"""
The port's whole-model spatial sharding (`parallel.make_sharded_train_step`
on a mesh whose 'space' dim is above 1, `neurite_tpu_torch.parallel.spatial`)
over a real process group: 4 gloo ranks on the CPU, started once for the
file (`tests/torch_ranks.py`, the 'spatial' suite), each running every case
on seeded numpy inputs. This process computes the expected values with the
JAX package's GSPMD steps on its 8 virtual CPU devices
(`neurite_tpu.parallel.make_sharded_train_step` on a 4 x 2 mesh), or with
the port's own single-process step where JAX's step differs by design (the
BatchNorm and dropout of a data-parallel JAX step run over the global
batch). Tolerances are JAX's own `tests/test_parallel.py` ones: rtol 1e-5
on losses (1e-4 for config #5, whose nearest label warp may break a tie
apart), rtol 2e-4 and atol 2e-6 on parameters after a step.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu import parallel, training  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402

import test_torch_parallel as tp  # noqa: E402
import torch_ranks  # noqa: E402

WORLD = 4


@functools.cache
def _jax_spatial(steps=3):
    """JAX's `test_dp_plus_spatial_matches` step on a 4 x 2 mesh (the
    single-device step's numbers): the parameters after the first step and
    the losses of `steps` calls."""
    state, step, x, y = tp._dp_setup()
    mesh = parallel.create_mesh(data=4, space=2)
    run = parallel.make_sharded_train_step(step, mesh, space_axis=1,
                                           donate_state=False)
    batch = parallel.shard_batch((x, y), mesh, space_axis=1)
    losses = []
    for i in range(steps):
        state, m = run(state, batch, jax.random.PRNGKey(i))
        losses.append(float(m['loss']))
        if i == 0:
            first = jax.device_get(state.params)
    return first, losses


@functools.cache
def _jax_lc():
    """JAX's `test_lc_head_tensor_parallel_weights` sharded step: the loss,
    the kernel [1, 54, 512] and bias [8, 8, 8, 1] after it."""
    state, x, y = tp._lc_setup()
    step = training.make_train_step(lambda t, p: jnp.mean((p - t) ** 2))
    mesh = parallel.create_mesh(data=4, space=2)
    specs = {"['kernel']": P(None, None, 'space'), "['bias']": P('space')}
    run = parallel.make_sharded_train_step(step, mesh, space_axis=1,
                                           donate_state=False,
                                           param_specs=specs)
    s2, m2 = run(state, parallel.shard_batch((x, y), mesh, space_axis=1),
                 jax.random.PRNGKey(1))
    return (float(m2['loss']), np.asarray(s2.params['lc_head']['kernel']),
            np.asarray(s2.params['lc_head']['bias']))


def _rs_vol():
    return np.random.default_rng(0).normal(size=(32, 16, 2)).astype(
        np.float32)


def _inputs():
    _, _, x, y = tp._dp_setup()
    labels, jout, _ = tp._c5_setup()
    lc_state, lx, ly = tp._lc_setup()
    inp = {'dp_x': x, 'dp_y': y, 'c5_labels': labels,
           'lc_kernel': np.asarray(lc_state.params['lc_head']['kernel']),
           'lc_bias': np.asarray(lc_state.params['lc_head']['bias']),
           'lc_x': lx, 'lc_y': ly, 'rs_vol': _rs_vol()}
    inp.update({f'c5_{k}': np.asarray(jout[k])
                for k in ('aff', 'vel', 'mean', 'bias')})
    return inp


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return torch_ranks.launch('spatial', WORLD, _inputs(),
                              str(tmp_path_factory.mktemp('spatial')))


def _case(ranks, name, rank=0):
    pre = name + '.'
    return {k[len(pre):]: v for k, v in ranks[rank].items()
            if k.startswith(pre)}


@pytest.mark.parametrize('mesh', ['2x2', '1x4', '1x4y'])
def test_dp_plus_spatial_matches_jax(ranks, mesh):
    """JAX's `test_dp_plus_spatial_matches` on a 2 x 2 and a 1 x 4 mesh
    (z split), and on 1 x 4 with y split (`space_axis=2`): each rank's
    block through the whole UNet (halo convs, block pools, the loss on the
    gathered volume) against JAX's GSPMD step on 4 x 2: the loss and the
    parameters; every rank ends with the same parameters and gathered only
    the loss pair a step, staging nothing on the CPU."""
    data, space = map(int, mesh.rstrip('y').split('x'))
    want_params, want_losses = _jax_spatial()
    name = f'dp{mesh}'
    out = _case(ranks, name)
    block = [8 // data, 16, 16, 16, 1]
    block[2 if mesh.endswith('y') else 1] //= space
    assert tuple(out['block']) == tuple(block)
    np.testing.assert_allclose(out['losses'][0], want_losses[0], rtol=1e-5)
    tp._close_params(tp._as_flax(out, 'params/'), want_params)
    steps = len(out['losses'])
    for r in range(WORLD):
        other = _case(ranks, name, r)
        assert {k: int(v) for k, v in other.items()
                if k.startswith(('gathered/', 'staged/'))} == \
            {'gathered/loss': 2 * steps}
        for k, v in out.items():
            if k.startswith('params/'):
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_spatial_step_built_once(ranks):
    """3 calls of one wrapper at space 2: the step built once (one
    gradient hook), the wrapped step called 3 times, and the 3 losses
    JAX's (`test_sharded_train_step_traces_once`)."""
    out = _case(ranks, 'dp2x2')
    assert int(out['calls']) == 3 and int(out['hooks']) == 1
    np.testing.assert_allclose(out['losses'], _jax_spatial()[1], rtol=1e-5)


def test_batchnorm_and_dropout_match_the_unsharded_step(ranks):
    """A 16^3 UNet with BatchNorm and dropout on a 1 x 4 mesh against the
    port's single-process step on the same batch and generator: the loss,
    every parameter and the running statistics (the blocks' moments summed
    over 'space'; equal generators draw the unsharded dropout masks)."""
    model = nt.models.unet(nb_features=4, input_shape=(16, 16, 16, 1),
                           nb_levels=2, conv_size=3, nb_labels=2,
                           nb_conv_per_level=2, batch_norm=-1,
                           conv_dropout=0.25, device='cpu',
                           generator=torch.Generator().manual_seed(0))
    state = nt.training.create_train_state(
        model, lambda p: torch.optim.SGD(p, lr=1e-2))
    _, _, x, y = tp._dp_setup()
    step = nt.training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    _, m = step(state, (torch.from_numpy(x[:2]), torch.from_numpy(y[:2])),
                torch.Generator().manual_seed(5))
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    for r in range(WORLD):
        out = _case(ranks, 'bn_dropout', r)
        np.testing.assert_allclose(out['loss'], float(m['loss']), rtol=1e-5)
        assert {k[len('state/'):] for k in out if k.startswith('state/')} \
            == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(out[f'state/{k}'], w, rtol=2e-4,
                                       atol=2e-6, err_msg=k)


def test_config5_spatial_step_matches_jax(ranks):
    """Config #5 on a 2 x 2 mesh: the synthesis inside the sharded step
    gathers the labels' z blocks once (the gather rule), fed JAX's draws
    for the rank's items; the loss against JAX's GSPMD step on 4 x 2."""
    labels, jout, params = tp._c5_setup()
    unet = ne.models.unet(nb_features=2, input_shape=(8, 8, 8, 1),
                          nb_levels=2, conv_size=3, nb_labels=4)
    state = training.create_train_state(
        unet, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)),
        optax.adam(1e-3))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    mesh = parallel.create_mesh(data=4, space=2)
    run = parallel.make_sharded_train_step(training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss), mesh)
    _, m = run(state, parallel.shard_batch((jout['image'], jout['map']),
                                           mesh), jax.random.PRNGKey(2))
    for r in range(WORLD):
        out = _case(ranks, 'config5', r)
        np.testing.assert_allclose(out['loss'], float(m['loss']), rtol=1e-4)
        assert int(out['gathered/LabelsToImage']) == 1
        assert int(out['gathered/loss']) == 2


def test_lc_head_split_weights_through_the_step(ranks):
    """JAX's `test_lc_head_tensor_parallel_weights` through
    `make_sharded_train_step` with JAX's `param_specs` on a 2 x 2 mesh:
    each rank holds the z block of the head's kernel (V/2 voxel columns)
    and bias, with Adam moments of the blocks' shapes; after one step the
    loss and each block against JAX's sharded step."""
    loss, kernel, bias = _jax_lc()
    v = kernel.shape[-1]
    for r in range(WORLD):
        out = _case(ranks, 'lc_head', r)
        z = slice(4 * (r % 2), 4 * (r % 2) + 4)
        assert out['kernel'].shape == (1, 54, v // 2)
        assert out['kernel_moments'].tolist() == [[1, 54, v // 2]] * 2
        assert out['bias_moments'].tolist() == [[4, 8, 8, 1]] * 2
        np.testing.assert_allclose(out['loss'], loss, rtol=1e-5)
        np.testing.assert_allclose(
            out['kernel'], kernel.reshape(1, 54, 8, 64)[:, :, z].reshape(
                1, 54, v // 2), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(out['bias'], bias[z], rtol=2e-4,
                                   atol=2e-6)


def test_spatially_sharded_resize(ranks):
    """JAX's `test_spatially_sharded_interpn`: resize by 2 of a volume
    whose axis 0 is split over a 1 x 4 mesh, each rank's block of the
    whole resize (one gather)."""
    want = np.asarray(ne.utils.resize(jnp.asarray(_rs_vol()), [2, 2]))
    for r in range(WORLD):
        out = _case(ranks, 'resize', r)
        np.testing.assert_allclose(out['y'], want[16 * r:16 * (r + 1)],
                                   rtol=1e-5, atol=1e-5)
        assert int(out['gathered/resize']) == 1


def test_unruled_module_and_split_raise(ranks):
    """A model holding a module type with no rule (`LocalBias`, whose
    per-voxel parameters would meet a block) raises NotImplementedError
    naming it; so does a param_specs split of a conv's weight."""
    for r in range(WORLD):
        out = _case(ranks, 'raises', r)
        msg = str(out['unruled'])
        assert "'bias'" in msg and 'LocalBias' in msg and 'no rule' in msg
        msg = str(out['split_conv'])
        assert 'enc.conv_downarm_0_0.weight' in msg


def test_multichip_example_matches_one_process(ranks):
    """`examples_torch/multichip_training.py` on 4 ranks (a 2 x 2 mesh,
    batch 2) against its one-process run (a 1 x 1 mesh, batch 2): the loss
    after 5 Adam steps."""
    import os
    import runpy
    mod = runpy.run_path(os.path.join(torch_ranks.REPO, 'examples_torch',
                                      'multichip_training.py'))
    want = mod['main']('cpu')['loss']
    for r in range(WORLD):
        np.testing.assert_allclose(_case(ranks, 'multichip', r)['loss'],
                                   want, rtol=1e-5)
