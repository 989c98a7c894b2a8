"""
The port's explicit spatial sharding (`neurite_tpu_torch.parallel.halo`)
over a real process group: 4 gloo ranks on the CPU, started once for the
file (`tests/torch_ranks.py`), each holding its z block of the cases of
JAX's `tests/test_halo.py`, at their sizes. This process computes the
expected values with `neurite_tpu.parallel.halo` on its 8 virtual CPU
devices (a 2 x 4 mesh, as there; a 1 x 4 and a 1 x 2 one for the warps);
each rank's block must match the same rows of JAX's global result. On the
CPU the ops run the port's plain versions (K3, K4, K6 and K7-K9 are held
against them on the card by `chip_smoke.py` phase 29). Tolerances: JAX's
own, 1e-5 on values and 1e-4 on gradients that sum in another order.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from neurite_tpu import parallel  # noqa: E402
from neurite_tpu.parallel.halo import halo_exchange  # noqa: E402
from neurite_tpu.utils import core  # noqa: E402

import torch_ranks  # noqa: E402

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

WORLD = 4
KS = (3, 3, 3)


@functools.cache
def _inputs():
    rng = np.random.default_rng(3)

    def normal(*shape, scale=1.):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def uniform(lo, hi, *shape):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    return {
        'halo_x': normal(2, 16, 4, 1), 'halo_g': normal(2, 32, 4, 1),
        'conv2_x': normal(2, 16, 12, 3), 'conv2_k': normal(5, 3, 3, 4),
        'conv2_g': normal(2, 16, 12, 4),
        'conv3_x': normal(2, 8, 6, 6, 2), 'conv3_k': normal(3, 3, 3, 2, 3),
        'conv3_g': normal(2, 8, 6, 6, 3),
        'blur_x': normal(2, 16, 8, 1), 'blur3_x': normal(2, 16, 6, 5, 2),
        'blur_k0': np.asarray(core.gaussian_kernel(1.5, separate=True)),
        'blur_k1': np.asarray(core.gaussian_kernel(0.8, separate=True)),
        'dice_x': uniform(0, 1, 2, 16, 4, 3),
        'dice_y': uniform(0, 1, 2, 16, 4, 3),
        'warp_a_vol': normal(2, 16, 8, 8),
        'warp_a_shift': uniform(-2., 2., 2, 16, 8, 8, 3),
        'warp_tie_shift': np.concatenate(
            [rng.integers(-4, 4, size=(2, 16, 8, 8, 1)) + .5,
             uniform(-2., 2., 2, 16, 8, 8, 2)], -1).astype(np.float32),
        'warp_b_vol': normal(1, 12, 8, 8, 2),
        'warp_b_shift': uniform(-3., 3., 1, 12, 8, 8, 3),
        'lc_tap_x': normal(2, 16, 6, 6, 3),
        'lc_tap_k': normal(1, 81, 16, 36, scale=.1),
        'lc_tap_g': normal(2, 16, 6, 6, 1),
        'lc_pallas_x': normal(1, 16, 8, 8, 2),
        'lc_pallas_k': normal(1, 54, 16, 64, scale=.1),
        'lc_pallas_g': normal(1, 16, 8, 8, 1),
    }


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    return torch_ranks.launch('halo', WORLD, _inputs(),
                              str(tmp_path_factory.mktemp('halo')))


@pytest.fixture(scope='module')
def mesh():
    return parallel.create_mesh(data=2, space=4)


def _case(ranks, name, rank):
    pre = name + '.'
    return {k[len(pre):]: v for k, v in ranks[rank].items()
            if k.startswith(pre)}


def _block(a, rank, n=WORLD, axis=1):
    a = np.asarray(a)
    size = a.shape[axis] // n
    return np.take(a, range(rank * size, (rank + 1) * size), axis=axis)


def _value_and_vjp(f, g, *args):
    """f(*args) and its vjp with cotangent g, in one jitted program (op by
    op, the shard_map transposes take minutes on the CPU)."""
    def run(g, *args):
        y, vjp = jax.vjp(f, *args)
        return (y, *vjp(g))
    return jax.jit(run)(jnp.asarray(g), *map(jnp.asarray, args))


def _close(got, want, rank, n=WORLD, axis=1, atol=1e-5):
    np.testing.assert_allclose(got, _block(want, rank, n, axis), rtol=1e-5,
                               atol=atol)


@pytest.mark.parametrize('boundary', ['zero', 'edge'])
def test_halo_exchange_boundary_modes(ranks, mesh, boundary):
    """Each rank's padded block (8 rows: 2 + 4 + 2) is JAX's shard of the
    shard_map output, and its gradient JAX's: the halo rows' gradients
    travel back to the ranks that sent them."""
    x, g = _inputs()['halo_x'], _inputs()['halo_g']
    f = shard_map(lambda t: halo_exchange(t, 2, 1, boundary=boundary),
                  mesh=mesh, in_specs=P(None, 'space'),
                  out_specs=P(None, 'space'))
    y, dx = _value_and_vjp(f, g, x)
    for r in range(WORLD):
        out = _case(ranks, 'halo_modes', r)
        np.testing.assert_array_equal(out[f'{boundary}/y'], _block(y, r))
        _close(out[f'{boundary}/dx'], dx, r)
        assert out['too_wide'] == 'halo 5 exceeds local extent 4'
    if boundary == 'zero':
        np.testing.assert_array_equal(_case(ranks, 'halo_modes', 0)
                                      ['zero/y'][:, :2], 0.)


@pytest.mark.parametrize('nd', [2, 3])
def test_sharded_conv_matches_jax(ranks, mesh, nd):
    """2-D (a 5 x 3 kernel) and 3-D SAME convs; dx per block, and the
    kernel's gradient as the sum of the ranks' shares."""
    inp = _inputs()
    x, k, g = (jnp.asarray(inp[f'conv{nd}_{n}']) for n in 'xkg')
    y, dx, dk = _value_and_vjp(lambda a, b: parallel.sharded_conv(a, b, mesh),
                               g, x, k)
    dks = 0.
    for r in range(WORLD):
        out = _case(ranks, 'conv', r)
        _close(out[f'{nd}d/y'], y, r)
        _close(out[f'{nd}d/dx'], dx, r, atol=1e-4)
        dks = dks + out[f'{nd}d/dk']
    np.testing.assert_allclose(dks, np.asarray(dk), rtol=1e-4, atol=1e-4)


def test_sharded_conv_rejects_even_kernel(ranks):
    for r in range(WORLD):
        assert 'even kernel size' in str(_case(ranks, 'conv', r)['even'])


def test_sharded_blur_matches_jax(ranks, mesh):
    """2-D with the 9- and 5-tap Gaussians of JAX's test, 3-D with 9, 5, 5
    (the plain per-axis convs here); a 11-tap kernel needs a halo of 5,
    more than the 4-row block, and raises as JAX asserts."""
    inp = _inputs()
    ks = [inp['blur_k0'], inp['blur_k1']]
    y2 = parallel.sharded_separable_blur(jnp.asarray(inp['blur_x']), ks, mesh)
    y3 = parallel.sharded_separable_blur(jnp.asarray(inp['blur3_x']),
                                         ks + [inp['blur_k1']], mesh)
    for r in range(WORLD):
        out = _case(ranks, 'blur_dice', r)
        _close(out['blur2'], y2, r)
        _close(out['blur3'], y3, r)
        assert out['too_wide'] == 'halo 5 exceeds local extent 4'


def test_sharded_dice_sums_matches_jax(ranks, mesh):
    inp = _inputs()
    want = parallel.sharded_dice_sums(jnp.asarray(inp['dice_x']),
                                      jnp.asarray(inp['dice_y']), mesh)
    for r in range(WORLD):
        out = _case(ranks, 'blur_dice', r)
        for i, w in enumerate(want):
            np.testing.assert_allclose(out[f'dice{i}'], np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_sharded_bounded_warp_matches_jax(ranks, method):
    """4 blocks of [2, 16, 8, 8] under shifts within +-2 (max_disp 3, fill
    0) against JAX's sharded one-hot warp on a 1 x 4 mesh."""
    inp = _inputs()
    want = jax.jit(lambda v, s: parallel.sharded_bounded_warp(
        v, s, parallel.create_mesh(data=1, space=4), max_disp=3.0,
        interp_method=method, fill_value=0.))(inp['warp_a_vol'],
                                              inp['warp_a_shift'])
    for r in range(WORLD):
        _close(_case(ranks, 'warp', r)[f'a/{method}'], want, r)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_sharded_bounded_warp_equals_unsharded_at_ties(ranks, method):
    """z shifts on half-integers, where nearest rounds half to even: each
    block equal to the unsharded warp's rows (`spatial.batch_transform`),
    since the port rounds before it makes z local and makes it local by an
    exact subtraction (JAX's sharded warp rounds the local coordinate, so
    an odd offset turns a tie the other way; ROADMAP Queue 3). 2 blocks of
    8 rows, a halo of 5: the second block's offset is 3."""
    for r in range(2):
        assert bool(_case(ranks, 'warp', r)[f'exact/{method}'])


def test_sharded_bounded_warp_channels_and_big_z_shift(ranks):
    """2 blocks of [1, 12, 8, 8, 2] whose z shifts up to 3 cross the block
    edge (max_disp 4: a halo of 5 of the 6-row block)."""
    inp = _inputs()
    want = jax.jit(lambda v, s: parallel.sharded_bounded_warp(
        v, s, parallel.create_mesh(data=1, space=2), max_disp=4.0,
        fill_value=0.))(inp['warp_b_vol'], inp['warp_b_shift'])
    for r in range(2):
        _close(_case(ranks, 'warp', r)['b'], want, r, n=2)
    for r in range(2, WORLD):
        assert 'b' not in _case(ranks, 'warp', r)


@pytest.mark.parametrize('impl', ['tap', 'pallas'])
def test_sharded_lc_matches_jax(ranks, mesh, impl):
    """sharded_lc's forward, dx and dk per block against JAX's
    `sharded_lc` with the same impl (the Pallas kernels in interpret mode,
    as JAX's test runs them): dk lands on the rank that owns the weights,
    dx's halo rows come back from the neighbours."""
    inp = _inputs()
    x, k, g = (jnp.asarray(inp[f'lc_{impl}_{n}']) for n in 'xkg')
    y, dx, dk = _value_and_vjp(lambda a, b: parallel.sharded_lc(
        a, b, KS, mesh, impl=impl, interpret=impl == 'pallas'), g, x, k)
    for r in range(WORLD):
        out = _case(ranks, 'lc', r)
        _close(out[f'{impl}/y'], y, r)
        _close(out[f'{impl}/dx'], dx, r, atol=1e-4)
        _close(out[f'{impl}/dk'], dk, r, axis=2, atol=1e-4)
