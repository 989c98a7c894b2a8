"""
The JAX package's TPU-engine exports that the port keeps as aliases
(`ops.interpn_cube`, `interpn_rows`, `interpn_shear_onehot`,
`block_spread_ok`, `shear_bound`, `shear_window_disp`, `conv_im2col`,
`conv_z2d`) against the JAX functions, inside each engine's contract; and
the keyword gaps closed beside them: `ops.dice_sums(interpret=True)`,
`training.make_train_step(has_aux_vars, rng_names, axis_name)` and
`training.fit(rng, jit)`.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import training  # noqa: E402

torch.set_num_threads(1)


def _grid(shape):
    return np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing='ij'), -1).astype(np.float32)


@pytest.mark.parametrize('fill', [None, 0.5])
@pytest.mark.parametrize('channels', [0, 2])
def test_interpn_cube_and_rows(fill, channels):
    rng = np.random.default_rng(0)
    shape = (6, 7, 5)
    vol = rng.normal(size=shape + ((channels,) if channels else ())) \
        .astype(np.float32)
    loc = _grid(shape) + rng.uniform(-2, 2, size=shape + (3,)) \
        .astype(np.float32)
    for name in ('interpn_cube', 'interpn_rows'):
        want = np.asarray(jax.jit(getattr(ne.ops, name), static_argnums=2)(
            vol, loc, 'linear', fill))
        got = getattr(nt.ops, name)(torch.from_numpy(vol),
                                    torch.from_numpy(loc), 'linear', fill)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        nt.ops.interpn_cube(torch.from_numpy(vol), torch.from_numpy(loc),
                            'nearest')


def test_interpn_cube_two_d():
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(9, 8)).astype(np.float32)
    loc = _grid((9, 8)) + rng.uniform(-1, 1, size=(9, 8, 2)).astype(np.float32)
    want = np.asarray(ne.ops.interpn_cube(vol, loc))
    got = nt.ops.interpn_cube(torch.from_numpy(vol), torch.from_numpy(loc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_interpn_shear_onehot_within_its_window():
    """Nearest taps of a small rotation plus a residual within max_disp:
    the JAX engine is exact there, as the alias is everywhere."""
    rng = np.random.default_rng(2)
    shape = (8, 8, 16)
    vol = rng.normal(size=(1,) + shape + (2,)).astype(np.float32)
    th = np.deg2rad(4.)
    mat = np.eye(4, dtype=np.float32)
    mat[0, 0] = mat[2, 2] = np.cos(th)
    mat[0, 2], mat[2, 0] = np.sin(th), -np.sin(th)
    ctr = (np.asarray(shape) - 1) / 2
    g = _grid(shape)
    loc = ((g - ctr) @ mat[:3, :3].T + ctr
           + rng.uniform(-.4, .4, size=shape + (3,)))[None].astype(np.float32)
    want = np.asarray(ne.ops.interpn_shear_onehot(
        vol, mat[None], loc, max_disp=8.0, fill_value=0.))
    got = nt.ops.interpn_shear_onehot(torch.from_numpy(vol),
                                      torch.from_numpy(mat[None]),
                                      torch.from_numpy(loc), fill_value=0.)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
@pytest.mark.parametrize('amp', [1., 6.])
@pytest.mark.parametrize('block,pad', [((8, 8), 5), ((4, 4, 8), 2)])
def test_block_spread_ok(method, amp, block, pad):
    rng = np.random.default_rng(3)
    shape = (12, 10, 16)
    loc = (_grid(shape) + rng.uniform(-amp, amp, size=shape + (3,)))[None] \
        .astype(np.float32)
    want = bool(ne.ops.block_spread_ok(loc, shape, method, block, pad))
    got = nt.ops.block_spread_ok(torch.from_numpy(loc), shape, method, block,
                                 pad)
    assert got.dtype == torch.bool and got.ndim == 0
    assert bool(got) == want
    assert bool(nt.ops.block_spread_ok(loc, shape, method, block, pad)) == want


@pytest.mark.parametrize('args', [(10., .1, .1), (60., .6, .3), (0., 0., 0.)])
def test_shear_host_arithmetic(args):
    assert nt.ops.shear_bound(*args) == ne.ops.shear_bound(*args)
    for block, dense in (((8, 8), 2.), ((4, 16), 0.)):
        assert nt.ops.shear_window_disp(block, *args, dense) == \
            ne.ops.shear_window_disp(block, *args, dense)


@pytest.mark.parametrize('ks', [(3, 3, 3), (2, 3, 4), (1, 1, 1)])
@pytest.mark.parametrize('bias', [False, True])
def test_conv_aliases(ks, bias):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 7, 5, 3)).astype(np.float32)
    k = rng.normal(size=ks + (3, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32) if bias else None
    tb = None if b is None else torch.from_numpy(b)
    for name in ('conv_im2col', 'conv_z2d'):
        want = np.asarray(jax.jit(getattr(ne.ops, name))(x, k, b))
        got = getattr(nt.ops, name)(torch.from_numpy(x), torch.from_numpy(k),
                                    tb)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_conv_im2col_two_d_and_dtype():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 9, 8, 2)).astype(np.float32)
    k = rng.normal(size=(3, 2, 2, 5)).astype(np.float32)
    want = np.asarray(ne.ops.conv_im2col(x, k))
    got = nt.ops.conv_im2col(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the kernel is cast to the input's dtype, as in JAX
    got16 = nt.ops.conv_im2col(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(k))
    assert got16.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        nt.ops.conv_z2d(torch.from_numpy(x), torch.from_numpy(k))


def test_dice_sums_interpret_takes_the_plain_version(monkeypatch):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 50, 3)).astype(np.float32))
    y = torch.from_numpy(rng.random((2, 50, 3)).astype(np.float32))
    from neurite_tpu_torch.ops import dice_red
    calls = []
    plain = dice_red._dice_sums_plain
    monkeypatch.setattr(dice_red, '_dice_sums_plain',
                        lambda *a: calls.append(1) or plain(*a))
    got = nt.ops.dice_sums(x, y, impl='kernel', interpret=True)
    assert calls
    want = ne.ops.dice_sums(x.numpy(), y.numpy(), impl='pallas',
                            interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _small_model(seed):
    return nt.models.unet(nb_features=2, input_shape=(8, 8, 8, 1),
                          nb_levels=2, conv_size=3, nb_labels=2,
                          conv_dropout=.3, device='cpu',
                          generator=torch.Generator().manual_seed(seed))


def test_make_train_step_keywords():
    loss = nt.losses.SoftDice().loss
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 8, 1)).astype(np.float32))
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 2, size=(1, 8, 8, 8))), 2).float()
    # axis_name names a dim of the process's mesh: a name the mesh lacks
    # raises at the step; on the one-process 1 x 1 mesh the mean over
    # 'data' is the identity (the gloo ranks: tests/test_torch_parallel.py)
    nt.parallel.create_mesh(device='cpu')
    state = training.create_train_state(_small_model(0), training.adam(1e-3))
    with pytest.raises(ValueError, match="no mesh axis 'batch'"):
        training.make_train_step(loss, axis_name='batch')(
            state, (x, y), torch.Generator().manual_seed(3))
    losses = []
    for kw in ({}, dict(has_aux_vars=True, rng_names=('dropout', 'noise')),
               dict(axis_name='data')):
        state = training.create_train_state(_small_model(0),
                                            training.adam(1e-3))
        step = training.make_train_step(loss, **kw)
        _, m = step(state, (x, y), torch.Generator().manual_seed(3))
        losses.append(float(m['loss']))
    assert losses[0] == losses[1] == losses[2]


def test_fit_rng_is_an_integer_seed():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 8, 1)).astype(np.float32))
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 2, size=(1, 8, 8, 8))), 2).float()
    step = training.make_train_step(nt.losses.SoftDice().loss)
    runs = []
    for kw in (dict(seed=5), dict(rng=5, jit=False), dict(rng=6)):
        state = training.create_train_state(_small_model(1),
                                            training.adam(1e-3))
        _, hist = training.fit(state, step, iter([(x, y)] * 2), 2,
                               callbacks=[object()], **kw)
        runs.append([h['loss'] for h in hist])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    # JAX's positional order: rng fifth
    state = training.create_train_state(_small_model(1), training.adam(1e-3))
    _, hist = training.fit(state, step, iter([(x, y)] * 2), 2, 5, [object()])
    assert [h['loss'] for h in hist] == runs[0]
