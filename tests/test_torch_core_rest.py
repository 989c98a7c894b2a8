"""
The rest of the PyTorch port's `utils.core` (device setup, map_fn_axis,
grids, take, barycenter, the activation functions, whiten, perlin_vol, the
FFT and complex helpers, batch_gather, space_to_depth) and the six FFT and
complex layers of `layers.basic`, against the JAX package's.

`perlin_vol` is fed the JAX run's draws, recomputed from its keys.
Tolerances: 1e-6 for elementwise float32 functions and sums over a few
hundred values, 1e-5 for the FFTs (another summation order), 0 where the
function only moves values.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.layers import basic as jbasic  # noqa: E402
from neurite_tpu.utils import core as jcore  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.layers import basic as tbasic  # noqa: E402
from neurite_tpu_torch.utils import core as tcore  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    got = got.detach() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _normal(seed, shape, scale=1.):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def test_utils_exports_what_the_jax_package_exports():
    names = set(jcore.__all__) - {'as_key'}
    assert not [n for n in names if not hasattr(nt.utils, n)]
    for n in ('volshape_to_ndgrid', 'ndgrid', 'meshgrid', 'flatten',
              'subsample_axis', 'sub2ind2d', 'prod_n', 'transform',
              'draw_perlin', 'random_blur_rescale', 'draw_perlin_full',
              'draw_crop_mask'):
        assert hasattr(nt.utils, n), n


def test_setup_device_needs_a_card():
    if torch.cuda.is_available():
        devs = tcore.setup_device()
        assert devs and all(d.type == 'cuda' for d in devs)
        assert tcore.setup_device('0') == [torch.device('cuda', 0)]
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tcore.setup_device()


@pytest.mark.parametrize('case', ['tensor', 'tensor_neg', 'rank_reducing',
                                  'tuple_out', 'list_in'])
def test_map_fn_axis(case):
    x = _normal(1, (3, 4, 5))
    y = _normal(2, (5, 4))
    fn, elems, axis = {
        'tensor': (lambda v: v * 2 + 1, x, 1),
        'tensor_neg': (lambda v: v ** 2, x, -1),
        'rank_reducing': (lambda v: v.sum(), x, 2),
        'tuple_out': (lambda v: (v + 1, v * 3), x, 0),
        'list_in': (lambda v: v[0] * v[1], [x, y], [1, 1]),
    }[case]
    if isinstance(elems, list):
        want = jcore.map_fn_axis(fn, [jnp.asarray(e) for e in elems], axis)
        got = tcore.map_fn_axis(fn, [_t(e) for e in elems], axis)
    else:
        want = jcore.map_fn_axis(fn, jnp.asarray(elems), axis)
        got = tcore.map_fn_axis(fn, _t(elems), axis)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        pairs = zip(got, want)
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert tuple(g.shape) == w.shape
        # elementwise, and sums of 5 values
        _close(g, w, 1e-6)
    with pytest.raises(ValueError, match='list'):
        tcore.map_fn_axis(fn, _t(x), [0, 1])


def test_meshgrids_take_and_batch_gather():
    for a, b in zip(tcore.volshape_to_meshgrid((3, 4, 2), device='cpu'),
                    jcore.volshape_to_meshgrid((3, 4, 2))):
        assert a.dtype == torch.int32
        _close(a, b, 0)
    with pytest.raises(ValueError, match='integers'):
        tcore.volshape_to_meshgrid((3, 4.5), device='cpu')
    x = _normal(3, (4, 5, 6))
    for idx, axis in (([0, 3, 1], 1), (np.array([[1, -1], [0, 2]]), 0),
                      ([-5, 4, 5, 9, -6], 1), (2, -1)):
        want = jcore.take(jnp.asarray(x), jnp.asarray(idx), axis)
        got = tcore.take(_t(x), idx, axis)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xi = np.arange(20, dtype=np.int32).reshape(4, 5)
    np.testing.assert_array_equal(
        tcore.take(_t(xi), [1, 7, -1], 1).numpy(),
        np.asarray(jcore.take(jnp.asarray(xi), jnp.asarray([1, 7, -1]), 1)))
    ref = _normal(4, (3, 7, 2))
    ind = np.array([[0, 6, 2], [1, 1, -1], [5, 4, 3]])
    np.testing.assert_array_equal(
        tcore.batch_gather(_t(ref), _t(ind)).numpy(),
        np.asarray(jcore.batch_gather(jnp.asarray(ref), jnp.asarray(ind))))


@pytest.mark.parametrize('kw', [
    dict(), dict(axes=(1, 2)), dict(normalize=True),
    dict(shift_center=True, axes=(0, 2)), dict(zero=True),
])
def test_barycenter(kw):
    x = np.abs(_normal(5, (3, 6, 7)))
    if kw.pop('zero', False):
        x[1] = 0
        kw = dict(axes=(1, 2))
    want = jcore.barycenter(jnp.asarray(x), **kw)
    got = tcore.barycenter(_t(x), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # sums of a few hundred float32 products in another order
    _close(got, want, 1e-5)
    if 'axes' in kw and x[1].sum() == 0:
        assert float(got[1].abs().max()) == 0


@pytest.mark.parametrize('name,kw', [
    ('softmax', dict()), ('softmax', dict(axis=1, alpha=3.)),
    ('logtanh', dict(a=2.)), ('arcsinh', dict(alpha=.5)),
    ('sigmoid', dict()), ('logistic_fixed_ends', dict()),
    ('logistic_fixed_ends', dict(start=-2., end=3., L=2., alpha=2.)),
    ('sigmoid_fixed_ends', dict(start=5., end=9.)),
    ('soft_round', dict()), ('soft_round', dict(alpha=5)),
    ('odd_shifted_relu', dict()), ('odd_shifted_relu', dict(shift=.3,
                                                           scale=1.5)),
    ('whiten', dict()), ('whiten', dict(mean=2., std=.5)),
])
def test_activation_zoo(name, kw):
    x = _normal(6, (4, 5, 3), 3.)
    want = getattr(jcore, name)(jnp.asarray(x), **kw)
    got = getattr(tcore, name)(_t(x), **kw)
    assert got.dtype == torch.float32
    # elementwise float32 (whiten: a mean and std over 60 values)
    _close(got, want, 1e-6 * max(1., float(np.abs(want).max())))


@pytest.mark.parametrize('kw', [
    dict(), dict(wt_type='random'), dict(min_scale=1, max_scale=3),
    dict(interp_method='nearest', wt_type='random', max_scale=2),
])
def test_perlin_vol_given_jax_draws(kw):
    shape = (9, 12, 5)
    key = jax.random.PRNGKey(4)
    want = jcore.perlin_vol(shape, seed=key, **kw)
    # the JAX run's draws (`utils/core.py:716-733`): weights from keys[j],
    # every scale's volume from keys[n_scales]
    min_scale = kw.get('min_scale', 0)
    max_scale = kw.get('max_scale', int(np.ceil(np.log2(max(shape)))))
    n = max_scale + 1 - min_scale
    keys = jax.random.split(key, n + 1)
    if kw.get('wt_type') == 'random':
        wts = _t(np.stack([jax.random.uniform(keys[j], ()) for j in range(n)]))
    else:
        wts = torch.arange(min_scale + 1, max_scale + 2, dtype=torch.float32)
    vols = [_t(jax.random.uniform(keys[n], tuple(int(s) for s in np.ceil(
        [f / 2 ** i for f in shape])))) for i in range(min_scale,
                                                        max_scale + 1)]
    got = tcore.perlin_vol_from_draws(
        shape, (wts, vols), kw.get('interp_method', 'linear'))
    _close(got, want, 1e-6)
    # the port's own draws: the same shapes, weights and range
    own_w, own_v = tcore.draw_perlin_vol(
        shape, min_scale, kw.get('max_scale'), kw.get('wt_type', 'monotonic'),
        seed=0, device='cpu')
    assert [tuple(v.shape) for v in own_v] == [tuple(v.shape) for v in vols]
    if kw.get('wt_type') != 'random':
        assert torch.equal(own_w, wts)
    out = tcore.perlin_vol(shape, seed=0, device='cpu', **kw)
    assert tuple(out.shape) == shape
    assert 0 <= float(out.min()) and float(out.max()) < 1
    with pytest.raises(ValueError, match='wt_type'):
        tcore.perlin_vol(shape, wt_type='flat', seed=0, device='cpu')


@pytest.mark.parametrize('axes', [None, 1, (0, 2), -1])
def test_fft_helpers(axes):
    x = _normal(7, (4, 6, 5))
    xc = (x + 1j * _normal(8, (4, 6, 5))).astype(np.complex64)
    for inp in (x, xc):
        want = jcore.fftn(jnp.asarray(inp), axes=axes)
        got = tcore.fftn(_t(inp), axes=axes)
        assert got.dtype == torch.complex64
        # sums of up to 120 terms in another order
        _close(got, want, 1e-5)
        _close(tcore.ifftn(_t(inp), axes=axes),
               jcore.ifftn(jnp.asarray(inp), axes=axes), 1e-5)
        for name in ('fftshift', 'ifftshift'):
            _close(getattr(tcore, name)(_t(inp), axes=axes),
                   getattr(jcore, name)(jnp.asarray(inp), axes=axes), 0)
    ch = tcore.complex_to_channels(_t(xc))
    _close(ch, jcore.complex_to_channels(jnp.asarray(xc)), 0)
    xe = x[..., :4]
    for inp in (xe, xe.astype(np.float64), xe.astype(np.float16)):
        want = jcore.channels_to_complex(jnp.asarray(inp))
        got = tcore.channels_to_complex(_t(inp))
        # float64 stays float64 (JAX runs here without x64: complex64)
        assert got.dtype == (torch.complex128 if inp.dtype == np.float64
                             else torch.complex64)
        _close(got, want, 0)
    with pytest.raises(ValueError, match='non-complex'):
        tcore.complex_to_channels(_t(x))
    with pytest.raises(ValueError, match='complex input'):
        tcore.channels_to_complex(_t(xc))


@pytest.mark.parametrize('batched,block,shape', [
    (True, 2, (2, 4, 6, 8, 3)), (True, 3, (1, 6, 9, 2)),
    (False, 2, (4, 2, 6, 5)),
])
def test_space_to_depth_bit_equal(batched, block, shape):
    x = _normal(9, shape)
    want = jcore.space_to_depth(jnp.asarray(x), block, batched)
    got = tcore.space_to_depth(_t(x), block, batched)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tcore.depth_to_space(got, block, batched)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcore.depth_to_space(want, block, batched)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match='divisible'):
        tcore.space_to_depth(_t(x), 5, batched)


@pytest.mark.parametrize('cls,kw,ndims', [
    ('FFT', dict(), 3), ('FFT', dict(axes=(1, 3)), 3), ('IFFT', dict(), 2),
    ('IFFT', dict(axes=-2), 2), ('FFTShift', dict(), 3),
    ('FFTShift', dict(axes=2), 1 + 1), ('IFFTShift', dict(axes=(1,)), 1),
])
def test_fft_layers(cls, kw, ndims):
    shape = (2, 6, 5, 4, 3)[:ndims + 1] + (3,)
    x = (_normal(10, shape) + 1j * _normal(11, shape)).astype(np.complex64)
    want = getattr(jbasic, cls)(**kw).apply({}, jnp.asarray(x))
    got = getattr(tbasic, cls)(**kw)(_t(x))
    assert got.dtype == torch.complex64
    _close(got, want, 1e-5 if 'Shift' not in cls else 0)
    with pytest.raises(IndexError, match='outside'):
        getattr(tbasic, cls)(axes=0)(_t(x))
    with pytest.raises(ValueError, match='only 1D'):
        getattr(tbasic, cls)()(_t(x)[..., None, None, None])


def test_complex_channel_layers():
    x = _normal(12, (2, 5, 4, 6))
    c = tbasic.ChannelsToComplex()(_t(x))
    _close(c, jbasic.ChannelsToComplex().apply({}, jnp.asarray(x)), 0)
    back = tbasic.ComplexToChannels()(c)
    _close(back, jbasic.ComplexToChannels().apply(
        {}, jnp.asarray(np.asarray(c))), 0)
    _close(back, x, 0)
    for name in ('FFT', 'IFFT', 'FFTShift', 'IFFTShift', 'ComplexToChannels',
                 'ChannelsToComplex'):
        assert getattr(nt.layers, name) is getattr(tbasic, name)
