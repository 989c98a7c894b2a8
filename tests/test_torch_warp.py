"""
The PyTorch port's 3-D interpolation (`neurite_tpu_torch.utils.core.interpn`,
`ops.warp`, K4 in `ops/warp_cuda.py`) against the JAX package's: the plain
gather chain must match `core.interpn` (linear within 1e-5 in float32,
nearest exactly), with and without `fill_value`, at points outside the
volume, on its upper edge and at half-integer ties (round half to even); it
must match the Pallas warps v1 and v2 (interpret mode) inside their window
contracts; and its gradients (dvol, dloc) must match `jax.vjp` of
`core.interpn`. `warp_cuda.plan` must pick K4's 'vec' body (32-bit) at
the paths' shapes and its 'scalar' body past 32 bits (reckoned from
shapes). K4 on the card: `test_torch_warp_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.ops import pallas_warp  # noqa: E402
from neurite_tpu.utils import core as jcore  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, warp, warp_cuda  # noqa: E402
from test_torch_warp_cuda import SHAPE, _grid, _loc, _vol  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize('channels', [None, 1, 3])
@pytest.mark.parametrize('fill', [None, 0., 2.5])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_interpn_matches_jax(method, fill, channels):
    vol, loc = _vol(1, SHAPE, channels), _loc(2)
    want = np.asarray(jcore.interpn(jnp.asarray(vol), jnp.asarray(loc),
                                    interp_method=method, fill_value=fill))
    got = nt.utils.core.interpn(torch.from_numpy(vol), torch.from_numpy(loc),
                                interp_method=method, fill_value=fill)
    assert got.shape == want.shape
    if method == 'nearest':
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_interpn_nearest_rounds_half_to_even_and_fills():
    vol = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    loc = np.asarray([[2.5, 3.5, 0.5], [0.5, 1.5, 6.5], [-0.5, 2., 2.],
                      [5., 6., 7.]], np.float32)
    got = nt.utils.core.interpn(torch.from_numpy(vol), torch.from_numpy(loc),
                                'nearest', fill_value=-1.).numpy()
    idx = [(2, 4, 0), (0, 2, 6), None, (5, 6, 7)]
    want = [-1. if i is None else vol[i] for i in idx]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_interpn_list_loc_and_2d(method):
    vol = _vol(3, (9, 10), 2)
    rng = np.random.default_rng(4)
    loc = (_grid((5, 6))[..., :2] + rng.uniform(-3, 3, size=(5, 6, 2))
           ).astype(np.float32)
    want = np.asarray(jcore.interpn(jnp.asarray(vol),
                                    [jnp.asarray(loc[..., 0]),
                                     jnp.asarray(loc[..., 1])],
                                    interp_method=method, fill_value=0.))
    got = nt.utils.core.interpn(torch.from_numpy(vol),
                                [torch.from_numpy(loc[..., 0]),
                                 torch.from_numpy(loc[..., 1])],
                                interp_method=method, fill_value=0.)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_interpn_rejects_bad_input():
    vol = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match='linear or nearest'):
        nt.utils.core.interpn(vol, torch.zeros(2, 3), interp_method='cubic')
    with pytest.raises(ValueError, match='does not match'):
        nt.utils.core.interpn(vol[..., None], torch.zeros(2, 2))


@pytest.mark.parametrize('version', ['v1', 'v2'])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_matches_pallas_warps_in_their_contract(method, version):
    """v1 (dynamic windows) absorbs a global translation; v2 (static
    windows) is exact for displacements within max_disp. The port's aliases
    are the exact op either way."""
    shape = (8, 8, 128)
    vol = _vol(5, (2, *shape), None)
    rng = np.random.default_rng(6)
    base = _grid(shape)[None]
    if version == 'v1':
        locs = np.stack([base[0] + 3.3, base[0] - 2.1]).astype(np.float32)
    else:
        locs = (base + rng.uniform(-2, 2, size=(2, *shape, 3))).astype(
            np.float32)
    disp = 2.
    want = np.asarray(pallas_warp.interpn_pallas(
        jnp.asarray(vol), jnp.asarray(locs), interp_method=method,
        fill_value=0., max_disp=disp, block=(4, 8), interpret=True,
        version=version))
    got = nt.ops.interpn_pallas(torch.from_numpy(vol), torch.from_numpy(locs),
                                interp_method=method, fill_value=0.,
                                max_disp=disp, block=(4, 8), version=version)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_aliases_batch_and_channels():
    vol = _vol(7, (2, *SHAPE), 3)
    loc = np.stack([_loc(8), _loc(9)])
    want = np.stack([np.asarray(jcore.interpn(
        jnp.asarray(vol[i]), jnp.asarray(loc[i]), fill_value=0.))
        for i in range(2)])
    tv, tl = torch.from_numpy(vol), torch.from_numpy(loc)
    for fn in (nt.ops.interpn_window, nt.ops.interpn_onehot,
               nt.ops.interpn_pallas):
        got = fn(tv, tl, fill_value=0., guard='none', engine='xla',
                 matmul_dtype='bf16x2')
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = nt.ops.interpn_onehot(tv[0], tl[0], fill_value=0., max_disp=1.)
    np.testing.assert_allclose(one.numpy(), want[0], rtol=0, atol=1e-5)


def _jax_vjp(vol, loc, method, fill, g):
    """JAX interpn's vjp of g, as one jitted program."""
    def run(vol, loc, g):
        _, vjp = jax.vjp(lambda v, l: jcore.interpn(
            v, l, interp_method=method, fill_value=fill), vol, loc)
        return vjp(g)
    return [np.asarray(a) for a in jax.jit(run)(
        jnp.asarray(vol), jnp.asarray(loc), jnp.asarray(g))]


def _torch_grads(fn, vol, loc, g):
    v = torch.from_numpy(vol).requires_grad_()
    lc = torch.from_numpy(loc).requires_grad_()
    out = fn(v, lc)
    dv, dl = torch.autograd.grad(out, (v, lc), torch.from_numpy(g),
                                 allow_unused=True)
    return dv.numpy(), (np.zeros_like(loc) if dl is None else dl.numpy())


@pytest.mark.parametrize('fill', [None, 0.])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_gradients_match_jax_vjp(method, fill):
    vol, loc = _vol(10, SHAPE, 3), _loc(11)
    g = np.random.default_rng(12).normal(size=(*SHAPE, 3)).astype(np.float32)
    want = _jax_vjp(vol, loc, method, fill, g)
    got = _torch_grads(lambda v, lc: nt.utils.core.interpn(
        v, lc, interp_method=method, fill_value=fill), vol, loc, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_kernel_autograd_function_backward(method, monkeypatch):
    """K4's autograd function, with the launch replaced by the plain
    version (no card here): its backward must give JAX's VJP."""
    monkeypatch.setattr(
        warp_cuda, 'interpn3d_fwd', lambda v, lc, m, f: nt.utils.core.
        interpn_plain(v, lc, m, f, batched=True))
    vol, loc = _vol(13, (1, *SHAPE), 2), _loc(14)[None]
    g = np.random.default_rng(15).normal(size=(1, *SHAPE, 2)).astype(
        np.float32)
    want = _jax_vjp(vol[0], loc[0], method, 0., g[0])
    got = _torch_grads(lambda v, lc: warp_cuda.interpn3d(v, lc, method, 0.),
                       vol, loc, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a[0], b, rtol=0, atol=1e-5)


def test_kernel_wrapper_checks_its_input():
    vol, loc = torch.zeros(1, 4, 4, 4, 1), torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match='CUDA'):
        warp_cuda.interpn3d_fwd(vol, loc, 'linear', None)
    with pytest.raises(ValueError, match='linear or nearest'):
        warp.interpn_batch(vol, loc, 'cubic')
    assert _build.launches['interpn'] == 0


@pytest.mark.parametrize('vol_shape, loc_shape', [
    ((1, 64, 64, 64, 3), (1, 64, 64, 64, 3)),      # config #5's squarings
    ((1, 128, 128, 128, 1), (1, 128, 128, 128, 3)),  # its label warp
    ((2, 9, 10, 12, 3), (2, 9, 10, 12, 3)),
    ((1, 64, 64, 64, 3), (1, 63, 65, 67, 3)),      # P odd: a ragged block
    ((1, 8, 8, 8, 5), (1, 5, 3)),
])
def test_plan_gives_vec_at_path_shapes(vol_shape, loc_shape):
    """'vec' (32-bit indices) wherever every size fits 32 bits: reckoned
    from the shapes, nothing allocated."""
    vol = torch.empty(vol_shape, device='meta')
    loc = torch.empty(loc_shape, device='meta')
    assert warp_cuda.plan(vol, loc) == 'vec'


@pytest.mark.parametrize('vol_shape, loc_shape', [
    ((1, 2048, 1024, 1024, 1), (1, 4, 3)),          # vol: 2^31 elements
    ((1, 8, 8, 8, 1), (1, 1024, 1024, 700, 3)),     # loc: B * P * 3 >= 2^31
    ((1, 2, 2, 2, 4096), (1, 1024, 1024, 1, 3)),    # out: B * P * C = 2^32
    ((65536, 2, 2, 2, 1), (65536, 4, 3)),           # B past the grid's y
])
def test_plan_gives_scalar_past_32_bits(vol_shape, loc_shape):
    vol = torch.empty(vol_shape, device='meta')
    loc = torch.empty(loc_shape, device='meta')
    assert warp_cuda.plan(vol, loc) == 'scalar'


def test_plan_takes_any_alignment():
    """The 'vec' body reads loc and writes out 4 bytes a lane: a misaligned
    contiguous view takes it too."""
    shape = (1, 6, 7, 8, 3)
    off = torch.empty(int(np.prod(shape)) + 1)[1:].view(shape)
    assert warp_cuda.plan(off, off) == 'vec'
