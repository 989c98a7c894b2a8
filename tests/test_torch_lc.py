"""
The PyTorch port's locally-connected ops against the JAX package's.

`ops.lc_tap` (the plain versions) and `ops.lc_cuda` (the kernels'
autograd functions, whose CPU path is the plain version) against
`neurite_tpu.ops.lc_tap` (forward and its hand-written VJP), the v2 Pallas
kernel (`pallas_lc2.lc_transposed_pallas`) and the v1 Pallas kernel
(`pallas_lc.lc3d_pallas`), both in interpret mode. Each JAX reference is
computed once (module-scoped caches): an interpret call costs seconds here.

Tolerances: float32 within rtol 1e-5 and atol 1e-5 (the sums run in
another order than XLA's); bfloat16 outputs within one bf16 ulp of JAX's,
and dk at B=1 equal (both round the same float32 product once). The
choosers `lc_cuda.fwd_body`, `dk_body` and `dx_body` are held to their
bodies from shapes and layouts; the kernels on the card:
`test_torch_lc_cuda.py`.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.ops import lc_tap as jtap  # noqa: E402
from neurite_tpu.ops import pallas_lc as jv1  # noqa: E402
from neurite_tpu.ops import pallas_lc2 as jv2  # noqa: E402
from neurite_tpu_torch.ops import _build, lc_cuda, lc_tap  # noqa: E402
from test_torch_lc_cuda import CASES, DK_BODIES  # noqa: E402
from test_torch_lc_cuda import _inputs as _card_inputs  # noqa: E402

torch.set_num_threads(1)

# the cases' shapes from the reference, not from the code under test
_inputs = functools.partial(_card_inputs, out_shape=jtap._out_shape)


def _jax_vjp(fn, x, k, g, dtype=jnp.float32):
    """fn's value and its vjp of g, as one jitted program (op by op, the
    tap sums and the interpreted kernels compile every op)."""
    def run(a, b, ct):
        y, vjp = jax.vjp(fn, a, b)
        return (y, *vjp(ct.astype(y.dtype)))
    out = jax.jit(run)(jnp.asarray(x, dtype), jnp.asarray(k, dtype),
                       jnp.asarray(g))
    return [np.asarray(a.astype(jnp.float32)) for a in out]


def _port_grads(fn, x, k, g, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    kt = torch.tensor(k, dtype=dtype, requires_grad=True)
    y = fn(xt, kt)
    dx, dk = torch.autograd.grad(y, (xt, kt), torch.from_numpy(g).to(y.dtype))
    assert dx.dtype == dtype and dk.dtype == dtype and y.dtype == torch.float32
    return [a.detach().float().numpy() for a in (y, dx, dk)]


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _bf16_ulp(v):
    """One bfloat16 ulp at each |v| (the spacing of its binade)."""
    a = np.maximum(np.abs(v), np.float32(2. ** -126))
    return 2. ** (np.floor(np.log2(a)) - 7)


def _within_ulp(got, want):
    assert np.all(np.abs(got - want) <= _bf16_ulp(want)), \
        float(np.max(np.abs(got - want) / _bf16_ulp(want)))


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope='module')
def tap_refs():
    return {}


@pytest.mark.parametrize('case', CASES, ids=str)
def test_plain_matches_jax_lc_tap(tap_refs, case):
    """Forward, dx and dk of `lc_tap.lc_transposed` and of the kernels'
    autograd function (CPU: the plain versions) against JAX's lc_tap."""
    B, sp, C, O, ks, padding = case
    x, k, g = _inputs(1, *case)
    if case not in tap_refs:
        tap_refs[case] = _jax_vjp(
            lambda a, b: jtap.lc_transposed(a, b, ks, padding), x, k, g)
    want = tap_refs[case]
    before = sum(_build.launches.values())
    _close(_port_grads(lambda a, b: lc_tap.lc_transposed(a, b, ks, padding),
                       x, k, g), want)
    _close(_port_grads(lambda a, b: lc_cuda.lc_transposed_pallas(
        a, b, ks, padding=padding), x, k, g), want)
    assert sum(_build.launches.values()) == before  # CPU: nothing launched


def test_dx_dk_are_the_plain_functions():
    """`lc_transposed_dx`/`_dk` on their own equal JAX's (the hand VJP)."""
    B, sp, C, O, ks, padding = CASES[1]
    x, k, g = _inputs(2, *CASES[1])
    dx = lc_tap.lc_transposed_dx(torch.from_numpy(g), torch.from_numpy(k),
                                 ks, padding, x.shape)
    dk = lc_tap.lc_transposed_dk(torch.from_numpy(g), torch.from_numpy(x),
                                 ks, padding)
    jdx = jtap.lc_transposed_dx(jnp.asarray(g), jnp.asarray(k), ks, padding,
                                x.shape)
    jdk = jtap.lc_transposed_dk(jnp.asarray(g), jnp.asarray(x), ks, padding)
    assert dx.dtype == dk.dtype == torch.float32
    _close([dx.numpy(), dk.numpy()], [np.asarray(jdx), np.asarray(jdk)])


def test_layout_round_trip():
    k = torch.from_numpy(np.random.default_rng(3).normal(
        size=(30, 12, 2)).astype(np.float32))
    t = lc_tap.keras_to_transposed(k)
    assert t.shape == (2, 12, 30) and t.is_contiguous()
    assert torch.equal(lc_tap.transposed_to_keras(t), k)
    want = jtap.keras_to_transposed(jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


@pytest.fixture(scope='module')
def v2_refs():
    """The v2 Pallas kernel in interpret mode: f32 (C=3, O=2) and bf16
    (C=3, O=1), B=1, SAME, at [4, 8, 8]."""
    out = {}
    for name, O, dt in (('f32', 2, jnp.float32), ('bf16', 1, jnp.bfloat16)):
        case = (1, (4, 8, 8), 3, O, (3, 3, 3), 'same')
        x, k, g = _inputs(4, *case, bf16=name == 'bf16')
        out[name] = (case, (x, k, g), _jax_vjp(
            lambda a, b: jv2.lc_transposed_pallas(a, b, (3, 3, 3), True),
            x, k, g, dt))
    return out


def test_matches_pallas_v2_f32(v2_refs):
    (B, sp, C, O, ks, padding), (x, k, g), want = v2_refs['f32']
    _close(_port_grads(lambda a, b: lc_cuda.lc_transposed_pallas(
        a, b, ks, interpret=True), x, k, g), want)


def test_matches_pallas_v2_bf16(v2_refs):
    """bf16 x and kernel: dk equal (one rounding of the same product), the
    forward and dx within one bf16 ulp after their casts."""
    (B, sp, C, O, ks, padding), (x, k, g), want = v2_refs['bf16']
    y, dx, dk = _port_grads(lambda a, b: lc_cuda.lc_transposed_pallas(
        a, b, ks), x, k, g, torch.bfloat16)
    np.testing.assert_array_equal(dk, want[2])
    _within_ulp(_bf16(y), _bf16(want[0]))
    _within_ulp(dx, want[1])
    # the plain function of the layers' non-CUDA route: the same numbers
    p = _port_grads(lambda a, b: lc_tap.lc_transposed(a, b, ks, padding),
                    x, k, g, torch.bfloat16)
    np.testing.assert_array_equal(p[2], dk)
    np.testing.assert_array_equal(p[0], y)


@pytest.fixture(scope='module')
def v1_refs():
    """The v1 Pallas kernel (keras layout, O=1, B=1) in interpret mode at
    [4, 8, 8], C=3: f32 and bf16."""
    out = {}
    shape3, ks, C = (4, 8, 8), (3, 3, 3), 3
    for name, dt in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):
        x, k, g = _inputs(5, 1, shape3, C, 1, ks, 'same',
                          bf16=name == 'bf16')
        xf = x.reshape(-1, C)
        k2 = np.ascontiguousarray(k[0].T)                 # [V, K]
        gf = g.reshape(-1, 1)
        out[name] = ((xf, k2, gf), _jax_vjp(
            lambda a, b: jv1.lc3d_pallas(a, b, shape3, ks, True),
            xf, k2, gf, dt))
    return out, shape3, ks


@pytest.mark.parametrize('name', ['f32', 'bf16'])
def test_matches_pallas_v1(v1_refs, name):
    """lc3d_pallas (K7, K8, K9 with keras strides; here their plain
    versions): bf16 dx depends on each g*k product being rounded to bf16
    before the sum (the v1 q)."""
    refs, shape3, ks = v1_refs
    (xf, k2, gf), want = refs[name]
    dt = torch.float32 if name == 'f32' else torch.bfloat16
    got = _port_grads(lambda a, b: lc_cuda.lc3d_pallas(a, b, shape3, ks,
                                                       True), xf, k2, gf, dt)
    if name == 'f32':
        _close(got, want)
        return
    y, dx, dk = got
    np.testing.assert_array_equal(dk, want[2])
    np.testing.assert_allclose(y, want[0], rtol=1e-5, atol=1e-5)
    _within_ulp(dx, want[1])
    # without rounding q the sums differ: the test sees the rounding
    x5 = torch.from_numpy(xf).reshape(1, *shape3, -1)
    kv = torch.from_numpy(k2).to(dt).t()[None]
    g5 = torch.from_numpy(gf).reshape(1, *shape3, 1)
    exact = lc_cuda.dx_plain(g5, kv, ks, 'same', tuple(x5.shape), dt)
    rounded = lc_cuda.dx_plain(g5, kv, ks, 'same', tuple(x5.shape), dt, True)
    np.testing.assert_array_equal(rounded.float().reshape(dx.shape).numpy(),
                                  dx)
    assert not torch.equal(exact, rounded)


def test_supported_and_wrapper_checks():
    assert lc_cuda.supported((1, 160, 160, 160, 4), (3, 3, 3), 1, (1, 1, 1),
                             'same')
    # no TPU gates: odd H, 2 filters x 16 channels, even kernels, 'valid'
    assert lc_cuda.supported((2, 5, 7, 9, 16), (2, 3, 4), 2, (1, 1, 1),
                             'valid')
    assert not lc_cuda.supported((1, 8, 8, 8, 3), (3, 3, 3), 1, (2, 2, 2),
                                 'same')
    assert not lc_cuda.supported((1, 8, 8, 3), (3, 3), 1, (1, 1), 'same')
    assert not lc_cuda.supported((1, 2, 8, 8, 3), (3, 3, 3), 1, (1, 1, 1),
                                 'valid')
    assert not lc_cuda.supported((1, 2048, 1024, 1024, 1), (3, 3, 3), 1,
                                 (1, 1, 1), 'same')    # 2^31 voxels
    assert not lc_cuda.supported((65536, 4, 4, 4, 1), (3, 3, 3), 1,
                                 (1, 1, 1), 'same')
    x = torch.zeros(1, 4, 4, 4, 2)
    k = torch.zeros(1, 54, 64)
    with pytest.raises(ValueError, match='CUDA'):
        lc_cuda.fwd_cuda(x, k, (3, 3, 3), 'same')
    with pytest.raises(ValueError, match='CUDA'):
        lc_cuda.dk_cuda(torch.zeros(1, 4, 4, 4, 1), x, (3, 3, 3), 'same',
                        torch.float32)
    with pytest.raises(ValueError, match='CUDA'):
        lc_cuda.dx_cuda(torch.zeros(1, 4, 4, 4, 1), k, (3, 3, 3), 'same',
                        (1, 4, 4, 4, 2), torch.float32)
    with pytest.raises(ValueError, match='fit'):
        lc_cuda._check(x, torch.zeros(1, 27, 64), (3, 3, 3), 'same')
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        lc_cuda._check(x.double(), k, (3, 3, 3), 'same')
    assert not _build.launches['lc_fwd']


def _dk_args(x_shape, O, dtype, keras=False, ks=(3, 3, 3), padding='same',
             device='meta'):
    """(x, dk's [O, TC, V] view) as `dk_cuda` sees them for x_shape: dk in
    the weights' own layout (keras [V, TC, O], or transposed), on
    `device`."""
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    shape = (O, int(np.prod(ks)) * x_shape[-1], int(np.prod(out)))
    dk = torch.empty(shape[::-1] if keras else shape, dtype=dtype,
                     device=device)
    x = torch.empty(x_shape, dtype=dtype, device=device)
    return x, lc_cuda._weight_view(dk, keras)


@pytest.mark.parametrize('case', sorted(DK_BODIES))
def test_dk_body_picks_by_layout_and_shape(case):
    """K8's row body takes batch 1, 4 channels, kx <= 3 and whole 16-byte
    groups of voxels in each output row of the transposed layout; its keras
    row body the keras layout on the same batch, channels, filter and kx
    (ky too) whose 32-voxel tile fits 48 KB; a batch, another C, O or kx
    and a ragged row of the transposed layout take the one-voxel body."""
    x_shape, O, dtype, keras, padding, ks, (body, _, _) = DK_BODIES[case]
    x, view = _dk_args(x_shape, O, dtype, keras, ks, padding)
    assert lc_cuda.dk_body(x, view, ks, padding) == body


def test_dk_body_needs_aligned_bases():
    """A dk that starts off a 16-byte boundary, or an x off its 4-channel
    voxels, takes the one-voxel body."""
    ks = (3, 3, 3)
    x, view = _dk_args((1, 4, 4, 8, 4), 1, torch.bfloat16, device='cpu')
    assert lc_cuda.dk_body(x, view, ks, 'same') == 'row'
    flat = torch.empty(view.numel() + 1, dtype=torch.bfloat16)
    assert lc_cuda.dk_body(x, flat[1:].view(view.shape), ks,
                           'same') == 'voxel'
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    assert lc_cuda.dk_body(flat[1:].view(x.shape), view, ks,
                           'same') == 'voxel'


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_dk_keras_row_needs_keras_strides_and_aligned_bases(dtype):
    """K8's keras row body writes [V, TC, O] as one contiguous run and loads
    x's four channels at once: a dk whose keras layout is not contiguous,
    or that starts off a 16-byte boundary, or an x off its 4-channel
    voxels, takes the one-voxel body."""
    ks, shape = (3, 3, 3), (1, 4, 5, 6, 4)
    x, view = _dk_args(shape, 1, dtype, keras=True, device='cpu')
    assert lc_cuda.dk_body(x, view, ks, 'same') == 'keras_row'
    flat = torch.empty(x.numel() + 1, dtype=dtype)
    assert lc_cuda.dk_body(flat[1:].view(x.shape), view, ks,
                           'same') == 'voxel'
    keras = view.permute(2, 1, 0)
    flat = torch.empty(keras.numel() + 1, dtype=dtype)
    off = lc_cuda._weight_view(flat[1:].view(keras.shape), True)
    assert lc_cuda.dk_body(x, off, ks, 'same') == 'voxel'
    # the keras layout with its filter strided apart: not one run
    wide = torch.empty((*keras.shape[:2], 2), dtype=dtype)
    gapped = lc_cuda._weight_view(wide[..., ::2], True)
    assert lc_cuda.dk_body(x, gapped, ks, 'same') == 'voxel'


@pytest.mark.parametrize('case', sorted(DK_BODIES))
def test_fwd_body_picks_by_layout_and_shape(case):
    """K7's row body takes K8's row conditions, and its keras row body K8's
    keras row conditions; every other shape its one-voxel body."""
    x_shape, O, dtype, keras, padding, ks, (_, body, _) = DK_BODIES[case]
    x, view = _dk_args(x_shape, O, dtype, keras, ks, padding)
    assert lc_cuda.fwd_body(x, view, ks, padding) == body


@pytest.mark.parametrize('case', sorted(DK_BODIES))
def test_dx_body_picks_by_layout_and_shape(case):
    """K9's row body takes K8's row conditions with 'same' padding (W =
    Wo), and its keras row body K8's keras head with 'same' padding where a
    z-plane's weights stay within 32-bit offsets; 'valid' and every other
    shape take the one-voxel body."""
    x_shape, O, dtype, keras, padding, ks, (_, _, body) = DK_BODIES[case]
    x, view = _dk_args(x_shape, O, dtype, keras, ks, padding)
    assert lc_cuda.dx_body(x_shape, view, ks, padding) == body


def test_fwd_dx_bodies_need_aligned_bases():
    """Weights that start off a 16-byte boundary take the one-voxel bodies
    of K7 and K9, and so does an x off its 4-channel voxels for K7 (K9
    writes a dx it allocates)."""
    ks, shape = (3, 3, 3), (1, 4, 4, 8, 4)
    x, view = _dk_args(shape, 1, torch.bfloat16, device='cpu')
    assert lc_cuda.fwd_body(x, view, ks, 'same') == 'row'
    assert lc_cuda.dx_body(shape, view, ks, 'same') == 'row'
    flat = torch.empty(view.numel() + 1, dtype=torch.bfloat16)
    off = flat[1:].view(view.shape)
    assert lc_cuda.fwd_body(x, off, ks, 'same') == 'voxel'
    assert lc_cuda.dx_body(shape, off, ks, 'same') == 'voxel'
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    assert lc_cuda.fwd_body(flat[1:].view(x.shape), view, ks,
                            'same') == 'voxel'


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fwd_dx_keras_row_need_keras_head(dtype):
    """K7's and K9's keras row bodies read the keras run [V, TC, O] and x's
    (K7) four channels at once, at batch 1, 4 channels and 1 filter, K9 with
    'same' padding only: weights off a 16-byte boundary, a keras view that
    is not one run, O = 2, C = 3 or B = 3 take the one-voxel bodies, and so
    does an x off its 4-channel voxels for K7 and 'valid' for K9."""
    ks, shape = (3, 3, 3), (1, 4, 5, 6, 4)

    def bodies(x, view, padding='same'):
        return (lc_cuda.fwd_body(x, view, ks, padding),
                lc_cuda.dx_body(tuple(x.shape), view, ks, padding))

    x, view = _dk_args(shape, 1, dtype, keras=True, device='cpu')
    assert bodies(x, view) == ('keras_row', 'keras_row')
    xv, vv = _dk_args(shape, 1, dtype, keras=True, padding='valid',
                      device='cpu')
    assert bodies(xv, vv, 'valid') == ('keras_row', 'voxel')
    flat = torch.empty(x.numel() + 1, dtype=dtype)
    assert bodies(flat[1:].view(x.shape), view) == ('voxel', 'keras_row')
    keras = view.permute(2, 1, 0)
    flat = torch.empty(keras.numel() + 1, dtype=dtype)
    off = lc_cuda._weight_view(flat[1:].view(keras.shape), True)
    assert bodies(x, off) == ('voxel', 'voxel')
    wide = torch.empty((*keras.shape[:2], 2), dtype=dtype)
    gapped = lc_cuda._weight_view(wide[..., ::2], True)
    assert bodies(x, gapped) == ('voxel', 'voxel')
    for x_shape, O in (((1, 4, 5, 6, 4), 2), ((1, 4, 5, 6, 3), 1),
                       ((3, 4, 5, 6, 4), 1)):
        xo, vo = _dk_args(x_shape, O, dtype, keras=True, device='cpu')
        assert bodies(xo, vo) == ('voxel', 'voxel')
