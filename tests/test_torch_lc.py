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
and dk at B=1 equal (both round the same float32 product once). On the
card (`cuda` tests) the kernels must equal the plain versions, each body
of K7, K8 and K9 (`lc_cuda.fwd_body`, `dk_body`, `dx_body`: 16-byte rows
of voxels a thread, K8's keras row body, or one voxel) included.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.ops import lc_tap as jtap  # noqa: E402
from neurite_tpu.ops import pallas_lc as jv1  # noqa: E402
from neurite_tpu.ops import pallas_lc2 as jv2  # noqa: E402
from neurite_tpu_torch.ops import _build, lc_cuda, lc_tap  # noqa: E402

torch.set_num_threads(1)

# (B, spatial, C, O, kernel_size, padding): every value of each knob
CASES = [
    (1, (5, 6, 7), 1, 1, (3, 3, 3), 'same'),
    (3, (5, 6, 7), 3, 2, (3, 3, 3), 'valid'),
    (1, (6, 5, 4), 3, 1, (3, 1, 3), 'valid'),
    (3, (4, 6, 5), 1, 2, (3, 1, 3), 'same'),
    (1, (5, 5, 6), 3, 2, (3, 3, 3), 'same'),
    (3, (6, 4, 5), 1, 1, (3, 3, 3), 'valid'),
]


def _inputs(seed, B, sp, C, O, ks, padding, bf16=False):
    rng = np.random.default_rng(seed)
    out = jtap._out_shape(sp, ks, padding)
    x = rng.normal(size=(B, *sp, C)).astype(np.float32)
    k = rng.normal(size=(O, int(np.prod(ks)) * C, int(np.prod(out))))
    g = rng.normal(size=(B, *out, O)).astype(np.float32)
    if bf16:  # values that bfloat16 holds exactly
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        k = np.asarray(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
    return x, k.astype(np.float32), g


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


DK_BODIES = {   # name: (x_shape, O, dtype, keras, padding, ks,
                #        the bodies of K8, K7 and K9)
    # the config #3 head: Wo = 160, a multiple of 8 bf16 or 4 f32 voxels
    'head_bf16': ((1, 160, 160, 160, 4), 1, torch.bfloat16, False, 'same',
                  (3, 3, 3), ('row', 'row', 'row')),
    'head_f32': ((1, 160, 160, 160, 4), 1, torch.float32, False, 'same',
                 (3, 3, 3), ('row', 'row', 'row')),
    'row_o2_bf16': ((1, 5, 6, 16, 4), 2, torch.bfloat16, False, 'same',
                    (3, 3, 3), ('row', 'row', 'row')),
    # 'valid': Wo = 12, 4 f32 voxels fit a row, 8 bf16 ones do not; K9's
    # row body takes 'same' only
    'row_valid_f32': ((1, 5, 6, 14, 4), 1, torch.float32, False, 'valid',
                      (3, 3, 3), ('row', 'row', 'voxel')),
    'row_valid_bf16': ((1, 5, 6, 14, 4), 1, torch.bfloat16, False, 'valid',
                       (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'b3_o2_bf16': ((3, 32, 32, 32, 4), 2, torch.bfloat16, False, 'same',
                   (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'b3_o2_f32': ((3, 32, 32, 32, 4), 2, torch.float32, False, 'same',
                  (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    # the keras layout: K8, K7 and K9 by their keras row bodies at the
    # head's B = 1, C = 4, O = 1 and ky, kx <= 3 (K9 'same' only), else by
    # their one-voxel bodies
    'keras_head': ((1, 160, 160, 160, 4), 1, torch.bfloat16, True, 'same',
                   (3, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    'keras_valid_f32': ((1, 6, 7, 9, 4), 1, torch.float32, True, 'valid',
                        (3, 3, 3), ('keras_row', 'keras_row', 'voxel')),
    'keras_b3_o2': ((3, 32, 32, 32, 4), 2, torch.float32, True, 'same',
                    (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_o2': ((1, 6, 7, 9, 4), 2, torch.bfloat16, True, 'same',
                 (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_c3': ((1, 6, 7, 9, 3), 1, torch.bfloat16, True, 'same',
                 (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_kx5': ((1, 6, 6, 16, 4), 1, torch.bfloat16, True, 'same',
                  (3, 3, 5), ('voxel', 'voxel', 'voxel')),
    'keras_c16_o4': ((1, 4, 4, 8, 16), 4, torch.float32, True, 'same',
                     (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    # 32 voxels of TC = 396 float32 weights pass 48 KB of shared memory;
    # bfloat16 ones fit; K9 stages one tz at a time, whatever kz
    'keras_big_tile_f32': ((1, 12, 4, 8, 4), 1, torch.float32, True,
                           'same', (11, 3, 3), ('voxel', 'voxel', 'keras_row')),
    'keras_kz11_bf16': ((1, 12, 4, 8, 4), 1, torch.bfloat16, True, 'same',
                        (11, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    # TC = 360 float32: 32 voxels' tiles fit, 45 KB
    'keras_kz10_f32': ((1, 11, 4, 8, 4), 1, torch.float32, True, 'same',
                       (10, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    # a z-plane of H W TC = 4096^2 x 396 weights passes 32-bit offsets
    'keras_big_plane': ((1, 2, 4096, 4096, 4), 1, torch.bfloat16, True,
                        'same', (11, 3, 3), ('keras_row', 'keras_row',
                                             'voxel')),
    # Wo = 19: a thread's voxels would cross rows
    'ragged_bf16': ((1, 15, 17, 19, 4), 1, torch.bfloat16, False, 'same',
                    (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'ragged_f32': ((1, 15, 17, 19, 4), 1, torch.float32, False, 'same',
                   (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'c3_bf16': ((1, 16, 17, 16, 3), 1, torch.bfloat16, False, 'same',
                (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'kx5_bf16': ((1, 6, 6, 16, 4), 1, torch.bfloat16, False, 'same',
                 (3, 3, 5), ('voxel', 'voxel', 'voxel')),
}


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES[:3], ids=str)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_on_card(cuda, case, dtype):
    """K7, K8 and K9 against their plain versions on the card: equal."""
    B, sp, C, O, ks, padding = case
    x, k, g = (torch.from_numpy(a).to(cuda) for a in _inputs(6, *case))
    x, k = x.to(dtype), k.to(dtype)
    for keras in (False, True):
        kern = k.permute(2, 1, 0).contiguous() if keras else k
        kv = lc_cuda._weight_view(kern, keras)
        pairs = [
            (lc_cuda.fwd_cuda(x, kv, ks, padding),
             lc_cuda.fwd_plain(x, kv, ks, padding)),
            (lc_cuda.dk_cuda(g, x, ks, padding, dtype, keras),
             lc_cuda.dk_plain(g, x, ks, padding, dtype, keras)),
            (lc_cuda.dx_cuda(g, kv, ks, padding, tuple(x.shape), dtype,
                             keras),
             lc_cuda.dx_plain(g, kv, ks, padding, tuple(x.shape), dtype,
                              keras)),
        ]
        torch.cuda.synchronize()
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['row_o2_bf16', 'row_valid_f32',
                                  'row_valid_bf16', 'b3_o2_bf16',
                                  'b3_o2_f32', 'ragged_bf16', 'ragged_f32',
                                  'c3_bf16', 'kx5_bf16'])
def test_dk_bodies_equal_plain_on_card(cuda, case):
    """Each K8 body against dk_plain on the card: equal, and the launch
    counts show which body ran."""
    x_shape, O, dtype, keras, padding, ks, (body, _, _) = DK_BODIES[case]
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32)).to(
        cuda, dtype)
    g = torch.from_numpy(rng.normal(size=(x_shape[0], *out, O)).astype(
        np.float32)).to(cuda)
    _build.launches.clear()
    got = lc_cuda.dk_cuda(g, x, ks, padding, dtype)
    want = lc_cuda.dk_plain(g, x, ks, padding, dtype)
    torch.cuda.synchronize()
    assert _build.launches['lc_dk'] == 1
    assert _build.launches['lc_dk_row'] == (body == 'row')
    assert got.dtype == want.dtype and torch.equal(got, want)


KERAS_CASES = {   # name: (x_shape, O, dtype, padding, ks, K8's body)
    # the head's B = 1, C = 4 and O = 1 (one load and store a tap); V = 378:
    # a ragged tail
    'quad_bf16': ((1, 6, 7, 9, 4), 1, torch.bfloat16, 'same', (3, 3, 3),
                  'keras_row'),
    'quad_f32': ((1, 6, 7, 9, 4), 1, torch.float32, 'same', (3, 3, 3),
                 'keras_row'),
    'valid_bf16': ((1, 6, 7, 9, 4), 1, torch.bfloat16, 'valid', (3, 3, 3),
                   'keras_row'),
    'kz5_ky2_f32': ((1, 7, 6, 9, 4), 1, torch.float32, 'same', (5, 2, 3),
                    'keras_row'),
    # the one-voxel body in the keras layout
    'b3_o2_f32': ((3, 5, 6, 7, 4), 2, torch.float32, 'same', (3, 3, 3),
                  'voxel'),
    'b2_bf16': ((2, 5, 6, 7, 4), 1, torch.bfloat16, 'same', (3, 3, 3),
                'voxel'),
    'c3_valid_bf16': ((1, 6, 7, 9, 3), 1, torch.bfloat16, 'valid',
                      (3, 3, 3), 'voxel'),
    'kx5_f32': ((1, 6, 6, 16, 4), 1, torch.float32, 'same', (3, 3, 5),
                'voxel'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(KERAS_CASES))
def test_dk_keras_row_equals_plain_on_card(cuda, case):
    """K8 in the keras layout, by the body `dk_body` picks, against
    dk_plain(keras=True) and against K8's one-voxel body on the card: equal
    bits, and the launch counts show which body ran."""
    x_shape, O, dtype, padding, ks, body = KERAS_CASES[case]
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=x_shape).astype(np.float32)).to(
        cuda, dtype)
    g = torch.from_numpy(rng.normal(size=(x_shape[0], *out, O)).astype(
        np.float32)).to(cuda)
    _build.launches.clear()
    got = lc_cuda.dk_cuda(g, x, ks, padding, dtype, keras=True)
    assert _build.launches['lc_dk_keras_row'] == (body == 'keras_row')
    want = lc_cuda.dk_plain(g, x, ks, padding, dtype, keras=True)
    voxel = torch.empty_like(got)
    lc_cuda._dk_launch(g, x, lc_cuda._weight_view(voxel, True), ks, padding,
                       'voxel')
    torch.cuda.synchronize()
    ity = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(ity), want.view(ity))
    assert torch.equal(got.view(ity), voxel.view(ity))


ROW_CASES = {   # name: (x_shape, O, padding, K7's and K9's bodies)
    # V = 6528: a ragged last block, and warps that span two rows
    'ragged_block': ((1, 16, 17, 24, 4), 1, 'same', 'row', 'row'),
    'o2_32': ((1, 32, 32, 32, 4), 2, 'same', 'row', 'row'),
    'valid': ((1, 16, 17, 18, 4), 1, 'valid', 'row', 'voxel'),
    'w19': ((1, 15, 17, 19, 4), 1, 'same', 'voxel', 'voxel'),
    'b3': ((3, 16, 17, 24, 4), 1, 'same', 'voxel', 'voxel'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ROW_CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fwd_dx_bodies_equal_plain_on_card(cuda, case, dtype):
    """K7 and K9 against fwd_plain and dx_plain on the card, each body (and
    K9's rounded products, round_q): equal, and the launch counts show
    which body ran."""
    x_shape, O, padding, fwd_want, dx_want = ROW_CASES[case]
    ks = (3, 3, 3)
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(8)
    x, k, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda) for s in (x_shape, (O, 108, int(np.prod(out))),
                        (x_shape[0], *out, O)))
    x, k = x.to(dtype), k.to(dtype)
    _build.launches.clear()
    got = lc_cuda.fwd_cuda(x, k, ks, padding)
    want = lc_cuda.fwd_plain(x, k, ks, padding)
    torch.cuda.synchronize()
    assert _build.launches['lc_fwd_row'] == (fwd_want == 'row')
    assert torch.equal(got, want)
    for round_q in (False, True):
        _build.launches.clear()
        got = lc_cuda.dx_cuda(g, k, ks, padding, x_shape, dtype, round_q)
        want = lc_cuda.dx_plain(g, k, ks, padding, x_shape, dtype, round_q)
        torch.cuda.synchronize()
        assert _build.launches['lc_dx_row'] == (dx_want == 'row')
        assert got.dtype == want.dtype and torch.equal(got, want)


KERAS_FWD_DX_CASES = {   # name: (x_shape, padding, ks, K7's and K9's
                         #        bodies in bf16, in f32)
    # V = 378 (K7: 3 blocks of 128 output voxels, the last ragged)
    'ragged': ((1, 6, 7, 9, 4), 'same', (3, 3, 3),
               ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # V = 990: H and W not multiples of K9's 8 x 16 tiles
    'ragged_990': ((1, 9, 10, 11, 4), 'same', (3, 3, 3),
                   ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    'valid': ((1, 6, 7, 9, 4), 'valid', (3, 3, 3),
              ('keras_row', 'voxel'), ('keras_row', 'voxel')),
    # kx = 2: a halo of one voxel along W
    'kx2': ((1, 6, 7, 9, 4), 'same', (3, 3, 2),
            ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # an even kernel: low 'same' padding 0 along H
    'kz5_ky2': ((1, 7, 6, 9, 4), 'same', (5, 2, 3),
                ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # TC = 396: K7's 32-voxel blocks in bf16, float32 past 48 KB; K9
    # stages one tz at a time
    'kz11': ((1, 12, 4, 8, 4), 'same', (11, 3, 3),
             ('keras_row', 'keras_row'), ('voxel', 'keras_row')),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(KERAS_FWD_DX_CASES))
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fwd_dx_keras_row_equal_plain_on_card(cuda, case, dtype):
    """K7 and K9 in the keras layout, by the bodies `fwd_body` and
    `dx_body` pick, against fwd_plain and dx_plain (with and without
    round_q) and against their one-voxel bodies on the card: equal bits,
    and the launch counts show which body ran."""
    x_shape, padding, ks, bf16_bodies, f32_bodies = KERAS_FWD_DX_CASES[case]
    fwd_want, dx_want = bf16_bodies if dtype == torch.bfloat16 else f32_bodies
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(9)
    x, k, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda) for s in (x_shape, (int(np.prod(out)), int(np.prod(ks)) * 4),
                        (1, *out, 1)))
    x, k = x.to(dtype), k.to(dtype)
    kv = lc_cuda._weight_view(k, True)
    _build.launches.clear()
    got = lc_cuda.fwd_cuda(x, kv, ks, padding)
    assert _build.launches['lc_fwd_keras_row'] == (fwd_want == 'keras_row')
    voxel = torch.empty_like(got)
    lc_cuda._fwd_launch(x, kv, voxel, ks, padding, 'voxel')
    want = lc_cuda.fwd_plain(x, kv, ks, padding)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), voxel.view(torch.int32))
    ity = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for round_q in (False, True):
        _build.launches.clear()
        got = lc_cuda.dx_cuda(g, kv, ks, padding, x_shape, dtype, round_q)
        assert _build.launches['lc_dx_keras_row'] == (dx_want == 'keras_row')
        voxel = torch.empty_like(got)
        lc_cuda._dx_launch(g, kv, voxel, ks, padding, round_q, 'voxel')
        want = lc_cuda.dx_plain(g, kv, ks, padding, x_shape, dtype, round_q)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        assert torch.equal(got.view(ity), want.view(ity))
        assert torch.equal(got.view(ity), voxel.view(ity))
