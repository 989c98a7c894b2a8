"""
The PyTorch port's max pool (`neurite_tpu_torch.ops.pool`) against the JAX
package's: the plain first-max pool must match `_max_pool_tiled` and the
Pallas kernel (interpret mode) bit for bit, forward and VJP, and the padded
fallback must match flax's `nn.max_pool`. Inputs are quantized to halves so
that windows tie, and one window holds a NaN.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.ops.pool import _max_pool_tiled as jax_max_pool_tiled  # noqa: E402
from neurite_tpu_torch.ops import _build, max_pool, pool, pool_cuda  # noqa: E402

torch.set_num_threads(1)

DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _quantized(seed, shape, nan_at=None):
    """Halves (exact in bf16, many ties; +0. removes -0.), one optional NaN."""
    x = np.round(np.random.default_rng(seed).normal(size=shape) * 2) / 2 + 0.
    if nan_at is not None:
        x[nan_at] = np.nan
    return x.astype(np.float32)


def _grad(seed, shape):
    """Nonzero multiples of 1/64: exact in bf16, so both packages see the
    same cotangent, and a zero never hides a routed gradient."""
    g = np.round(np.random.default_rng(seed).normal(size=shape) * 64) / 64
    g[g == 0] = 1 / 64
    return g.astype(np.float32)


def _both(a, dt):
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(t):
    return t.detach().float().numpy()


def _jax_vjp(fn, x, g):
    """fn's value and its vjp of g, as one jitted program."""
    def run(x, g):
        y, vjp = jax.vjp(fn, x)
        return y, vjp(g)
    return jax.jit(run)(x, g)


def _torch_vjp(fn, x, g):
    x = x.clone().requires_grad_()
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, g)
    return y, dx


@pytest.mark.parametrize('dt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,window', [
    ((1, 8, 8, 8, 4), (2, 2, 2)),       # cubic
    ((2, 8, 6, 4, 3), (2, 2, 2)),       # non-cubic, odd channels
    ((1, 6, 4, 8, 2), (3, 2, 1)),       # other window
    ((2, 6, 8, 5), (2, 2)),             # 2-D
])
def test_plain_pool_matches_jax_tiled(shape, window, dt):
    nan_at = (0,) + (1,) * (len(shape) - 1)
    xt, xj = _both(_quantized(0, shape, nan_at), dt)
    out = (shape[0],) + tuple(s // w for s, w in zip(shape[1:-1], window)) \
        + (shape[-1],)
    gt, gj = _both(_grad(1, out), dt)

    yj, (dxj,) = _jax_vjp(lambda v: jax_max_pool_tiled(v, window), xj, gj)
    yt, dxt = _torch_vjp(lambda v: max_pool(v, window), xt, gt)
    # bit-exact: both pick the same element of each window, no arithmetic
    np.testing.assert_array_equal(_np(yt), np.asarray(yj, np.float32))
    np.testing.assert_array_equal(_np(dxt), np.asarray(dxj, np.float32))
    assert np.isnan(_np(yt)).sum() == 1
    # the NaN window routes g to every one of its taps, as JAX does
    assert (_np(dxt) != 0).sum() == (np.prod(out) - 1) + np.prod(window)


@pytest.mark.parametrize('shape,dt', [
    ((1, 16, 8, 8, 8), 'float32'),
    ((1, 8, 8, 12, 16), 'bfloat16'),
])
def test_plain_pool_matches_pallas_interpret(shape, dt, monkeypatch):
    monkeypatch.setenv('NEURITE_PALLAS_POOL', 'interpret')
    from neurite_tpu.ops import pool_pallas
    importlib.reload(pool_pallas)
    # no NaN here: the Pallas kernel pairs D lanes through 0/1 selector
    # matmuls, where NaN * 0 spreads a NaN over its whole row of outputs;
    # NaN semantics are held against `_max_pool_tiled` above
    xt, xj = _both(_quantized(2, shape), dt)
    out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4])
    gt, gj = _both(_grad(3, out), dt)
    yj, (dxj,) = _jax_vjp(pool_pallas.max_pool2_3d, xj, gj)
    # on a CPU tensor the kernel wrapper takes the plain version
    yt, dxt = _torch_vjp(pool_cuda.max_pool2_3d, xt, gt)
    np.testing.assert_array_equal(_np(yt), np.asarray(yj, np.float32))
    np.testing.assert_array_equal(_np(dxt), np.asarray(dxj, np.float32))


@pytest.mark.parametrize('shape,window,strides,padding', [
    ((1, 5, 7, 6, 3), (2, 2, 2), None, 'SAME'),      # windows do not divide
    ((2, 7, 6, 3), (3, 3), (2, 2), 'VALID'),         # overlapping windows
])
def test_padded_pool_matches_flax(shape, window, strides, padding):
    # distinct normal values: no ties, so autograd's and XLA's routing agree
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    st = window if strides is None else strides
    yj, vjp = jax.vjp(lambda v: nn.max_pool(v, window, strides=st,
                                            padding=padding), jnp.asarray(x))
    g = np.random.default_rng(5).normal(size=yj.shape).astype(np.float32)
    yt, dxt = _torch_vjp(lambda v: max_pool(v, window, strides=strides,
                                            padding=padding),
                         torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    np.testing.assert_array_equal(_np(dxt), np.asarray(vjp(jnp.asarray(g))[0]))


def test_pool_dispatch_and_validation():
    x = torch.from_numpy(_quantized(6, (1, 4, 4, 4, 2)))
    ref = pool._max_pool_tiled(x, (2, 2, 2))
    for impl in ('auto', 'kernel', 'plain'):
        # CPU tensors take the plain version whatever impl asks for
        assert torch.equal(max_pool(x, (2, 2, 2), impl=impl), ref)
    with pytest.raises(ValueError, match='impl'):
        max_pool(x, (2, 2, 2), impl='pallas')
    with pytest.raises(ValueError, match='spatial dims'):
        max_pool(x, (2, 2))
    with pytest.raises(ValueError, match='padding'):
        max_pool(x[:, :3], (2, 2, 2), padding='FULL')
    with pytest.raises(ValueError, match='CUDA tensor'):
        pool_cuda.pool2_fwd(x)
    assert pool_cuda.supported((1, 128, 128, 128, 16), (2, 2, 2),
                               torch.bfloat16)
    assert pool_cuda.supported((2, 4, 6, 2, 7), (2, 2, 2), torch.float32)
    assert not pool_cuda.supported((1, 5, 4, 4, 8), (2, 2, 2), torch.float32)
    assert not pool_cuda.supported((1, 4, 4, 4, 8), (2, 2, 2), torch.float16)
    assert not pool_cuda.supported((1, 8, 8, 8), (2, 2), torch.float32)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize('shape,dtype,ptrs,want', [
    # the flagship's and config #5's three levels, config #3's two
    ((1, 128, 128, 128, 16), BF16, (0, 512), ('vec', (128, 2), (1, 2048))),
    ((1, 64, 64, 64, 32), BF16, (0, 512), ('vec', (128, 2), (1, 512))),
    ((1, 32, 32, 32, 64), BF16, (0, 512), ('vec', (128, 2), (1, 128))),
    ((1, 160, 160, 160, 8), BF16, (0, 512), ('vec', (80, 3), (1, 2134))),
    ((1, 80, 80, 80, 16), BF16, (0, 512), ('vec', (80, 3), (1, 534))),
    # float32: 4 lanes
    ((2, 8, 6, 4, 4), F32, (16, 32), ('vec', (2, 128), (1, 1))),
    ((1, 8, 8, 8, 12), F32, (16, 32), ('vec', (12, 21), (1, 1))),
    # a row of more than 256 vectors: blocks along x, one row a block
    ((1, 4, 4, 1024, 8), BF16, (0, 16), ('vec', (256, 1), (2, 4))),
    # the channels do not fill 16 bytes, or a pointer is not 16-byte aligned
    ((1, 32, 32, 32, 7), BF16, (0, 16), ('scalar', None, None)),
    ((1, 8, 8, 8, 4), BF16, (0, 16), ('scalar', None, None)),
    ((1, 8, 8, 8, 6), F32, (0, 16), ('scalar', None, None)),
    ((1, 128, 128, 128, 16), BF16, (2, 512), ('scalar', None, None)),
    ((1, 128, 128, 128, 16), F32, (0, 4), ('scalar', None, None)),
])
def test_pool_plan(shape, dtype, ptrs, want):
    p = pool_cuda.plan(shape, dtype, ptrs)
    assert (p.body, p.block, p.grid) == want
    if p.body == 'scalar':
        return
    b, d, h, w, c = shape
    per_row = w // 2 * c * dtype.itemsize // 16
    rows = b * (d // 2) * (h // 2)
    (tx, ty), (gx, gy) = p.block, p.grid
    # every vector of a row has a thread, and the grid's rows cover them all
    # without a stride: no shape here is past 65535 row blocks
    assert tx * ty <= pool_cuda.THREADS and gx * tx >= per_row
    assert gx * tx - per_row < tx and gy * ty >= rows > (gy - 1) * ty
    assert not p.wide


def test_pool_plan_folds_rows_and_widens_offsets():
    # 256^2 output rows: past 65535 row blocks, the rest by a grid stride;
    # 2^31 elements: 64-bit offsets, still the vec body
    p = pool_cuda.plan((1, 512, 512, 512, 16), BF16, (0, 0))
    assert p.body == 'vec' and p.grid == (2, pool_cuda.MAX_GRID_Y)
    assert p.block == (256, 1) and p.wide
    p = pool_cuda.plan((1, 512, 512, 512, 8), BF16, (0, 0))
    assert p.body == 'vec' and p.grid == (1, pool_cuda.MAX_GRID_Y)
    assert p.block == (256, 1) and not p.wide
    p = pool_cuda.plan((4, 512, 256, 256, 16), F32, (0, 0))
    assert p.wide and p.grid[1] == pool_cuda.MAX_GRID_Y


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _misaligned(x):
    """x copied into a contiguous view whose data pointer is one element
    past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize('dt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,body', [
    ((2, 8, 6, 4, 5), 'scalar'),          # C = 5: no 16-byte vectors
    ((2, 8, 6, 4, 16), 'vec'),
    ((1, 6, 4, 10, 24), 'vec'),           # a row of 15 or 30 vectors
    ((2, 8, 6, 4, 16), 'misaligned'),     # the scalar body on a view
])
def test_pool_kernels_match_plain_on_card(cuda, dt, shape, body):
    x = torch.from_numpy(_quantized(7, shape, (1, 2, 3, 1, 4)))
    x = x.to(device=cuda, dtype=DTYPES[dt][0])
    if body == 'misaligned':
        x = _misaligned(x)
    out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4])
    g = torch.randn(out, device=cuda).to(x.dtype)
    before = _build.launches['pool2_fwd_vec']
    yk, yp = pool_cuda.pool2_fwd(x), pool._max_pool_tiled_fwd(x, (2, 2, 2))
    assert _build.launches['pool2_fwd_vec'] == before + (body == 'vec')
    dk = pool_cuda.pool2_bwd(x, g)
    dp = pool._max_pool_tiled_bwd(x, yp, g, (2, 2, 2))
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(yk), torch.isnan(yp))
    keep = ~torch.isnan(yp)
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    # the raw bits of the winning tap
    assert torch.equal(yk[keep].view(ity), yp[keep].view(ity))
    assert torch.equal(dk, dp)
