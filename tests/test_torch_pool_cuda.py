"""
K1 and K2 (`ops/csrc/pool.cu`, the 2x2x2 max pool's forward and first-max
backward) on the card against the port's plain pool, bit for bit, on
inputs quantized to halves (windows tie) with a NaN in one window: small
shapes, the flagship's three pool levels (config #5's too), config #3's
two, the space_to_depth=2 flagship's three, C = 7, and misaligned views;
each case by the body `pool_cuda.plan` picks, counted in
`launches['pool2_fwd_vec']`. Imports no JAX, so that it runs on the
machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pool_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu_torch.ops import _build, pool, pool_cuda  # noqa: E402

FLAGSHIP = [(1, 128, 128, 128, 16), (1, 64, 64, 64, 32), (1, 32, 32, 32, 64)]
CONFIG3 = [(1, 160, 160, 160, 8), (1, 80, 80, 80, 16)]
S2D = [(1, 64, 64, 64, 16), (1, 32, 32, 32, 32), (1, 16, 16, 16, 64)]


def _quantized(seed, shape, nan_at=None):
    """Halves (exact in bf16, many ties; +0. removes -0.), one optional NaN."""
    x = np.round(np.random.default_rng(seed).normal(size=shape) * 2) / 2 + 0.
    if nan_at is not None:
        x[nan_at] = np.nan
    return x.astype(np.float32)


def _misaligned(x):
    """x copied into a contiguous view whose data pointer is one element
    past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,body', [
    ((2, 8, 6, 4, 5), 'scalar'),          # C = 5: no 16-byte vectors
    ((2, 8, 6, 4, 16), 'vec'),
    ((1, 6, 4, 10, 24), 'vec'),           # a row of 15 or 30 vectors
    ((2, 8, 6, 4, 16), 'misaligned'),     # the scalar body on a view
    ((1, 32, 32, 32, 7), 'scalar'),       # C = 7
    *[(s, 'vec') for s in FLAGSHIP + CONFIG3 + S2D],
    *[(s, 'misaligned') for s in FLAGSHIP],
])
def test_pool_kernels_match_plain_on_card(cuda, dt, shape, body):
    nan_at = (shape[0] - 1, 2, 3, 1, 4)
    x = torch.from_numpy(_quantized(7, shape, nan_at))
    x = x.to(device=cuda, dtype=getattr(torch, dt))
    if body == 'misaligned':
        x = _misaligned(x)
    out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4])
    g = torch.randn(out, device=cuda).to(x.dtype)
    before = _build.launches['pool2_fwd_vec']
    yk, yp = pool_cuda.pool2_fwd(x), pool._max_pool_tiled_fwd(x, (2, 2, 2))
    assert _build.launches['pool2_fwd_vec'] == before + (body == 'vec')
    picked = pool_cuda.plan(x.shape, x.dtype, (x.data_ptr(), yk.data_ptr()))
    assert picked.body == ('vec' if body == 'vec' else 'scalar')
    dk = pool_cuda.pool2_bwd(x, g)
    dp = pool._max_pool_tiled_bwd(x, yp, g, (2, 2, 2))
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(yk), torch.isnan(yp))
    win = (nan_at[0], *(i // 2 for i in nan_at[1:4]), nan_at[4])
    assert bool(torch.isnan(yk[win]))     # the NaN window keeps its NaN
    keep = ~torch.isnan(yp)
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    # the raw bits of the winning tap
    assert torch.equal(yk[keep].view(ity), yp[keep].view(ity))
    assert torch.equal(dk, dp)
    # a window whose max is NaN equals nowhere: all 8 taps receive g
    taps = dk[(nan_at[0], *(slice(2 * w, 2 * w + 2) for w in win[1:4]),
               nan_at[4])]
    assert torch.equal(taps, g[win].expand(2, 2, 2))
