"""
K10 (`ops/csrc/mi_hist.cu`, the fused soft-MI histograms) on the card
against the port's plain forward: within 1e-5 of the largest magnitude
(another summation order), NaN where the plain version has it, two calls
bit-equal, each by the 'tiled' body (`launches['mi_hist_tiled']`): at the
reference's small cases, at the registration path's [1, 128^3] with 16
bins and centers from the data (and with a NaN voxel), at [1, 128^3 + 37],
8 bins clipped to [0, 1], and 5 to 1024 bins (past one 64-bin chunk). A
CUDA 0-d alpha is read on the card, without a host sync, through the
wrapper and `ops.mi_histograms`; the K10 route's backward against the plain
route's. Imports no JAX, so that it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mi_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, mi_hist, mi_hist_cuda  # noqa: E402

HIST_SHAPES = {   # (bs, V, B, alpha, clip, input range), as
    # tests/test_ops_kernels.py's Pallas checks use them
    '2x1000_B16': (2, 1000, 16, 150., (-np.inf, np.inf), (0., 1.)),
    '1x700_B8_clip': (1, 700, 8, 40., (0., 1.), (-1., 2.)),
    # past one 64-bin chunk of K10: the reference takes any number of bins
    '1x300_B65': (1, 300, 65, 1000., (-np.inf, np.inf), (0., 1.)),
    # bins that K10's 4 x 4 pair tiles do not divide
    '1x500_B5': (1, 500, 5, 12., (-np.inf, np.inf), (0., 1.)),
    '2x400_B17': (2, 400, 17, 160., (-np.inf, np.inf), (0., 1.)),
}
# the registration path's [1, 128^3] pair and its neighbours
PATH_SHAPES = ('pair_128_B16', 'pair_128_B16_nan', 'ragged_128_B16',
               'clip_128_B8')


def _hist_inputs(case):
    bs, n, nb, alpha, clip, (lo, hi) = HIST_SHAPES[case]
    rng = np.random.default_rng(2)
    x = rng.uniform(lo, hi, size=(bs, n)).astype(np.float32)
    y = rng.uniform(lo, hi, size=(bs, n)).astype(np.float32)
    cx = np.linspace(0., 1., nb, dtype=np.float32)
    cy = np.linspace(-.1, 1.1, nb, dtype=np.float32)
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((bs, nb, nb), (bs, nb), (bs, nb))]
    return x, y, cx, cy, alpha, clip, w


def _pair(size):
    """The registration pair, a 3-D version of
    `examples/deformable_registration.py`: blobs at 0.45 and 0.55 of the
    size, 0.02 normal noise, values near [0, 1]; [1, size^3] float32 on the
    card."""
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing='ij'), -1)
    out = []
    for at, width in ((0.45, 0.8), (0.55, 1.2)):
        v = np.exp(-((grid - size * at) ** 2).sum(-1) / (size * width))
        v = v + 0.02 * rng.normal(size=v.shape)
        out.append(torch.from_numpy(v.astype(np.float32)).cuda().reshape(
            1, -1))
    return out


def _path_inputs(case):
    """(x, y, cx, cy, alpha, clip) of a [1, 128^3]-sized case on the card."""
    n, alpha = 128 ** 3, nt.metrics.MutualInformation(
        nb_bins=16).soft_bin_alpha
    unit = torch.linspace(0., 1., 16, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(13)
    if case.startswith('pair'):
        x, y = _pair(128)
        if case.endswith('nan'):
            x[0, 12345] = float('nan')
            return x, y, unit, unit, alpha, (-np.inf, np.inf)
        centers = [nt.utils.core.linspace(v.min(), v.max(), 16)
                   for v in (x, y)]
        return x, y, *centers, alpha, (-np.inf, np.inf)
    if case.startswith('ragged'):
        x, y = (torch.rand((1, n + 37), generator=gen, device='cuda')
                for _ in range(2))
        return x, y, unit, unit, alpha, (-np.inf, np.inf)
    x, y = (torch.rand((1, n), generator=gen, device='cuda') * 3 - 1
            for _ in range(2))
    c8 = torch.linspace(0., 1., 8, device='cuda')
    return (x, y, c8, c8,
            nt.metrics.MutualInformation(nb_bins=8).soft_bin_alpha, (0., 1.))


def _card_inputs(case):
    if case in HIST_SHAPES:
        x, y, cx, cy, alpha, clip, _ = _hist_inputs(case)
        return (*(torch.from_numpy(a).cuda() for a in (x, y, cx, cy)),
                alpha, clip)
    return _path_inputs(case)


def _check_kernel(x, y, cx, cy, alpha, lo=-np.inf, hi=np.inf):
    """K10 by its 'tiled' body against the plain forward: within 1e-5 of
    the largest magnitude, NaN where the plain version has it; a second
    call gives the same bits (no atomics)."""
    _build.launches.clear()
    k = mi_hist_cuda.mi_histograms_cuda(x, y, cx, cy, alpha, lo, hi)
    k2 = mi_hist_cuda.mi_histograms_cuda(x, y, cx, cy, alpha, lo, hi)
    p = mi_hist._mi_histograms_plain(x, y, cx, cy, alpha, lo, hi)
    torch.cuda.synchronize()
    assert _build.launches['mi_hist'] == 2
    assert _build.launches['mi_hist_tiled'] == 2
    for a, b, a2 in zip(k, p, k2):
        # 1e-5 of the largest magnitude: another summation order (a NaN
        # voxel makes every sum it reaches NaN)
        finite = b[~torch.isnan(b)]
        scale = float(finite.abs().max()) if finite.numel() else 0.
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale,
                                   equal_nan=True)
        assert torch.equal(a.nan_to_num(), a2.nan_to_num())
        assert torch.equal(torch.isnan(a), torch.isnan(a2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(HIST_SHAPES) + list(PATH_SHAPES))
def test_mi_kernel_matches_plain_on_card(cuda, case):
    x, y, cx, cy, alpha, (lo, hi) = _card_inputs(case)
    _check_kernel(x, y, cx, cy, alpha, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize('nb_bins,size', [
    (65, 32), (128, 32), (1024, 32), (5, 64), (17, 64), (65, 64), (128, 64)])
def test_mi_kernel_many_bins_on_card(cuda, nb_bins, size):
    """K10 at bins that its 4 x 4 pair tiles do not divide and past one
    64-bin chunk (2 or 16 chunks each way; at 1024 bins with fewer blocks,
    so the scratch stays bounded)."""
    rng = np.random.default_rng(nb_bins)
    x, y = (torch.from_numpy(rng.uniform(size=(1, size ** 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    c = torch.linspace(0., 1., nb_bins, device=cuda)
    alpha = nt.metrics.MutualInformation(nb_bins=nb_bins).soft_bin_alpha
    _check_kernel(x, y, c, c, alpha)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['2x1000_B16', 'pair_128_B16'])
def test_mi_kernel_reads_a_tensor_alpha_on_card(cuda, case):
    """A CUDA 0-d alpha is read by the kernel, through the wrapper and
    through the entry point's K10 route: no host sync, and the bits of the
    float-alpha call."""
    xt, yt, ct, dt, alpha, _ = _card_inputs(case)
    at = torch.tensor(alpha, dtype=torch.float32, device=cuda)
    want = mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, alpha)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = (mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, at),
               nt.ops.mi_histograms(xt, yt, ct, at, impl='pallas',
                                    bin_centers_y=dt))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for out in got:
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_mi_histograms_backward_matches_plain_route_on_card(cuda):
    """`MIHistograms`' dx and dy on the K10 route ('pallas') against
    autograd through the plain route at the registration's [1, 128^3], 16
    bins, centers from the data: within 1e-5 of the largest magnitude."""
    x, y, cx, cy, alpha, _ = _path_inputs('pair_128_B16')
    gen = torch.Generator(device='cuda').manual_seed(14)
    w = [torch.randn(s, generator=gen, device='cuda')
         for s in ((1, 16, 16), (1, 16), (1, 16))]
    grads = []
    for impl in ('pallas', 'plain'):
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = nt.ops.mi_histograms(xi, yi, cx, alpha, impl=impl,
                                   bin_centers_y=cy)
        grads.append(torch.autograd.grad(
            sum((wi * o).sum() for wi, o in zip(w, out)), (xi, yi)))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
