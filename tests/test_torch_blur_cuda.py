"""
K6 (`ops/csrc/blur.cu`, one SAME pass of the separable 3-D blur) on the
card against the port's plain per-axis convs: one pass at ragged shapes
(lengths and columns not multiples of 8 or 32, one tap, a window wider
than its axis, long axes in 64-row tiles, taps in chunks) and at config
#5's three blurs ([3, 64^3] with 41 taps, [1, 128^3] with 165 and with 7),
each by the body `blur_cuda.plan` names ('whole', counted in
`launches['blur_whole']`, or 'halo'); the three passes, and their
gradients (dx by K6 with the taps flipped, the taps' in plain torch),
against autograd through the plain convs. The sums run in other orders:
within 1e-5 of the largest magnitude (the taps' gradients, sums over up to
2M products, within 1e-4). Imports no JAX, so that it runs on the machine
with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_blur_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, blur, blur_cuda  # noqa: E402

# config #5's synthesis: the two Perlin SVF blurs, the bias field and the
# image blur
CONFIG5 = [((3, 64, 64, 64), 41), ((1, 128, 128, 128), 165),
           ((1, 128, 128, 128), 7)]


def _taps(seed, widths):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1, 1., size=w).astype(np.float32) for w in widths]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # the plain convs in float32
    yield torch.device('cuda')
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize('shape,axis,width,body', [
    ((2, 21, 5, 6), 1, 7, 'whole'),       # L not a multiple of 8, post 30
    ((1, 37, 5, 6), 1, 7, 'whole'),       # L and post (30) not of 8 or 32
    ((3, 7, 5, 29), 3, 41, 'whole'),      # post 1, pre 105 not of 32
    ((2, 6, 5, 11), 2, 1, 'whole'),       # one tap
    ((1, 20, 9, 40), 1, 165, 'whole'),    # 165 taps on a 20-voxel axis
    ((2, 20, 33, 45), 1, 165, 'whole'),
    ((1, 1000, 3, 3), 1, 165, 'halo'),    # halo tiles
    ((1, 4096, 4, 4), 1, 165, 'halo'),
    ((1, 3, 2, 500), 3, 2001, 'halo'),    # halo tiles, taps in chunks
    ((1, 400, 8, 40), 1, 1001, 'halo'),   # taps in chunks, post 320
    ((1, 4, 4, 300), 3, 6143, 'halo'),    # taps in chunks, post 1
    *[(s, a, w, 'whole') for s, w in CONFIG5 for a in (1, 2, 3)],
])
def test_kernel_pass_matches_plain_on_card(cuda, shape, axis, width, body):
    """One K6 pass by the body `plan` names."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    k = torch.from_numpy(_taps(13, [width])[0]).to(cuda)
    assert blur_cuda.plan(shape, axis, width).body == body
    before = _build.launches['blur_whole']
    got = blur_cuda.blur_axis(x, k, axis)
    want = nt.utils.core.conv_axis(x, k, axis - 1)
    torch.cuda.synchronize()
    assert _build.launches['blur_whole'] == before + (body == 'whole')
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('shape,widths', [
    ((2, 20, 33, 40), (7, 7, 7)), ((2, 20, 33, 40), (41, 3, 1)),
    ((2, 20, 33, 40), (165, 165, 165)),
    *[(s, (w,) * 3) for s, w in CONFIG5],
])
def test_kernel_matches_plain_on_card(cuda, shape, widths):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    ks = [torch.from_numpy(k).to(cuda) for k in _taps(11, widths)]
    before = _build.launches['blur']
    k = nt.ops.separable_blur3d(x, ks)
    p = blur._plain(x, ks)
    torch.cuda.synchronize()
    assert _build.launches['blur'] == before + 3
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    grads = []
    for fn in (blur.blur3d, blur._plain):
        xi = x.clone().requires_grad_()
        ki = [t.clone().requires_grad_() for t in ks]
        grads.append(torch.autograd.grad(fn(xi, ki), [xi, *ki], g))
    torch.cuda.synchronize()
    (dxk, *dkk), (dxp, *dkp) = grads
    assert float((dxk - dxp).abs().max()) <= 1e-5 * float(dxp.abs().max())
    for a, b in zip(dkk, dkp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
