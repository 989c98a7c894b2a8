"""
K4 (`ops/csrc/interpn.cu`, the 3-D linear and nearest interpolation) on
the card against the port's plain gather chain, with points outside the
volume, on its upper edge and at half-integer ties, and at the paths'
shapes: config #5's [1, 64^3, 3] linear under a smooth +-8 voxel field
(and shifted by 20, or by 30 with a fill: most points out of range) and
its [1, 128^3, 1] nearest label warp at half-integer ties, the
registration's [1, 128^3, 1] linear warp within +-3, and [63, 65, 67]
points (a ragged last block). The 'vec' body that `warp_cuda.plan` picks
(counted in `launches['interpn_vec']`) gives the 'scalar' body's bits and
its own on a misaligned view of loc; linear within 1e-5 of the plain
version, nearest bit for bit; K4's gradient against plain autograd.
Imports no JAX, so that it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_warp_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, warp, warp_cuda  # noqa: E402
from test_torch_pool_cuda import _misaligned  # noqa: E402

SHAPE = (6, 7, 8)


def _grid(shape):
    return np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                                indexing='ij'), -1).astype(np.float32)


def _loc(seed, shape=SHAPE, spread=3.):
    """Grid + uniform displacement, with points outside the volume, on its
    upper edge (exactly the last index) and at half-integer ties."""
    rng = np.random.default_rng(seed)
    loc = _grid(shape) + rng.uniform(-spread, spread, size=(*shape, 3))
    loc = loc.astype(np.float32)
    top = np.asarray(shape, np.float32) - 1
    loc[0, 0, 0] = top                          # the last voxel
    loc[0, 0, 1] = [top[0], 2.25, top[2]]       # on two upper faces
    loc[0, 1, 0] = [2.5, 3.5, 0.5]              # ties: 2, 4, 0 (half even)
    loc[0, 1, 1] = [1.5, -0.5, 4.5]             # ties, one outside
    loc[1, 0, 0] = [-4., 2., 9.]                # outside on two axes
    loc[1, 0, 1] = [top[0] + 1e-3, 1., 1.]      # just beyond the edge
    return loc


def _vol(seed, shape, channels):
    rng = np.random.default_rng(seed)
    extra = () if channels is None else (channels,)
    return rng.normal(size=(*shape, *extra)).astype(np.float32)


def _smooth_field(shape, amp, gen):
    """A smooth [1, *shape, 3] displacement on the card with max |value| =
    amp: normal noise at 1/8 resolution, upsampled trilinearly."""
    low = torch.randn((1, 3, *[max(s // 8, 2) for s in shape]),
                      generator=gen, device='cuda')
    f = torch.nn.functional.interpolate(low, size=shape, mode='trilinear',
                                        align_corners=True)
    f = f.permute(0, 2, 3, 4, 1).contiguous()
    return f * (amp / f.abs().max())


def _grid_points(shape):
    return nt.utils.core.grid_points(shape, 'cuda')[None]


def _path_case(name, gen):
    """(vol, loc, method, fill) of one of the paths' calls."""
    v64, v128 = (64,) * 3, (128,) * 3
    if name == 'labels_128_nearest_ties':
        # every point on a half-integer or integer: round-half-even's ties
        lab = torch.randint(0, 16, (1, *v128, 1), generator=gen,
                            device='cuda').float()
        loc = torch.round(2 * (_grid_points(v128)
                               + _smooth_field(v128, 8., gen))) / 2
        return lab, loc, 'nearest', 0.
    if name == 'registration_128_linear':
        # an image at the grid plus a field clamped to +-3 voxels, as
        # `batch_transform` calls K4 in the registration step
        img = torch.rand((1, *v128, 1), generator=gen, device='cuda')
        loc = _grid_points(v128) + torch.clamp(
            _smooth_field(v128, 4., gen), -3., 3.)
        return img, loc, 'linear', None
    vol = torch.randn((1, *v64, 3), generator=gen, device='cuda')
    if name == 'odd_points_linear':
        odd = (63, 65, 67)
        return (vol, _grid_points(odd) + _smooth_field(odd, 8., gen),
                'linear', None)
    shift, fill = {'smooth_64_linear': (0., None),
                   'shifted_64_linear': (20., None),
                   'out_of_range_64_fill': (30., 2.5)}[name]
    return (vol, _grid_points(v64) + _smooth_field(v64, 8., gen) + shift,
            'linear', fill)


def _check_bodies(vol, loc, method, fill):
    """K4 by its 'vec' body against its 'scalar' body, on a misaligned
    view of loc, and against the plain version: the same bits (linear
    against the plain version within 1e-5)."""
    bad = _misaligned(loc)
    assert warp_cuda.plan(vol, loc) == 'vec'
    _build.launches.clear()
    k = warp_cuda.interpn3d(vol, loc, method, fill)
    m = warp_cuda.interpn3d(vol, bad, method, fill)
    assert _build.launches['interpn_vec'] == 2
    s = torch.empty_like(k)
    warp_cuda._launch(vol, loc, s, method, fill, 'scalar')
    p = nt.utils.core.interpn_plain(vol, loc, method, fill, batched=True)
    torch.cuda.synchronize()
    for o in (m, s):
        assert torch.equal(k.view(torch.int32), o.view(torch.int32))
    if method == 'nearest':
        assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    else:
        torch.testing.assert_close(k, p, rtol=0, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_kernel_matches_plain_on_card(cuda, method):
    vol = torch.from_numpy(_vol(16, (2, 9, 10, 11), 3)).to(cuda)
    loc = torch.from_numpy(np.stack([_loc(17, (9, 10, 11)),
                                     _loc(18, (9, 10, 11))])).to(cuda)
    before = _build.launches['interpn']
    k = warp.interpn_batch(vol, loc, method, 0.)
    p = nt.utils.core.interpn_plain(vol, loc, method, 0., batched=True)
    torch.cuda.synchronize()
    assert _build.launches['interpn'] == before + 1
    assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize('channels', [1, 3, 5])
@pytest.mark.parametrize('fill', [None, 0.])
@pytest.mark.parametrize('method', ['linear', 'nearest'])
def test_vec_body_matches_scalar_and_plain_on_card(cuda, method, fill,
                                                   channels):
    """At a ragged P (9 x 10 x 11 points), with points outside the
    volume, on its upper edge and at half-integer ties."""
    shape = (9, 10, 11)
    vol = torch.from_numpy(_vol(19, (2, *shape), channels)).to(cuda)
    loc = torch.from_numpy(np.stack([_loc(20, shape),
                                     _loc(21, shape)])).to(cuda)
    _check_bodies(vol, loc, method, fill)


@pytest.mark.cuda
@pytest.mark.parametrize('case', [
    'smooth_64_linear', 'shifted_64_linear', 'labels_128_nearest_ties',
    'registration_128_linear', 'odd_points_linear', 'out_of_range_64_fill'])
def test_vec_body_at_path_shapes_on_card(cuda, case):
    gen = torch.Generator(device='cuda').manual_seed(7)
    _check_bodies(*_path_case(case, gen))


@pytest.mark.cuda
def test_kernel_gradient_matches_plain_autograd_on_card(cuda):
    """dvol and dloc of K4's autograd function against plain autograd
    through the gather chain, linear at 32^3: within 1e-5."""
    gen = torch.Generator(device='cuda').manual_seed(8)
    v32 = (32,) * 3
    vol = torch.randn((1, *v32, 3), generator=gen, device='cuda')
    loc = _grid_points(v32) + _smooth_field(v32, 4., gen)
    g = torch.randn((1, *v32, 3), generator=gen, device='cuda')
    grads = []
    for fn in (lambda v, lc: warp_cuda.interpn3d(v, lc, 'linear', None),
               lambda v, lc: nt.utils.core.interpn_plain(
                   v, lc, 'linear', None, batched=True)):
        v, lc = vol.clone().requires_grad_(), loc.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(v, lc), (v, lc), g))
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
