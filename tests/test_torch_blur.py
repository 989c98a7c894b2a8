"""
The PyTorch port's separable blur (`neurite_tpu_torch.utils.core.
separable_conv`, `ops.blur.separable_blur3d`, K6 in `ops/blur_cuda.py`)
against the JAX package's: `core.separable_conv` (the XLA path) and the
fused Pallas blur in interpret mode, at tap widths 1, 3 and 7 and at a width
longer than its axis; dx and the tap gradients against the JAX VJP; and
`gaussian_kernel` at a fixed sigma. The summation orders differ, so the
tolerance is 1e-5 of max|x|. K6 on the card: `test_torch_blur_cuda.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.ops import blur as jblur  # noqa: E402
from neurite_tpu.utils import core as jcore  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, blur, blur_cuda  # noqa: E402
from test_torch_blur_cuda import _taps  # noqa: E402

torch.set_num_threads(1)


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(scale).max()))


@pytest.mark.parametrize('widths', [(1, 3, 7), (7, 7, 7), (3, 1, 23),
                                    (25, 5, 1)])
@pytest.mark.parametrize('batched', [False, True])
def test_separable_conv_matches_jax(widths, batched):
    """3-D SAME blur of [B, D, H, W, C]; 23 and 25 taps exceed their
    axes (9 and 10 voxels), whose out-of-range taps meet zeros."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 9, 11, 3)).astype(np.float32)
    x = x if batched else x[0]
    ks = _taps(2, widths)
    want = jcore.separable_conv(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                                batched=batched)
    got = nt.utils.core.separable_conv(torch.from_numpy(x),
                                       [torch.from_numpy(k) for k in ks],
                                       batched=batched)
    assert got.shape == want.shape
    _close(got.numpy(), want, x)


@pytest.mark.parametrize('case', [
    dict(axis=[1], padding='SAME'),
    dict(axis=None, padding='VALID'),
    dict(axis=[0, 2], padding='SAME', strides=2),
    dict(axis=[1], padding='SAME', dilations=2),
])
def test_separable_conv_axes_strides_2d(case):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 11, 10, 2)).astype(np.float32)
    ks = _taps(4, [5])
    want = jcore.separable_conv(jnp.asarray(x), [jnp.asarray(ks[0])], **case)
    got = nt.utils.core.separable_conv(torch.from_numpy(x),
                                       [torch.from_numpy(ks[0])], **case)
    assert got.shape == want.shape
    _close(got.numpy(), want, x)
    x2 = x[..., 0, :]
    case2 = {**case, 'axis': [a for a in (case['axis'] or [0, 1]) if a < 2]}
    want = jcore.separable_conv(jnp.asarray(x2), [jnp.asarray(ks[0])],
                                **case2)
    got = nt.utils.core.separable_conv(torch.from_numpy(x2),
                                       [torch.from_numpy(ks[0])], **case2)
    _close(got.numpy(), want, x2)


@pytest.mark.parametrize('widths', [(1, 3, 7), (7, 5, 3), (9, 3, 1)])
def test_separable_blur3d_matches_pallas_blur(widths):
    """The fused Pallas blur in interpret mode (its domain: D a multiple of
    its z block, with the halo inside the volume)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 12)).astype(np.float32)
    ks = _taps(6, widths)
    want = jblur.separable_blur3d(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                                  impl='pallas', interpret=True)
    ref = jblur.separable_blur3d(jnp.asarray(x), [jnp.asarray(k) for k in ks],
                                 impl='jnp')
    tks = [torch.from_numpy(k) for k in ks]
    for impl in ('auto', 'pallas', 'jnp'):
        got = nt.ops.separable_blur3d(torch.from_numpy(x), tks, impl=impl,
                                      interpret=True)
        _close(got.numpy(), want, x)
        _close(got.numpy(), ref, x)


def _jax_blur_vjp(x, ks, g):
    """The Pallas blur's vjp of g, as one jitted program."""
    def run(x, ks, g):
        _, vjp = jax.vjp(lambda *a: jblur.separable_blur3d(
            a[0], a[1:], impl='pallas', interpret=True), x, *ks)
        return vjp(g)
    return [np.asarray(a) for a in jax.jit(run)(
        jnp.asarray(x), [jnp.asarray(k) for k in ks], jnp.asarray(g))]


def _port_blur_grads(fn, x, ks, g):
    xt = torch.from_numpy(x).requires_grad_()
    kt = [torch.from_numpy(k).requires_grad_() for k in ks]
    grads = torch.autograd.grad(fn(xt, kt), [xt, *kt], torch.from_numpy(g))
    return [a.numpy() for a in grads]


@pytest.mark.parametrize('widths', [(3, 1, 5), (7, 3, 3)])
def test_gradients_match_jax_vjp(widths):
    """dx and the three tap gradients: the port's plain autograd (CPU path)
    and K6's autograd function (its launches replaced by the plain passes,
    as there is no card here) against the Pallas blur's custom VJP."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 8, 10)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    ks = _taps(8, widths)
    want = _jax_blur_vjp(x, ks, g)
    plain = _port_blur_grads(
        lambda xt, kt: nt.ops.separable_blur3d(xt, kt), x, ks, g)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(blur, '_kernel', blur._plain)
        func = _port_blur_grads(
            lambda xt, kt: blur.SeparableBlur3d.apply(xt, *kt), x, ks, g)
    finally:
        mp.undo()
    for got in (plain, func):
        _close(got[0], want[0], g)
        for a, b in zip(got[1:], want[1:]):
            _close(a, b, b)


def test_width_longer_than_axis_and_identity():
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 4, 5, 6)).astype(np.float32))
    one = torch.ones(1)
    assert torch.equal(nt.ops.separable_blur3d(x, [one, one, one]), x)
    k = torch.zeros(21)
    k[10] = 2.
    out = nt.ops.separable_blur3d(x, [k, one, one])
    torch.testing.assert_close(out, 2 * x)
    with pytest.raises(ValueError, match='odd'):
        nt.ops.separable_blur3d(x, [torch.ones(2), one, one])


@pytest.mark.parametrize('sigma', [0.5, 1.3, [1., 2.5, 0.7]])
@pytest.mark.parametrize('separate', [True, False])
def test_gaussian_kernel_matches_jax(sigma, separate):
    want = jcore.gaussian_kernel(sigma, separate=separate)
    got = nt.utils.core.gaussian_kernel(sigma, separate=separate,
                                        device='cpu')
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_gaussian_kernel_random_and_tensor_sigma():
    gen = torch.Generator().manual_seed(0)
    ks = nt.utils.core.gaussian_kernel([2., 3.], random=True,
                                       min_sigma=[1., 2.9], separate=True,
                                       seed=gen, device='cpu')
    assert [k.numel() for k in ks] == [13, 19]
    for k in ks:
        torch.testing.assert_close(k.sum(), torch.tensor(1.))
    # a sigma drawn on the device with a static window: same taps as the
    # float sigma
    s = torch.tensor(1.7)
    a = nt.utils.core.gaussian_kernel([s], windowsize=[11], device='cpu')
    b = nt.utils.core.gaussian_kernel([1.7], windowsize=[11], device='cpu')
    torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match='windowsize'):
        nt.utils.core.gaussian_kernel([s])


def test_kernel_wrapper_checks_its_input():
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match='CUDA'):
        blur_cuda.blur_axis(x, torch.ones(3), 1)
    assert blur_cuda.plan((1, 128, 128, 128), 1, 165) == (
        'whole', 128, 165, 4 * (168 + 8 + 2 * 128 * 33))
    assert blur_cuda.plan((1, 128, 128, 128), 3, 165).body == 'whole'
    p = blur_cuda.plan((1, 512, 8, 8), 1, 6143)
    assert p.body == 'halo' and p.chunk < 6143 and p.smem <= 48 * 1024
    assert _build.launches['blur'] == 0
    assert _build.launches['blur_whole'] == 0


# the config #5 synthesis's blurs: the two Perlin SVF blurs, the bias field
# and the image blur
CONFIG5_BLURS = [((3, 64, 64, 64), 41), ((1, 128, 128, 128), 165),
                 ((1, 128, 128, 128), 7)]


@pytest.mark.parametrize('axis', [1, 2, 3])
@pytest.mark.parametrize('shape,width', CONFIG5_BLURS)
def test_plan_gives_config5_the_whole_axis_body(shape, width, axis):
    """Every launch of the path stages its columns over the whole axis
    with every tap, in one tile and one chunk, within 48 KB."""
    p = blur_cuda.plan(shape, axis, width)
    assert p.body == 'whole'
    assert (p.tile, p.chunk) == (shape[axis], width)
    assert p.smem <= blur_cuda.SMEM_LIMIT


@pytest.mark.parametrize('shape,axis,width,chunked', [
    ((1, 4096, 4, 4), 1, 165, False),     # a long axis
    ((1, 4, 4, 8192), 3, 41, False),
    ((1, 400, 2, 2), 1, 6143, True),      # the earlier widest, in chunks
    ((1, 2, 2, 100000), 3, 6143, True),
    ((1, 300, 8, 40), 1, 20001, True),
])
def test_plan_falls_back_to_halo_tiles(shape, axis, width, chunked):
    """Past 48 KB a block takes 64-row tiles with their halo, and, where
    the taps do not fit beside their rows, chunks of taps (a multiple of 4
    for the float4 tap loads); any width plans, within the launch's
    shared bytes."""
    p = blur_cuda.plan(shape, axis, width)
    assert p.body == 'halo' and p.tile == blur_cuda.HALO_TILE
    assert p.smem <= blur_cuda.SMEM_LIMIT
    assert p.smem == blur_cuda._smem(shape[axis], p.tile, p.chunk)
    assert (p.chunk < width) == chunked
    if chunked:
        assert p.chunk % 4 == 0 and p.chunk >= 64
    else:
        assert p.chunk == width


def test_plan_takes_every_width_up_to_6144_taps():
    """Every odd width that the earlier kernel took (to 6143 taps) plans
    on short, long and last axes, within the shared bytes the launcher
    sets."""
    for shape, axis in (((1, 20, 3, 5), 1), ((1, 128, 128, 128), 2),
                        ((1, 4, 4, 5000), 3)):
        for width in range(1, 6144, 34):
            p = blur_cuda.plan(shape, axis, width)
            assert p.smem <= blur_cuda.SMEM_LIMIT
            assert p.chunk == width or p.chunk % 4 == 0
