"""
The PyTorch port's soft-MI pieces against the JAX package's, on the same
numpy inputs: `utils.core.soft_quantize`, `ops.mi_histograms` on each route
('jnp' against JAX's jnp route, 'pallas' and 'plain' against JAX's Pallas
route in interpret mode: values and gradients, the centers' included),
`metrics.MutualInformation`, the rest of the metrics and losses, and
`regularizers.soft_l0_wrap`. On the card (`cuda` tests) K10 must agree
with the plain forward.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu import ops as jops  # noqa: E402
from neurite_tpu.utils import core as jcore  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, mi_hist, mi_hist_cuda  # noqa: E402
from neurite_tpu_torch.utils import core  # noqa: E402

torch.set_num_threads(1)


def _uniform(seed, shape, lo=0., hi=1.):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ----------------------------------------------------------- soft_quantize
SQ_CASES = {
    'centers': dict(bin_centers=np.linspace(0, 1, 8, dtype=np.float32),
                    nb_bins=None, alpha=30.),
    'derived': dict(nb_bins=12, alpha=50.),
    'default_bins': dict(alpha=10.),
    'clip': dict(nb_bins=6, alpha=20., min_clip=0.2, max_clip=0.7),
    'log': dict(bin_centers=[0., .5, 1.], nb_bins=None, alpha=4.,
                return_log=True),
    'log_clip_derived': dict(nb_bins=5, alpha=7., min_clip=.1,
                             return_log=True),
}


@pytest.mark.parametrize('case', sorted(SQ_CASES))
def test_soft_quantize_matches_jax(case):
    kw = SQ_CASES[case]
    x = _uniform(0, (2, 5, 6), -.2, 1.3)
    want = jcore.soft_quantize(x, **kw)
    got = core.soft_quantize(_t(x), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    # rtol 1e-6: one exp of the same float32 argument
    _close(got, want, rtol=1e-6, atol=1e-7)
    # the derived centers' gradient (through min and max) too
    jg = jax.grad(lambda a: jnp.sum(jcore.soft_quantize(a, **kw)
                                    * jnp.arange(want.shape[-1])))(x)
    xt = _t(x, True)
    (tg,) = torch.autograd.grad((core.soft_quantize(xt, **kw)
                                 * torch.arange(want.shape[-1])).sum(), xt)
    _close(tg, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    assert core.soft_digitize is core.soft_quantize


def test_soft_quantize_errors_and_linspace():
    with pytest.raises(ValueError, match='both bin_centers and nb_bins'):
        core.soft_quantize(_t(np.zeros(3, np.float32)), bin_centers=[0., 1.])
    for num in (1, 2, 7, 16):
        lo, hi = np.float32(-.3), np.float32(2.9)
        got = core.linspace(_t(lo), _t(hi), num)
        want = jnp.linspace(lo, hi, num)
        # one float32 rounding: XLA may fuse start*(1-s) + stop*s into FMAs
        _close(got, want, rtol=0, atol=np.spacing(np.float32(hi)))


def test_soft_delta_logistic_and_soft_l0_match_jax():
    x = np.random.default_rng(1).normal(scale=.05, size=(4, 6)).astype(
        np.float32)
    for kw in (dict(), dict(x0=.01, alpha=50, reg='l2')):
        _close(core.soft_delta(_t(x), **kw), jcore.soft_delta(x, **kw),
               rtol=1e-6, atol=1e-7)
    _close(core.logistic(_t(x), x0=.1, alpha=3., L=2.),
           jcore.logistic(x, x0=.1, alpha=3., L=2.), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match='reg'):
        core.soft_delta(_t(x), reg='l3')
    with pytest.raises(ValueError, match='slope'):
        core.logistic(_t(x), alpha=0.)
    for wt in (1., .3):
        want = ne.regularizers.soft_l0_wrap(wt)(x)
        got = nt.regularizers.soft_l0_wrap(wt)(_t(x))
        _close(got, want, rtol=1e-6, atol=0)
        xt = _t(x, True)
        (g,) = torch.autograd.grad(nt.regularizers.soft_l0_wrap(wt)(xt), xt)
        _close(g, jax.grad(ne.regularizers.soft_l0_wrap(wt))(x), rtol=1e-5,
               atol=1e-7)


# ----------------------------------------------------------- mi_histograms
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


@functools.cache
def _jax_hist(case, impl):
    """JAX's histograms and their gradients, one jitted program a case and
    route, shared by the port's routes."""
    x, y, cx, cy, alpha, (lo, hi), w = _hist_inputs(case)

    def loss(a, b, ca, cb):
        out = jops.mi_histograms(a, b, ca, alpha, min_clip=lo, max_clip=hi,
                                 impl=impl, interpret=True, bin_centers_y=cb)
        return sum(jnp.sum(wi * o) for wi, o in zip(w, out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(x, y, cx, cy)
    return out, grads


def _port_hist(case, impl):
    x, y, cx, cy, alpha, (lo, hi), w = _hist_inputs(case)
    ins = [_t(a, True) for a in (x, y, cx, cy)]
    out = nt.ops.mi_histograms(ins[0], ins[1], ins[2], alpha, min_clip=lo,
                               max_clip=hi, impl=impl, bin_centers_y=ins[3])
    loss = sum((_t(wi) * o).sum() for wi, o in zip(w, out))
    return out, torch.autograd.grad(loss, ins)


def _check_hist(out, grads, jout, jgrads):
    # the tolerance of tests/test_ops_kernels.py's Pallas checks: f32 sums
    # over up to 1000 voxels in another order
    for a, b in zip(out, jout):
        _close(a, b, rtol=1e-5, atol=1e-4)
    for a, b in zip(grads, jgrads):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize('case', sorted(HIST_SHAPES))
def test_mi_histograms_jnp_route_matches_jax_jnp(case):
    out, grads = _port_hist(case, 'jnp')
    jout, jgrads = _jax_hist(case, 'jnp')
    _check_hist(out, grads, jout, jgrads)
    assert float(grads[2].abs().max()) > 0   # the centers get gradient


@pytest.mark.parametrize('impl', ['pallas', 'plain'])
@pytest.mark.parametrize('case', sorted(HIST_SHAPES))
def test_mi_histograms_kernel_route_matches_jax_pallas(case, impl):
    out, grads = _port_hist(case, impl)
    jout, jgrads = _jax_hist(case, 'pallas')
    _check_hist(out, grads, jout, jgrads)
    # the custom VJP gives the centers zero, as mi_hist.py:167-168 does
    assert not torch.any(grads[2]) and not torch.any(grads[3])
    assert not np.any(jgrads[2]) and not np.any(jgrads[3])


def test_mi_histograms_routes_and_errors():
    x, y, cx, _, alpha, _, _ = _hist_inputs('2x1000_B16')
    xt, yt = _t(x), _t(y)
    # 'auto' on a CPU tensor is the jnp route: gradients reach the centers
    ct = _t(cx, True)
    out = nt.ops.mi_histograms(xt, yt, ct, alpha, impl='auto')
    (g,) = torch.autograd.grad(out[0].sum(), ct)
    assert float(g.abs().max()) > 0
    # alpha as a tensor on the kernel route: zero gradient, like the centers
    at = torch.tensor(alpha, requires_grad=True)
    ct = _t(cx, True)
    out = nt.ops.mi_histograms(_t(x, True), yt, ct, at, impl='pallas')
    ga, gc = torch.autograd.grad(out[0].sum() + out[1].sum(), (at, ct))
    assert float(ga) == 0 and not torch.any(gc)
    for a, b in zip(out, nt.ops.mi_histograms(xt, yt, cx, alpha, impl='jnp')):
        _close(a, b.detach(), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match='impl'):
        nt.ops.mi_histograms(xt, yt, cx, alpha, impl='xla')
    with pytest.raises(ValueError, match='CUDA'):
        mi_hist_cuda.mi_histograms_cuda(xt, yt, _t(cx), _t(cx), alpha)
    assert mi_hist_cuda._launch_blocks(0, 16, 1) == 1
    assert mi_hist_cuda._launch_blocks(1000, 16, 1) == 4   # 256-voxel tiles
    assert mi_hist_cuda._launch_blocks(128 ** 3, 16,
                                       1) == mi_hist_cuda.MAX_BLOCKS


@pytest.mark.parametrize('bs', [1, 3])
def test_mi_kernel_scratch_stays_bounded(bs):
    """K10's partial sums stay within SCRATCH_ENTRIES floats, or one
    block's sums a row (no larger than pxy), at every number of bins up to
    MAX_BINS; up to 64 bins the blocks are those of one per tile."""
    lb, n_vox = mi_hist_cuda._launch_blocks, 128 ** 3
    for nb in (1, 16, 64, 65, 128, 1024, 4096, mi_hist_cuda.MAX_BINS):
        nblk, entries = lb(n_vox, nb, bs), bs * nb * (nb + 2)
        assert 1 <= nblk <= mi_hist_cuda.MAX_BLOCKS
        assert nblk * entries <= max(mi_hist_cuda.SCRATCH_ENTRIES, entries)
        if nb <= 64:
            assert nblk == mi_hist_cuda.MAX_BLOCKS
    assert lb(n_vox, mi_hist_cuda.MAX_BINS, bs) == 1


@pytest.mark.parametrize('nb_bins,tile,groups', [
    (1, 256, 256), (5, 256, 64), (16, 256, 16), (17, 128, 10), (64, 64, 1),
    (65, 64, 1), (1024, 64, 1), (16320, 64, 1)])
def test_mi_kernel_plan(nb_bins, tile, groups):
    """K10's plan at every number of bins: its voxel tile (the most whose
    maps fit 32 KB), its voxel groups (256 threads over the 4 x 4 pair
    tiles, at most one a voxel of the tile), shared bytes within 48 KB for
    every pair of chunks and the scratch within SCRATCH_ENTRIES."""
    p = mi_hist_cuda.plan(nb_bins)
    assert (p.tile, p.groups) == (tile, groups)
    assert p.smem <= 48 * 1024
    for bx in mi_hist_cuda._chunk_sizes(nb_bins):
        for by in mi_hist_cuda._chunk_sizes(nb_bins):
            assert 4 * mi_hist_cuda._block_layout(bx, by, tile)[1] <= p.smem
    nblk = mi_hist_cuda._launch_blocks(128 ** 3, nb_bins, 1)
    assert nblk * nb_bins * (nb_bins + 2) <= max(
        mi_hist_cuda.SCRATCH_ENTRIES, nb_bins * (nb_bins + 2))


def test_mi_histograms_nan_reaches_the_sums_as_in_jax():
    x, y, cx, _, alpha, _, _ = _hist_inputs('1x700_B8_clip')
    x[0, 3] = np.nan
    for impl, jimpl in (('jnp', 'jnp'), ('pallas', 'pallas')):
        got = nt.ops.mi_histograms(_t(x), _t(y), cx, alpha, 0., 1.,
                                   impl=impl)
        want = jops.mi_histograms(x, y, cx, alpha, 0., 1., impl=jimpl,
                                  interpret=True)
        for a, b in zip(got, want):
            assert np.array_equal(np.isnan(a.numpy()), np.isnan(b))


# ------------------------------------------------------- MutualInformation
def _vols(seed, shape):
    return _uniform(seed, shape), _uniform(seed + 1, shape)


MI_KW = {
    'default': dict(),
    'bins8_clip': dict(nb_bins=8, min_clip=0., max_clip=1.),
    'centers': dict(bin_centers=np.linspace(-.1, 1.1, 10)),
    'alpha': dict(nb_bins=6, soft_bin_alpha=20.),
}


@pytest.mark.parametrize('kw', sorted(MI_KW))
def test_mutual_information_methods_match_jax(kw):
    mj = ne.metrics.MutualInformation(**MI_KW[kw])
    mt = nt.metrics.MutualInformation(**MI_KW[kw])

    def jx(fn, *args):   # the JAX side jitted: one compile, not one per op
        return jax.jit(fn)(*args)

    # rtol 1e-5, atol 1e-6 as tests/test_ops_kernels.py's MI check: MI is
    # a small sum of cancelling terms over sums in another order
    tol = dict(rtol=1e-5, atol=1e-6)
    x, y = _vols(3, (2, 6, 7, 8, 1))
    _close(mt.volumes(_t(x), _t(y)), jx(mj.volumes, x, y), **tol)
    want = jx(lambda a, b: mj.volumes_fused(a, b, impl='jnp'), x, y)
    for impl in ('jnp', 'pallas', 'plain', 'auto'):
        _close(mt.volumes_fused(_t(x), _t(y), impl=impl), want, **tol)
    c3 = _uniform(5, (2, 6, 6, 6, 3))
    d3 = _uniform(6, (2, 6, 6, 6, 3))
    _close(mt.channelwise(_t(c3), _t(d3)), jx(mj.channelwise, c3, d3), **tol)
    seg = np.random.default_rng(7).dirichlet(np.ones(4), size=(2, 6, 6, 6))
    seg2 = np.random.default_rng(8).dirichlet(np.ones(4), size=(2, 6, 6, 6))
    seg, seg2 = seg.astype(np.float32), seg2.astype(np.float32)
    _close(mt.segs(_t(seg), _t(seg2)), jx(mj.segs, seg, seg2), **tol)
    _close(mt.maps(_t(seg), _t(seg2)), jx(mj.maps, seg, seg2), **tol)
    v = x[:, :6, :6, :6]
    _close(mt.volume_seg(_t(v), _t(seg)), jx(mj.volume_seg, v, seg), **tol)
    _close(mt.volume_seg(_t(seg), _t(v)), jx(mj.volume_seg, seg, v), **tol)
    _close(mt._soft_prob_map(_t(x)), jx(mj._soft_prob_map, x), rtol=1e-5,
           atol=1e-7)
    _close(mt._soft_log_sim_map(_t(x)), jx(mj._soft_log_sim_map, x),
           rtol=1e-5, atol=1e-5)
    assert mt.soft_bin_alpha == float(np.float32(mj.soft_bin_alpha))


def test_mutual_information_volumes_grad_matches_jax():
    x, y = _vols(9, (1, 7, 7, 7, 1))
    mj = ne.metrics.MutualInformation(nb_bins=8)
    mt = nt.metrics.MutualInformation(nb_bins=8)
    jg = jax.jit(jax.grad(lambda a: jnp.sum(mj.volumes(a, y))))(x)
    xt = _t(x, True)
    (tg,) = torch.autograd.grad(mt.volumes(xt, _t(y)).sum(), xt)
    _close(tg, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_volumes_fused_gradient_differs_by_route_only_at_min_and_max():
    """The reference hazard: with centers derived from the data, JAX's jnp
    route differentiates through min/max(x) and its Pallas route gives the
    centers zero, so the two gradients differ at x's argmin and argmax
    only. Each port route equals its JAX route."""
    x, y = _vols(11, (1, 8, 8, 8, 1))
    mj = ne.metrics.MutualInformation(nb_bins=8)
    mt = nt.metrics.MutualInformation(nb_bins=8)
    grads = {}
    for impl in ('jnp', 'pallas'):
        jv, jg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(
            mj.volumes_fused(a, y, impl=impl, interpret=True))))(x)
        xt = _t(x, True)
        tv = mt.volumes_fused(xt, _t(y), impl=impl).sum()
        (tg,) = torch.autograd.grad(tv, xt)
        _close(tv, jv, rtol=1e-5, atol=1e-6)
        _close(tg, jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())
        grads[impl] = tg.numpy()
    diff = np.abs(grads['jnp'] - grads['pallas'])
    where = {tuple(i) for i in np.argwhere(diff > 1e-3 * diff.max())}
    assert where == {np.unravel_index(x.argmin(), x.shape),
                     np.unravel_index(x.argmax(), x.shape)}
    # and there it is no rounding: a tenth of the largest gradient or more
    assert diff.max() > .1 * np.abs(grads['jnp']).max()


def test_mutual_information_errors():
    mt = nt.metrics.MutualInformation()
    x, y = _vols(13, (1, 4, 4, 4, 1))
    seg = _uniform(14, (1, 4, 4, 4, 3))
    with pytest.raises(ValueError, match='outside range'):
        mt.maps(_t(-seg), _t(seg))
    nt.metrics.MutualInformation(check_input_limits=False).maps(_t(-seg),
                                                                _t(seg))
    with pytest.raises(ValueError, match='single-channel'):
        mt.volumes(_t(seg), _t(seg))
    with pytest.raises(ValueError, match='single-channel'):
        mt.volumes_fused(_t(seg), _t(seg))
    with pytest.raises(ValueError, match='multi-channel'):
        mt.volume_seg(_t(x), _t(y))
    with pytest.raises(ValueError, match='do not match'):
        mt.channelwise(_t(x), _t(seg))
    with pytest.raises(ValueError, match='both'):
        nt.metrics.MutualInformation(bin_centers=[0., 1.], nb_bins=2)


# ------------------------------------------------------- CCE, MSE, l1, l2
def _cce_inputs():
    rng = np.random.default_rng(15)
    t = np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=(2, 5, 6))]
    p = rng.random((2, 5, 6, 4)).astype(np.float32)
    p[0, 0, 0] = [1., 0., 0., 0.]        # hits the clip at both ends
    p[0, 0, 1] = 0.                      # a zero sum
    logits = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    sw = rng.random((2, 5, 6)).astype(np.float32)
    return t, p, logits, sw


CCE_CASES = {
    'probs': (dict(), False),
    'logits': (dict(from_logits=True), False),
    'weights': (dict(label_weights=[1., 2., .5, 0.]), False),
    'weights_logits_sw': (dict(label_weights=[1., 2., .5, 3.],
                               from_logits=True), True),
    'probs_sw': (dict(), True),
}


@pytest.mark.parametrize('case', sorted(CCE_CASES))
def test_categorical_crossentropy_matches_jax(case):
    kw, use_sw = CCE_CASES[case]
    t, p, logits, sw = _cce_inputs()
    pred = logits if kw.get('from_logits') else p
    swj = sw if use_sw else None
    swt = _t(sw) if use_sw else None
    for mod_j, mod_t, fn in ((ne.metrics, nt.metrics, 'cce'),
                             (ne.losses, nt.losses, 'loss')):
        cj = mod_j.CategoricalCrossentropy(**kw)
        ct = mod_t.CategoricalCrossentropy(**kw)
        want = getattr(cj, fn)(t, pred, sample_weight=swj)
        _close(getattr(ct, fn)(_t(t), _t(pred), sample_weight=swt), want,
               rtol=1e-6, atol=0)
        _close(ct(_t(t), _t(pred), swt), want, rtol=1e-6, atol=0)
    jg = jax.grad(lambda q: ne.metrics.CategoricalCrossentropy(**kw).cce(
        t, q, sample_weight=swj))(pred)
    pt = _t(pred, True)
    (tg,) = torch.autograd.grad(nt.metrics.CategoricalCrossentropy(
        **kw).cce(_t(t), pt, sample_weight=swt), pt)
    _close(tg, jg, rtol=1e-5, atol=1e-7)


def test_mse_prob_l1_l2_and_decorators_match_jax():
    t, p, _, sw = _cce_inputs()
    tt, pt = _t(t), _t(p)
    for kw in (dict(), dict(label_weights=[1., 2., .5, 0.])):
        for use_sw in (False, True):
            swj, swt = (sw[..., None], _t(sw[..., None])) if use_sw else \
                (None, None)
            want = ne.metrics.MeanSquaredErrorProb(**kw).mse(t, p, swj)
            _close(nt.metrics.MeanSquaredErrorProb(**kw)(tt, pt, swt), want,
                   rtol=1e-6, atol=0)
            _close(nt.losses.MeanSquaredErrorProb(**kw).loss(tt, pt, swt),
                   want, rtol=1e-6, atol=0)
    for name in ('l1', 'l2'):
        want = getattr(ne.metrics, name)(t, p)
        _close(getattr(nt.metrics, name)(tt, pt), want, rtol=1e-6, atol=0)
        _close(getattr(nt.losses, name)(tt, pt), want, rtol=1e-6, atol=0)
    assert nt.losses.MutualInformation is nt.metrics.MutualInformation
    for weights in (None, [.5, 2.]):
        want = ne.metrics.multiple_metrics_decorator(
            [ne.metrics.l1, ne.metrics.l2], weights)(t, p)
        got = nt.metrics.multiple_metrics_decorator(
            [nt.metrics.l1, nt.metrics.l2], weights)(tt, pt)
        _close(got, want, rtol=1e-6, atol=0)
        want = ne.losses.multiple_losses_decorator(
            [ne.losses.l2, ne.losses.MeanSquaredErrorProb().loss],
            weights)(t, p)
        got = nt.losses.multiple_losses_decorator(
            [nt.losses.l2, nt.losses.MeanSquaredErrorProb().loss],
            weights)(tt, pt)
        _close(got, want, rtol=1e-6, atol=0)


def test_label_weight_length_errors():
    t, p, _, _ = _cce_inputs()
    with pytest.raises(ValueError, match='Label weights must be of len 4'):
        nt.metrics.CategoricalCrossentropy(label_weights=[1., 2.])(_t(t),
                                                                   _t(p))
    with pytest.raises(ValueError, match='Label weights must be of len 4'):
        nt.metrics.MeanSquaredErrorProb(label_weights=[1., 2.])(_t(t), _t(p))


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(HIST_SHAPES))
def test_mi_kernel_matches_plain_on_card(cuda, case):
    x, y, cx, cy, alpha, (lo, hi), _ = _hist_inputs(case)
    xt, yt, ct, dt = (torch.from_numpy(a).to(cuda) for a in (x, y, cx, cy))
    _build.launches.clear()
    k = mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, alpha, lo, hi)
    k2 = mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, alpha, lo, hi)
    p = mi_hist._mi_histograms_plain(xt, yt, ct, dt, alpha, lo, hi)
    torch.cuda.synchronize()
    assert _build.launches['mi_hist'] == 2
    assert _build.launches['mi_hist_tiled'] == 2
    for a, b, a2 in zip(k, p, k2):
        # 1e-5 of the largest magnitude: another summation order
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
        assert torch.equal(a, a2)   # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize('nb_bins', [65, 128, 1024])
def test_mi_kernel_many_bins_on_card(cuda, nb_bins):
    """K10 past one 64-bin chunk (2 or 16 chunks each way; at 1024 bins
    with fewer blocks, so the scratch stays bounded) at [1, 32^3]."""
    rng = np.random.default_rng(nb_bins)
    x, y = (torch.from_numpy(rng.uniform(size=(1, 32 ** 3)).astype(
        np.float32)).to(cuda) for _ in range(2))
    c = torch.linspace(0., 1., nb_bins, device=cuda)
    alpha = nt.metrics.MutualInformation(nb_bins=nb_bins).soft_bin_alpha
    k = mi_hist_cuda.mi_histograms_cuda(x, y, c, c, alpha)
    k2 = mi_hist_cuda.mi_histograms_cuda(x, y, c, c, alpha)
    p = mi_hist._mi_histograms_plain(x, y, c, c, alpha)
    torch.cuda.synchronize()
    for a, b, a2 in zip(k, p, k2):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
        assert torch.equal(a, a2)


@pytest.mark.cuda
def test_mi_kernel_reads_a_tensor_alpha_on_card(cuda):
    """A CUDA 0-d alpha is read by the kernel: no host sync, and the bits
    of the float-alpha call."""
    x, y, cx, cy, alpha, _, _ = _hist_inputs('2x1000_B16')
    xt, yt, ct, dt = (torch.from_numpy(a).to(cuda) for a in (x, y, cx, cy))
    at = torch.tensor(alpha, dtype=torch.float32, device=cuda)
    want = mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, alpha)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = mi_hist_cuda.mi_histograms_cuda(xt, yt, ct, dt, at)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
