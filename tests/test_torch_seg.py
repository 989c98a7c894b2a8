"""
The PyTorch port's serve path (`io.tiling`, `utils.seg`) against the JAX
package's: patch order, the host quilt's mean, nan-mean and nan-median,
the on-device quilt, `predict_volumes` and `predict_volume_device` of a
2-level UNet (JAX's initial weights moved by `convert.load_flax_params`),
`recode` and the label helpers.

Tolerances: the grid, the label maps and the quilts of equal inputs are
exact; float32 model outputs within 1e-5; a bfloat16 model's within 2e-2
(XLA and torch round each bf16 conv's sums differently), and its bf16
overlap-mean accumulation within 2 ** -6 of the float64 host quilt of the
same patch predictions: values in [0, 1], up to 8 layers, each bf16 add
off by at most half an ulp of its partial sum (2 ** -8 at 2, 2 ** -7 up
to 4, 2 ** -6 up to 8: at most 0.082 on the sum, 0.0103 on the mean) and
the bf16 division by half an ulp of the mean (2 ** -9).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.io import tiling as jtiling  # noqa: E402
from neurite_tpu.utils import seg as jseg  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402
from neurite_tpu_torch.io import tiling  # noqa: E402
from neurite_tpu_torch.utils import seg  # noqa: E402

torch.set_num_threads(1)

VOL = (16, 16, 16)
PATCH = (8, 8, 8)
STRIDE = 4      # a 3^3 grid, 8 overlapping layers in the middle
UNET = dict(nb_features=4, nb_levels=2, conv_size=3, nb_labels=3,
            feat_mult=2, nb_conv_per_level=2)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


###############################################################################
# tiling
###############################################################################

@pytest.mark.parametrize('vol_shape,patch,stride', [
    ((16, 16, 16), (8, 8, 8), 4),
    ((17, 12, 9), (8, 5, 9), (3, 4, 2)),   # clamped last patches
    ((10, 7), 5, None),
    ((20,), (6,), 7),
])
def test_patch_grid_and_order(vol_shape, patch, stride):
    assert tiling.patch_starts(vol_shape, patch, stride) == \
        jtiling.patch_starts(vol_shape, patch, stride)
    assert tiling.grid_size(vol_shape, patch, stride) == \
        jtiling.grid_size(vol_shape, patch, stride)
    vol = _normal(0, (*vol_shape, 2))
    ndims = len(vol_shape)
    psize = patch if not np.isscalar(patch) else (patch,) * ndims
    want = list(jtiling.patch_gen(vol, psize, stride))
    got = list(tiling.patch_gen(vol, psize, stride))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a tensor's patches are views of it, in the same order
    tgot = list(tiling.patch_gen(torch.from_numpy(vol), psize, stride))
    for g, w in zip(tgot, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _stack(seed, dtype, nan_share=0.):
    """27 patches of the 16^3 grid, some voxels NaN."""
    p = np.random.default_rng(seed).normal(size=(27, *PATCH))
    if nan_share:
        p[np.random.default_rng(seed + 1).random(p.shape) < nan_share] = np.nan
    return p.astype(dtype)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('agg', ['mean', 'nanmean', 'nanmedian'])
def test_quilt_vs_jax(agg, dtype):
    """The host quilt. JAX's float32 nan-median runs its native library
    (nth_element), the port np.nanmedian: equal, 8 layers (an even count:
    the mean of the two middle values) and odd counts at the borders."""
    p = _stack(1, dtype, nan_share=.2 if agg != 'mean' else 0.)
    want = jtiling.quilt(p, PATCH, VOL, STRIDE, agg=agg)
    got = tiling.quilt(p, PATCH, VOL, STRIDE, agg=agg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('agg', ['mean', 'nanmean', 'nanmedian'])
def test_quilt_of_patches_is_identity(agg):
    vol = _normal(2, VOL)
    patches = np.stack(list(tiling.patch_gen(vol, PATCH, STRIDE)))
    out = tiling.quilt(patches, PATCH, VOL, STRIDE, agg=agg)
    np.testing.assert_allclose(out, vol, rtol=1e-6, atol=0)
    # stride = patch size: no overlap, exact
    patches = np.stack(list(tiling.patch_gen(vol, PATCH)))
    np.testing.assert_array_equal(tiling.quilt(patches, PATCH, VOL, agg=agg),
                                  vol)
    dev = tiling.quilt_device(torch.from_numpy(patches), PATCH, VOL)
    np.testing.assert_array_equal(dev.numpy(), vol)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('agg', ['mean', 'nanmean', 'sum'])
def test_quilt_device_vs_jax(agg, dtype):
    """Bit for bit: both accumulate in the patches' dtype in patch order
    and divide by the float32 count cast to that dtype."""
    p = _stack(3, np.float32, nan_share=.2 if agg == 'nanmean' else 0.)
    p = np.concatenate([p[..., None], 2 * p[..., None]], -1)   # trailing C
    jp = jnp.asarray(p, dtype)
    want = jtiling.quilt_device(jp, PATCH, VOL, STRIDE, agg=agg)
    tp = torch.from_numpy(p).to(getattr(torch, dtype))
    got = tiling.quilt_device(tp, PATCH, VOL, STRIDE, agg=agg)
    assert got.dtype == tp.dtype and tuple(got.shape) == (*VOL, 2)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_quilt_device_uncovered_is_nan():
    """0/0 = NaN where no valid value covers a voxel; the count is per
    element under 'nanmean'."""
    p = _stack(4, np.float32)
    p[:, 0, 0, 0] = np.nan    # voxel (0, 0, 0) is covered by patch 0 only
    got = tiling.quilt_device(torch.from_numpy(p), PATCH, VOL, STRIDE,
                              agg='nanmean').numpy()
    want = np.asarray(jtiling.quilt_device(jnp.asarray(p), PATCH, VOL,
                                           STRIDE, agg='nanmean'))
    assert np.isnan(got[0, 0, 0]) and np.isnan(want[0, 0, 0])
    np.testing.assert_array_equal(got, want)


###############################################################################
# whole-volume inference
###############################################################################

def _unet(dtype=None):
    """The JAX 2-level UNet and the port's with JAX's initial weights."""
    jm = ne.models.unet(**UNET, input_shape=(*PATCH, 1),
                        dtype=None if dtype is None else jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, *PATCH, 1)))
    tm = nt.models.unet(**UNET, input_shape=(*PATCH, 1), device='cpu',
                        dtype=dtype)
    convert.load_flax_params(tm, variables['params'])
    japply = jax.jit(lambda x: jm.apply(variables, x))
    return japply, tm


def _gen(vol, batch=1):
    """Patch batches of vol [*VOL, 1] in patch_gen order, with one-hot
    'true' labels from its sign."""
    patches = np.stack(list(tiling.patch_gen(vol, PATCH, STRIDE)))
    lab = np.eye(3, dtype=np.float32)[(patches[..., 0] > 0).astype(int)
                                      + (patches[..., 0] > 1)]
    for i in range(0, len(patches), batch):
        yield patches[i:i + batch], lab[i:i + batch]


@pytest.mark.parametrize('nan_func', ['nanmedian', 'nanmean'])
def test_predict_volumes_vs_jax(nan_func):
    japply, tm = _unet()
    vol = _normal(5, (*VOL, 1))
    kw = dict(nan_func=nan_func, do_extra_vol=True, do_prob_of_true=True)
    want = jseg.predict_volumes(japply, _gen(vol), 1, PATCH, STRIDE, VOL,
                                **kw)
    got = seg.predict_volumes(tm, _gen(vol, 2), 2, PATCH, STRIDE, VOL,
                              device='cpu', **kw)
    assert len(got) == len(want) == 5
    # label maps and the input exact; the probabilities of float32 outputs
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == VOL and g.dtype == np.float64
        if i < 3:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert got[0].min() >= 0 and got[0].max() <= 2
    assert tm.training   # put back in its mode after the eval-mode run


def test_predict_volume_stack_and_bare_inputs():
    japply, tm = _unet()
    vol = _normal(6, (*VOL, 1))
    bare = (x for x, _ in _gen(vol))
    v, t, p = seg.predict_volume_stack(lambda x: tm(x), bare, 1, 5,
                                       device='cpu')
    jv, _, jp = jseg.predict_volume_stack(japply, (x for x, _ in _gen(vol)),
                                          1, 5)
    assert t is None and v.shape == (5, *PATCH, 1) and p.shape == (5, *PATCH, 3)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)
    out = seg.predict_volumes(tm, (x for x, _ in _gen(vol)), 1, PATCH,
                              STRIDE, VOL, device='cpu')
    assert len(out) == 2 and out[1] is None


def test_predict_volume_device_vs_jax_f32():
    japply, tm = _unet()
    vol = _normal(7, (*VOL, 1))
    for agg in ('mean', 'sum'):
        want = np.asarray(jseg.predict_volume_device(
            japply, jnp.asarray(vol), PATCH, STRIDE, agg=agg))
        got = seg.predict_volume_device(tm, torch.from_numpy(vol), PATCH,
                                        STRIDE, agg=agg)
        assert got.dtype == torch.float32 and tuple(got.shape) == (*VOL, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # = the host quilt of the same patch predictions
    preds = np.stack([tm(torch.from_numpy(x)).detach().numpy()[0]
                      for x, _ in _gen(vol)])
    host = np.stack([tiling.quilt(preds[..., c], PATCH, VOL, STRIDE,
                                  agg='mean') for c in range(3)], -1)
    mean = seg.predict_volume_device(tm, vol, PATCH, STRIDE, device='cpu')
    np.testing.assert_allclose(mean.numpy(), host, rtol=1e-6, atol=1e-7)


def test_predict_volume_device_bf16_accumulates_in_bf16():
    """A bf16 model: the accumulator is bf16, as JAX's (pinned: the port's
    result equals its own bf16 quilt_device of the patch predictions bit
    for bit), within 2 ** -6 of the float64 host quilt of those
    predictions (see the module's docstring), and within 2e-2 of JAX's
    bf16 run."""
    japply, tm = _unet(torch.bfloat16)
    vol = _normal(8, (*VOL, 1))
    got = seg.predict_volume_device(tm, torch.from_numpy(vol), PATCH, STRIDE)
    assert got.dtype == torch.bfloat16
    with torch.no_grad():
        preds = torch.cat([tm(torch.from_numpy(x), training=False)
                           for x, _ in _gen(vol)])
    assert preds.dtype == torch.bfloat16
    own = tiling.quilt_device(preds, PATCH, VOL, STRIDE)
    assert torch.equal(got, own)
    p64 = preds.double().numpy()
    host = np.stack([tiling.quilt(p64[..., c], PATCH, VOL, STRIDE, agg='mean')
                     for c in range(3)], -1)
    err = np.abs(got.double().numpy() - host).max()
    assert err <= 2 ** -6, err
    want = jseg.predict_volume_device(japply, jnp.asarray(vol), PATCH, STRIDE)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_predict_volume_device_restores_training_mode():
    _, tm = _unet()
    tm.train()
    seg.predict_volume_device(tm, torch.zeros(*VOL, 1), PATCH, 8)
    assert tm.training
    with pytest.raises(ValueError):
        seg.predict_volume_device(tm, torch.zeros(*VOL, 1), PATCH, agg='max')


###############################################################################
# labels
###############################################################################

@pytest.mark.parametrize('mapping', [
    {0: 0, 1: 5, 2: 7, 4: 1},
    [3, 2, 1, 0],
])
def test_recode_vs_jax(mapping):
    lab = np.random.default_rng(9).integers(-2, 8, size=(5, 6, 7))
    want = np.asarray(jseg.recode(lab, mapping))
    got = seg.recode(torch.from_numpy(lab), mapping)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(seg.recode(lab, mapping,
                                             device='cpu').numpy(), want)


def test_label_helpers_vs_jax():
    rng = np.random.default_rng(10)
    pred = rng.random((2, 4, 5, 3)).astype(np.float32)
    lab = rng.integers(0, 3, size=(2, 4, 5))
    np.testing.assert_array_equal(seg.pred_to_label(torch.from_numpy(pred)),
                                  jseg.pred_to_label(pred))
    np.testing.assert_array_equal(seg.sample_to_label(pred),
                                  jseg.sample_to_label(pred))
    np.testing.assert_array_equal(
        seg.prob_of_label(torch.from_numpy(pred), lab),
        jseg.prob_of_label(pred, lab))

    japply, tm = _unet()
    vol = _normal(11, (*VOL, 1))
    for name in ('next_label', 'next_pred_label'):
        got = getattr(seg, name)(tm, _gen(vol), device='cpu')
        want = getattr(jseg, name)(japply, _gen(vol))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    x, p, y, prior = seg.next_vol_pred(tm, _gen(vol), device='cpu')
    jx, jp, jy, jprior = jseg.next_vol_pred(japply, _gen(vol))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)
    assert prior is None and jprior is None
