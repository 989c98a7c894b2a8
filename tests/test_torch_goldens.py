"""
The port against the committed float64 oracles of the reference formulas
(`tests/goldens/goldens.npz`, the 24 arrays `tests/test_goldens.py` holds
the JAX package to): interpn, resize, soft-quantize, MI and Dice, each at
the same 1e-5 (2e-5 for MI, as there). The port's other tests hold it to
the JAX package; these hold it to the reference math, so a drift that both
packages shared would fail here.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.utils import core  # noqa: E402

G = np.load(os.path.join(os.path.dirname(__file__), 'goldens',
                         'goldens.npz'))


def _t(key):
    return torch.as_tensor(G[key], dtype=torch.float32)


def close(got, key, atol=1e-5):
    np.testing.assert_allclose(got.detach().double().numpy(), G[key],
                               atol=atol, rtol=1e-5)


class TestInterpnGoldens:
    @pytest.mark.parametrize('method,fill,key', [
        ('linear', None, 'interpn_linear'),
        ('linear', -7.25, 'interpn_linear_fill'),
        ('nearest', None, 'interpn_nearest'),
        ('nearest', -7.25, 'interpn_nearest_fill'),
    ])
    def test_interpn_3d(self, method, fill, key):
        got = core.interpn(_t('interpn_vol'), _t('interpn_loc'),
                           interp_method=method, fill_value=fill)
        close(got, key)

    @pytest.mark.parametrize('impl', ['gather', 'window'])
    def test_engines_match_goldens(self, impl):
        # JAX's engine knobs, accepted with no effect: one exact engine
        got = core.interpn(_t('interpn_vol'), _t('interpn_loc'), impl=impl,
                           max_disp=3.0, block=(4, 4, 4))
        close(got, 'interpn_linear')

    def test_interpn_2d_no_channel(self):
        close(core.interpn(_t('interpn2_vol'), _t('interpn2_loc')),
              'interpn2_linear')


class TestResizeGoldens:
    def test_up(self):
        close(core.resize(_t('resize_vol'), [1.7, 1.3, 2.0]), 'resize_up')

    def test_down(self):
        close(core.resize(_t('resize_vol'), [0.5, 0.75, 0.6]),
              'resize_down')

    def test_nearest(self):
        close(core.resize(_t('resize_vol'), [1.5, 1.5, 1.5],
                          interp_method='nearest'), 'resize_nearest')


class TestSoftQuantizeGoldens:
    def test_minmax_centers(self):
        close(core.soft_quantize(_t('sq_x'), nb_bins=8, alpha=2.), 'sq_out')

    def test_given_centers_clip(self):
        close(core.soft_quantize(_t('sq_x'), bin_centers=_t('sq_centers'),
                                 nb_bins=None, alpha=1., min_clip=-2.5,
                                 max_clip=2.5), 'sq_out_centers')


class TestMetricGoldens:
    def test_mi_volumes(self):
        mi = nt.metrics.MutualInformation(nb_bins=16)
        close(mi.volumes(_t('mi_x'), _t('mi_y')), 'mi_out', atol=2e-5)

    @pytest.mark.parametrize('impl', ['pallas', 'jnp'])
    def test_mi_fused(self, impl):
        mi = nt.metrics.MutualInformation(nb_bins=16)
        close(mi.volumes_fused(_t('mi_x'), _t('mi_y'), impl=impl), 'mi_out',
              atol=2e-5)

    def test_dice(self):
        d = nt.metrics.Dice(dice_type='soft')
        close(d.dice(_t('dice_true'), _t('dice_pred')), 'dice_out')

    def test_dice_laplace(self):
        d = nt.metrics.Dice(dice_type='soft', laplace_smoothing=1e-3)
        close(d.dice(_t('dice_true'), _t('dice_pred')), 'dice_out_laplace')


def test_every_golden_is_read():
    """The 24 arrays of the file, each read by a test above (inputs or
    oracle)."""
    read = {'interpn_vol', 'interpn_loc', 'interpn_linear',
            'interpn_linear_fill', 'interpn_nearest', 'interpn_nearest_fill',
            'interpn2_vol', 'interpn2_loc', 'interpn2_linear', 'resize_vol',
            'resize_up', 'resize_down', 'resize_nearest', 'sq_x',
            'sq_centers', 'sq_out', 'sq_out_centers', 'mi_x', 'mi_y',
            'mi_out', 'dice_true', 'dice_pred', 'dice_out',
            'dice_out_laplace'}
    assert set(G.files) == read and len(read) == 24
