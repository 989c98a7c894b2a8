"""
Metrics: soft mutual information, soft/hard Dice, weighted CCE and MSE.

Counterpart of `neurite_tpu/metrics.py` (reference `neurite/tf/metrics.py`).
The Dice sums go through `ops.dice_sums` and the fused MI histograms
through `ops.mi_histograms`, which run CUDA kernels for CUDA tensors; the
MI joint histograms of materialized maps are `torch.bmm`, as the JAX
package leaves them to XLA.
"""

import warnings

import numpy as np
import torch

from neurite_tpu_torch import checkify, ops
from neurite_tpu_torch.utils import core

EPSILON = 1e-7  # keras backend epsilon, for formula-level parity


def _check_limits(x, name, mode=True, lo=0., hi=1.):
    """
    Range check mirroring the reference's in-graph asserts
    (`neurite/tf/metrics.py:441-444,250-251`).

    mode True: check on the host. For a CUDA tensor this waits for the
        device, so hot training loops pass check_input_limits=False.
    mode 'checkify': an in-graph check (`neurite_tpu_torch.checkify.check`):
        inside `training.make_checked_train_step` it is recorded on the
        device and raised by the step's `err.throw()`; outside one it
        raises at once, as JAX's eager `checkify.check` does.
    mode False/None: skip.
    """
    if mode is None or mode is False:
        return
    if mode == 'checkify':
        x = x.detach()
        ok = ((x >= lo) & (x <= hi)).all()
        checkify.check(ok, f'{name}: value outside range [{lo}, {hi}]')
        return
    if x.numel() and (x.min().item() < lo or x.max().item() > hi):
        raise ValueError(f'{name}: value outside range [{lo}, {hi}]')


def _one_hot(labels, nb_labels):
    """jax.nn.one_hot: float32, all zeros for a label outside [0, L)."""
    classes = torch.arange(nb_labels, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


class MutualInformation:
    """
    Soft mutual-information approximation between volumes and/or
    probabilistic maps, via soft quantization (RBF binning).

    Parity: reference `neurite/tf/metrics.py:41-336`, JAX
    `metrics.py:51-209`. Methods: volumes, segs, volume_seg, channelwise,
    maps, volumes_fused. The bin centers are kept on the host and copied to
    an input's device once (`core.device_constant`); alpha is a float (the
    float32 value JAX computes).
    """

    def __init__(self, bin_centers=None, nb_bins=None, soft_bin_alpha=None,
                 min_clip=None, max_clip=None, check_input_limits=True):
        # non-negativity of probability maps (reference metrics.py:250-251)
        self.check_input_limits = check_input_limits
        self.bin_centers = None
        if bin_centers is not None:
            if nb_bins is not None:
                raise ValueError('cannot provide both bin_centers and nb_bins')
            self.bin_centers = np.asarray(
                bin_centers.detach().cpu() if torch.is_tensor(bin_centers)
                else bin_centers, np.float32)
            nb_bins = self.bin_centers.shape[0]

        self.nb_bins = nb_bins
        if bin_centers is None and nb_bins is None:
            self.nb_bins = 16

        self.min_clip = -np.inf if min_clip is None else min_clip
        self.max_clip = np.inf if max_clip is None else max_clip

        self.soft_bin_alpha = soft_bin_alpha
        if self.soft_bin_alpha is None:
            # sigma heuristic from bin spacing (ref metrics.py:109-117), in
            # float32 as JAX computes it
            sigma_ratio = np.float32(0.5)
            if self.bin_centers is None:
                sigma = np.float32(0.5 / (self.nb_bins - 1))
            else:
                sigma = sigma_ratio * np.mean(np.diff(self.bin_centers),
                                              dtype=np.float32)
            self.soft_bin_alpha = float(
                np.float32(1) / (np.float32(2) * np.square(sigma)))

    def volumes(self, x, y):
        """MI per batch item between two single-channel volumes [bs, ..., 1]."""
        if x.shape[-1] != 1 or y.shape[-1] != 1:
            raise ValueError('volume_mi requires two single-channel volumes. '
                             'See channelwise().')
        return core.flatten(self.channelwise(x, y))

    def segs(self, x, y):
        """MI between two probabilistic segmentation maps [bs, ..., L]."""
        return self.maps(x, y)

    def volume_seg(self, x, y):
        """MI between a volume [bs,...,1] and a soft segmentation [bs,...,L]."""
        if min(x.shape[-1], y.shape[-1]) != 1:
            raise ValueError('volume_seg_mi requires one single-channel '
                             'volume.')
        if max(x.shape[-1], y.shape[-1]) <= 1:
            raise ValueError('volume_seg_mi requires one multi-channel '
                             'segmentation.')
        if x.shape[-1] == 1:
            x = self._soft_sim_map(x[..., 0])
        else:
            y = self._soft_sim_map(y[..., 0])
        return self.maps(x, y)

    def channelwise(self, x, y):
        """MI per channel: [bs, ..., C] x2 -> [bs, C]. JAX's vmap over the
        channels is the batch axis of one bmm here."""
        if x.shape != y.shape:
            raise ValueError('volume shapes do not match')
        bs, nc = x.shape[0], x.shape[-1]
        # [C, bs, V]; the centers (when derived) span every channel, as in JAX
        cx = x.reshape(bs, -1, nc).movedim(-1, 0)
        cy = y.reshape(bs, -1, nc).movedim(-1, 0)
        cxq = self._soft_sim_map(cx)  # [C, bs, V, B]
        cyq = self._soft_sim_map(cy)
        cout = self.maps(cxq.flatten(0, 1), cyq.flatten(0, 1))
        return cout.reshape(nc, bs).transpose(0, 1)

    def maps(self, x, y):
        """
        MI per batch item from per-voxel probability/similarity maps
        [bs, ..., B].

        Parity: reference `neurite/tf/metrics.py:228-282` (formula-for-
        formula, including epsilon placement).
        """
        if x.shape[:-1] != y.shape[:-1]:
            raise ValueError('map shapes do not match')
        if self.check_input_limits:
            _check_limits(x, 'x', self.check_input_limits, 0., np.inf)
            _check_limits(y, 'y', self.check_input_limits, 0., np.inf)
        eps = EPSILON

        if x.ndim != 3:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
            y = y.reshape(y.shape[0], -1, y.shape[-1])

        # joint probability: [bs, B1, B2]
        pxy = torch.bmm(x.transpose(1, 2), y)
        pxy = pxy / (pxy.sum((1, 2), keepdim=True) + eps)

        px = x.sum(1, keepdim=True)                      # [bs, 1, B1]
        px = px / (px.sum(2, keepdim=True) + eps)
        py = y.sum(1, keepdim=True)                      # [bs, 1, B2]
        py = py / (py.sum(2, keepdim=True) + eps)

        pxpy = torch.bmm(px.transpose(1, 2), py)         # [bs, B1, B2]
        log_term = torch.log(pxy / (pxpy + eps) + eps)
        return (pxy * log_term).sum((1, 2))

    def volumes_fused(self, x, y, impl='auto', interpret=False):
        """
        MI between two single-channel volumes [bs, ..., 1] through the fused
        soft-quantize + joint-histogram op (`ops.mi_histograms`): K10 on
        the card, without the [bs, V, B] maps. Without configured centers
        they are linspace(min, max, nb_bins) of each volume, computed on its
        device. impl: 'auto', 'pallas', 'plain' or 'jnp' (`ops/mi_hist.py`;
        'pallas' and 'jnp' differ in the centers' gradient).
        """
        if x.shape[-1] != 1 or y.shape[-1] != 1:
            raise ValueError('volume_mi requires two single-channel volumes.')
        xf = x.to(torch.float32).reshape(x.shape[0], -1)
        yf = y.to(torch.float32).reshape(y.shape[0], -1)
        if self.bin_centers is not None:
            cbx = cby = core.device_constant(self.bin_centers, xf.device)
        else:
            # reference soft_quantize derives centers from per-tensor min/max
            # (`neurite/tf/utils/utils.py:1152-1154`)
            cbx = core.linspace(xf.min(), xf.max(), self.nb_bins)
            cby = core.linspace(yf.min(), yf.max(), self.nb_bins)
        pxy, px, py = ops.mi_histograms(
            xf, yf, cbx, self.soft_bin_alpha, min_clip=self.min_clip,
            max_clip=self.max_clip, impl=impl, interpret=interpret,
            bin_centers_y=cby)
        return self._mi_from_histograms(pxy, px, py)

    def _mi_from_histograms(self, pxy, px, py):
        """Finish the MI formula from raw histogram sums (ref maps() math)."""
        eps = EPSILON
        pxy = pxy / (pxy.sum((1, 2), keepdim=True) + eps)
        px = px / (px.sum(1, keepdim=True) + eps)
        py = py / (py.sum(1, keepdim=True) + eps)
        pxpy = px[:, :, None] * py[:, None, :]
        log_term = torch.log(pxy / (pxpy + eps) + eps)
        return (pxy * log_term).sum((1, 2))

    def _soft_quantize(self, x, return_log):
        centers = self.bin_centers
        return core.soft_quantize(
            x, alpha=self.soft_bin_alpha, bin_centers=centers,
            nb_bins=None if centers is not None else self.nb_bins,
            min_clip=self.min_clip, max_clip=self.max_clip,
            return_log=return_log)

    def _soft_log_sim_map(self, x):
        return self._soft_quantize(x, return_log=True)

    def _soft_sim_map(self, x):
        return self._soft_quantize(x, return_log=False)

    def _soft_prob_map(self, x):
        x_hist = self._soft_sim_map(x)
        return x_hist / (x_hist.sum(-1, keepdim=True) + EPSILON)


class Dice:
    """
    Soft/hard Dice with per-label (or per-batch) weighting.

    Parity: reference `neurite/tf/metrics.py:339-519`: top = 2*sum(xy),
    bottom = sum(x^2) + sum(y^2) over voxels, laplace smoothing or safe
    division.
    """

    def __init__(self, dice_type='soft', input_type='prob', nb_labels=None,
                 weights=None, check_input_limits=True, laplace_smoothing=0.,
                 normalize=False, use_kernel='auto'):
        self.use_kernel = use_kernel
        self.dice_type = dice_type
        self.input_type = input_type
        self.nb_labels = nb_labels
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
        self.normalize = normalize
        self.check_input_limits = check_input_limits
        self.laplace_smoothing = laplace_smoothing

        if self.input_type not in ('prob', 'max_label'):
            raise ValueError(f'input_type must be prob or max_label, got '
                             f'{self.input_type!r}')
        if self.dice_type == 'hard' and self.input_type == 'max_label' \
                and self.nb_labels is None:
            raise ValueError('If doing hard Dice need nb_labels')
        if self.dice_type == 'soft' and self.input_type != 'prob':
            raise ValueError(
                'if doing soft Dice, must use probabilistic (one_hot) encoding')

    def dice(self, y_true, y_pred):
        """Dice per batch item and label: -> [batch_size, nb_labels]."""
        if self.input_type == 'prob':
            if self.normalize:
                def _safe_norm(y):
                    s = y.sum(-1, keepdim=True)
                    return torch.where(s == 0, 0., y / torch.where(s == 0, 1., s))
                y_true = _safe_norm(y_true)
                y_pred = _safe_norm(y_pred)

            if self.check_input_limits:
                _check_limits(y_true, 'y_true', self.check_input_limits)
                _check_limits(y_pred, 'y_pred', self.check_input_limits)

        if self.dice_type == 'hard':
            nb_labels = self.nb_labels
            if self.input_type == 'prob':
                if nb_labels is None:
                    nb_labels = y_pred.shape[-1]
                y_pred = y_pred.argmax(-1)
                y_true = y_true.argmax(-1)
            y_pred = _one_hot(y_pred, nb_labels)
            y_true = _one_hot(y_true, nb_labels)

        y_true = core.batch_channel_flatten(y_true)
        y_pred = core.batch_channel_flatten(y_pred)

        # the CUDA kernel for CUDA tensors, the plain sums on the CPU
        s_xy, s_tt, s_pp = ops.dice_sums(y_true, y_pred, impl=self.use_kernel)
        top = 2 * s_xy
        bottom = s_tt + s_pp
        if self.laplace_smoothing > 0:
            eps = self.laplace_smoothing
            return (top + eps) / (bottom + eps)
        return torch.where(bottom == 0, 0.,
                           top / torch.where(bottom == 0, 1., bottom))

    def mean_dice(self, y_true, y_pred):
        """Mean (optionally weighted) Dice across batch and labels -> scalar."""
        dice_metric = self.dice(y_true, y_pred)
        if self.weights is not None:
            if self.weights.ndim != 2:
                raise ValueError('weights should be a matrix broadcastable to '
                                 '[batch_size, nb_labels]')
            dice_metric = dice_metric * self.weights.to(dice_metric.device)
        return dice_metric.mean()

    def loss(self, y_true, y_pred):
        """Deprecated: use ne.losses.Dice(...).loss."""
        warnings.warn('ne.metrics.*.loss functions are deprecated. '
                      'Please use the ne.losses.*.loss functions.')
        return -self.mean_dice(y_true, y_pred)


class SoftDice(Dice):
    """Soft-Dice preset (ref `metrics.py:522-570`)."""

    def __init__(self, weights=None, check_input_limits=True,
                 laplace_smoothing=0., normalize=False, use_kernel='auto'):
        super().__init__(dice_type='soft', input_type='prob', weights=weights,
                         check_input_limits=check_input_limits,
                         laplace_smoothing=laplace_smoothing,
                         normalize=normalize, use_kernel=use_kernel)


class HardDice(Dice):
    """Hard-Dice preset (ref `metrics.py:573-616`)."""

    def __init__(self, nb_labels, input_type='max_label', weights=None,
                 check_input_limits=True, laplace_smoothing=0.,
                 normalize=False, use_kernel='auto'):
        super().__init__(dice_type='hard', input_type=input_type,
                         nb_labels=nb_labels, weights=weights,
                         check_input_limits=check_input_limits,
                         laplace_smoothing=laplace_smoothing,
                         normalize=normalize, use_kernel=use_kernel)


class CategoricalCrossentropy:
    """
    Categorical cross-entropy with per-label weights premultiplied into
    y_true.

    Parity: reference `neurite/tf/metrics.py:619-650` (keras CCE semantics:
    renormalize probs unless from_logits, clip to [eps, 1], reduce the
    label axis, mean over the rest).
    """

    def __init__(self, label_weights=None, from_logits=False, **kwargs):
        self.label_weights = None
        if label_weights is not None:
            self.label_weights = np.asarray(label_weights)
        self.from_logits = from_logits

    def __call__(self, y_true, y_pred, sample_weight=None):
        return self.cce(y_true, y_pred, sample_weight=sample_weight)

    def cce(self, y_true, y_pred, sample_weight=None):
        if self.label_weights is not None:
            yf = y_pred.shape[-1]
            lf = self.label_weights.shape[-1]
            if yf != lf:
                raise ValueError(
                    f'Label weights must be of len {yf}, but got {lf}.')
            y_true = core.device_constant(self.label_weights, y_true.device,
                                          y_true.dtype) * y_true

        if self.from_logits:
            logp = torch.log_softmax(y_pred, -1)
        else:
            s = y_pred.sum(-1, keepdim=True)
            y_pred = y_pred / torch.where(s == 0, 1., s)
            logp = torch.log(core.clip(y_pred, EPSILON, 1.0))

        per_elem = -(y_true * logp).sum(-1)
        if sample_weight is not None:
            per_elem = per_elem * sample_weight
        return per_elem.mean()


class MeanSquaredErrorProb:
    """
    MSE over probability maps with optional per-label weights.

    Parity: reference `neurite/tf/metrics.py:653-692` (keras MSE with
    label_weights via the sample-weight trick == mean of w_l * (x-y)^2).
    """

    def __init__(self, label_weights=None, **kwargs):
        self.label_weights = None
        if label_weights is not None:
            self.label_weights = np.asarray(label_weights)

    def __call__(self, y_true, y_pred, sample_weight=None):
        return self.mse(y_true, y_pred, sample_weight=sample_weight)

    def mse(self, y_true, y_pred, sample_weight=None):
        sq = torch.square(y_true - y_pred)
        if self.label_weights is not None:
            yf = y_pred.shape[-1]
            lf = self.label_weights.shape[0]
            if yf != lf:
                raise ValueError(
                    f'Label weights must be of len {yf}, but got {lf}.')
            sq = sq * core.device_constant(self.label_weights, sq.device,
                                           sq.dtype)
        if sample_weight is not None:
            sq = sq * sample_weight
        return sq.mean()


def l1(y_true, y_pred):
    """Mean absolute error (ref `metrics.py:33`)."""
    return torch.abs(y_true - y_pred).mean()


def l2(y_true, y_pred):
    """Mean squared error (ref `metrics.py:34`)."""
    return torch.square(y_true - y_pred).mean()


def multiple_metrics_decorator(metrics, weights=None):
    """Weighted sum of metrics (ref `metrics.py:699-718`)."""
    if weights is None:
        weights = np.ones(len(metrics))

    def metric(y_true, y_pred):
        total_val = 0
        for idx, met in enumerate(metrics):
            total_val += weights[idx] * met(y_true, y_pred)
        return total_val

    return metric
