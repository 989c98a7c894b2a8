"""
Metrics: soft/hard Dice.

Counterpart of `neurite_tpu/metrics.py:24-48,212-317` (reference
`neurite/tf/metrics.py:339-616`). The three per-label sums go through
`ops.dice_sums`, which runs the CUDA kernel for CUDA tensors.
"""

import warnings

import torch

from neurite_tpu_torch import ops
from neurite_tpu_torch.utils import core

EPSILON = 1e-7  # keras backend epsilon, for formula-level parity


def _check_limits(x, name, mode=True, lo=0., hi=1.):
    """
    Range check mirroring the reference's in-graph asserts
    (`neurite/tf/metrics.py:441-444,250-251`).

    mode True: check on the host. For a CUDA tensor this waits for the
        device, so hot training loops pass check_input_limits=False.
    mode 'checkify': JAX's in-graph check; not ported.
    mode False/None: skip.
    """
    if mode is None or mode is False:
        return
    if mode == 'checkify':
        raise NotImplementedError(
            "check_input_limits='checkify' is JAX-only; use True or False")
    if x.numel() and (x.min().item() < lo or x.max().item() > hi):
        raise ValueError(f'{name}: value outside range [{lo}, {hi}]')


def _one_hot(labels, nb_labels):
    """jax.nn.one_hot: float32, all zeros for a label outside [0, L)."""
    classes = torch.arange(nb_labels, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


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
