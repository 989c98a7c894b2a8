"""
Losses: negated/loss-form wrappers of the metrics.

Counterpart of `neurite_tpu/losses.py` (reference
`neurite/tf/losses.py:46-246`).
"""

from neurite_tpu_torch import metrics as _metrics
from neurite_tpu_torch.metrics import l1, l2  # noqa: F401  (ref losses.py:32-33)
from neurite_tpu_torch.metrics import MutualInformation  # noqa: F401  (ref losses.py:43)


class Dice(_metrics.Dice):
    """Dice losses: `.loss` / `.mean_loss` are negated Dice (ref `losses.py:46-121`)."""

    def loss(self, y_true, y_pred):
        """Mean of -dice over batch/labels (identical to mean_loss)."""
        return -self.mean_dice(y_true, y_pred)

    def mean_loss(self, y_true, y_pred):
        """Mean of -dice, optionally weighted."""
        return -self.mean_dice(y_true, y_pred)


class SoftDice(Dice):
    """Soft-Dice loss preset (ref `losses.py:124-156`)."""

    def __init__(self, weights=None, check_input_limits=True,
                 laplace_smoothing=0., normalize=False, use_kernel='auto'):
        super().__init__(dice_type='soft', input_type='prob', weights=weights,
                         check_input_limits=check_input_limits,
                         laplace_smoothing=laplace_smoothing,
                         normalize=normalize, use_kernel=use_kernel)


class HardDice(Dice):
    """Hard-Dice loss preset (ref `losses.py:159-190`)."""

    def __init__(self, nb_labels, input_type='max_label', weights=None,
                 check_input_limits=True, laplace_smoothing=0.,
                 normalize=False, use_kernel='auto'):
        super().__init__(dice_type='hard', input_type=input_type,
                         nb_labels=nb_labels, weights=weights,
                         check_input_limits=check_input_limits,
                         laplace_smoothing=laplace_smoothing,
                         normalize=normalize, use_kernel=use_kernel)


class CategoricalCrossentropy(_metrics.CategoricalCrossentropy):
    """CCE loss alias (ref `losses.py:193-206`)."""

    def loss(self, y_true, y_pred, sample_weight=None):
        return self.cce(y_true, y_pred, sample_weight=sample_weight)


class MeanSquaredErrorProb(_metrics.MeanSquaredErrorProb):
    """MSE-prob loss alias (ref `losses.py:209-220`)."""

    def loss(self, y_true, y_pred, sample_weight=None):
        return self.mse(y_true, y_pred, sample_weight=sample_weight)


def multiple_losses_decorator(losses, weights=None):
    """Weighted sum of losses (ref `losses.py:227-246`)."""
    return _metrics.multiple_metrics_decorator(losses, weights)
