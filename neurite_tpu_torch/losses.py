"""
Losses: negated/loss-form wrappers of the Dice metrics.

Counterpart of `neurite_tpu/losses.py:14-47` (reference
`neurite/tf/losses.py:46-190`).
"""

from neurite_tpu_torch import metrics as _metrics


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
