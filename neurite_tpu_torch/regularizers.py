"""
Weight regularizers.

Counterpart of `neurite_tpu/regularizers.py` (reference
`neurite/tf/regularizers.py:35-45`).
"""

from neurite_tpu_torch.utils.core import flatten, soft_delta


def soft_l0_wrap(wt=1.):
    """
    Soft-L0 penalty encouraging zero weights: wt * (soft count of non-zero
    weights) / (total weights), where the soft zero-count is
    sum(soft_delta(x)).
    """

    def soft_l0(x):
        """maximize the number of 0 weights"""
        nb_weights = float(x.numel())
        nb_zero_wts = soft_delta(flatten(x)).sum()
        return wt * (nb_weights - nb_zero_wts) / nb_weights

    return soft_l0
