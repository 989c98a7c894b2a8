"""
The losses of the benchmark's training cells, in plain float32 PyTorch.
"""

import torch


def soft_dice(y_true, y_pred):
    """neurite's SoftDice loss: -mean over batch and labels of
    2 sum(y p) / (sum(y^2) + sum(p^2)), the sums over voxels (0 where the
    denominator is 0). Tensors [B, *spatial, L]."""
    t = y_true.to(torch.float32).flatten(1, -2)
    p = y_pred.to(torch.float32).flatten(1, -2)
    top = 2 * (t * p).sum(1)
    bottom = (t * t).sum(1) + (p * p).sum(1)
    dice = torch.where(bottom == 0, torch.zeros_like(top),
                       top / torch.where(bottom == 0,
                                         torch.ones_like(bottom), bottom))
    return -dice.mean()


def strip_dice(_, out):
    """SynthStrip's loss (`examples/synthstrip_training.py:32-39`): the
    sigmoid soft Dice of channel 0 (the prediction) against channel 1 (the
    synthesized brain mask), summed over every axis but the batch."""
    out = out.to(torch.float32)
    pred, truth = out[..., :1], out[..., 1:]
    p = torch.sigmoid(pred)
    axes = tuple(range(1, out.ndim))
    top = 2 * (p * truth).sum(axes)
    bot = (p * p).sum(axes) + (truth * truth).sum(axes)
    return -(top / bot.clamp_min(1e-7)).mean()


LOSSES = {'soft_dice': soft_dice, 'strip_dice': strip_dice}
