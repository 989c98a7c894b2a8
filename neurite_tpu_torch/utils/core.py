"""
Tensor utilities; counterpart of `neurite_tpu/utils/core.py` (only what the
Dice metric needs so far).
"""


def batch_channel_flatten(x):
    """[B, ..., C] -> [B, V, C] (ref `utils.py:1175-1189`)."""
    return flatten_axes(x, range(1, x.ndim - 1))


def flatten_axes(x, axes):
    """Flatten contiguous `axes` of x into one (ref `utils.py:1195-1226`)."""
    if not isinstance(axes, (list, tuple, range)):
        raise TypeError('axes must be list or tuple of axes to be flattened')
    axes = list(axes)
    if any(b - a != 1 for a, b in zip(axes, axes[1:])):
        raise ValueError('axes need to be contiguous')
    if axes[0] < 0:
        if axes[-1] >= 0:
            raise ValueError('if one axis is negative, all have to be negative')
        axes = [ax + x.ndim for ax in axes]
    if axes[-1] >= x.ndim:
        raise ValueError(f'axis {axes[-1]} outside max axis {x.ndim - 1}')
    shp = tuple(x.shape)
    return x.reshape(*shp[:axes[0]], -1, *shp[axes[-1] + 1:])
