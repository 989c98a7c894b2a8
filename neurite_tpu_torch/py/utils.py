"""
Framework-free helpers (counterpart of `neurite_tpu/py/utils.py`; the port
keeps its own copy so that it imports nothing of the JAX package).
"""

import numpy as np


def normalize_axes(axes, shape, allowed=None, none_means_all=False):
    """
    Normalize and validate axis indices into an N-D shape: sort, deduplicate,
    map negatives into [0, N), and check membership in `allowed`.

    Parity: reference `neurite/py/utils.py:124-167`; like the JAX package,
    returns the axes as a sorted tuple.
    """
    ndims = len(shape)
    if allowed is None:
        allowed = range(ndims)
    if np.isscalar(allowed):
        allowed = [allowed]
    if not all(ax in range(ndims) for ax in allowed):
        raise ValueError(f'allowed axes {allowed} out of bounds')

    if axes is None:
        axes = allowed if none_means_all else []
    if np.isscalar(axes):
        axes = [axes]

    orig = axes
    axes = [ax + ndims if ax < 0 else ax for ax in axes]
    for ax, inp in zip(axes, orig):
        if ax not in allowed:
            raise IndexError(f'axis {inp} outside {list(allowed)}')
    return tuple(sorted(set(axes)))
