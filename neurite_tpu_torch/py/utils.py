"""
Framework-free helpers (counterpart of `neurite_tpu/py/utils.py`; the port
keeps its own copy so that it imports nothing of the JAX package).
"""

import os

import numpy as np


def get_backend():
    """
    Return the active backend name: `NEURITE_BACKEND` where it is set (API
    parity with the reference, `neurite/py/utils.py:15-20`), else 'torch'.
    """
    return os.environ.get('NEURITE_BACKEND', 'torch')


def softmax(x, axis):
    """Numpy softmax along an axis (reference `neurite/py/utils.py:23-28`)."""
    x = np.asarray(x)
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / np.sum(e, axis=axis, keepdims=True)


def rebase_lab(labels):
    """
    Rebase integer labels onto [0, N) and return (lab_to_ind, ind_to_lab) LUTs,
    used as `lab_to_ind[label_map]`. Pass every label that can occur.

    Parity: reference `neurite/py/utils.py:31-44`.
    """
    labels = np.unique(labels)  # sorted
    if not np.issubdtype(labels.dtype, np.integer):
        raise ValueError('non-integer data')

    lab_to_ind = np.zeros(np.max(labels) + 1, dtype='int64')
    for i, lab in enumerate(labels):
        lab_to_ind[lab] = i
    ind_to_lab = labels
    return lab_to_ind, ind_to_lab


def load_fs_lut(filename):
    """
    Read a FreeSurfer-style label lookup table: `ID Name R G B` per line.
    Returns {id: {'name': ..., 'color': [r, g, b]}}.

    Parity: reference `neurite/py/utils.py:47-75`.
    """
    label_table = {}
    with open(filename, 'r') as file:
        for line in file:
            line = line.rstrip()
            if not line or line[0] == '#':
                continue
            tokens = line.split()
            sid = int(tokens[0])
            label_table[sid] = {'name': tokens[1]}
            if len(tokens) > 2:
                label_table[sid]['color'] = [int(c) for c in tokens[2:5]]
    return label_table


def seg_to_rgb_fs_lut(seg, label_table):
    """
    Convert a hard segmentation to an RGB uint8 image via an FS LUT dict.

    Parity: reference `neurite/py/utils.py:78-96`.
    """
    seg = np.asarray(seg)
    color_seg = np.zeros((*seg.shape, 3), dtype='uint8')
    for sid in np.unique(seg):
        label = label_table.get(sid)
        if label is not None and 'color' in label:
            color_seg[seg == sid] = label['color']
    return color_seg


def fs_lut_to_cmap(lut):
    """
    Convert an FS LUT (dict or path) to a matplotlib ListedColormap.

    Parity: reference `neurite/py/utils.py:99-121`.
    """
    import matplotlib.colors
    if isinstance(lut, str):
        lut = load_fs_lut(lut)
    keys = list(lut.keys())
    rgb = np.zeros((np.array(keys).max() + 1, 3), dtype='float')
    for key in keys:
        rgb[key] = lut[key]['color']
    return matplotlib.colors.ListedColormap(rgb / 255)


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
