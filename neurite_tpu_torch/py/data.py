"""
Data split containers and dataset helpers (pure python/numpy).

Counterpart of `neurite_tpu/py/data.py`; capability parity with reference
`neurite/py/data.py` (DataSplit:14-68, split_dataset:71-108,
load_dataset:111-127).
"""

import random
from pathlib import Path

import numpy as np


class DataSplit:
    """
    Attribute/dict-hybrid split container: `data.train` or `data['train']`;
    assigning a new attribute auto-registers a split.

    Parity: reference `neurite/py/data.py:14-68`.
    """

    def __init__(self, train=None, val=None, test=None):
        self._splits = []
        self.train = train
        self.val = val
        self.test = test

    def add_split(self, name, data):
        assert name not in self._splits, f'split {name} already exists'
        self._splits.append(name)
        super().__setattr__(name, data)

    def map_fn(self, lambda_fn, splits=None):
        """Apply a function to each split in place."""
        if splits is None:
            splits = ['train', 'val', 'test']
        for attr in splits:
            self[attr] = lambda_fn(self[attr])

    def __getitem__(self, item):
        assert item in self._splits, f'Object only has {self._splits}'
        return getattr(self, item)

    def __setitem__(self, item, val):
        setattr(self, item, val)

    def __setattr__(self, key, value):
        if key == '_splits':
            assert value == [], 'can only set splits from within class'
            super().__setattr__(key, value)
        elif hasattr(self, key):
            super().__setattr__(key, value)
        else:
            self.add_split(key, value)


def split_dataset(data, ratios, axis=0, randomize=True, rand_seed=None):
    """
    Split an array or list by ratios (e.g. train -> train/val).

    Parity: reference `neurite/py/data.py:71-108`.
    """
    nb_groups = len(ratios)
    is_list = isinstance(data, (list, tuple))

    if is_list:
        nb_items = len(data)
        assert axis == 0, \
            f'if data is a list or tuple, axis needs to be 0. got: {axis}'
    else:
        assert isinstance(data, np.ndarray), \
            f'data should be list, tuple or numpy array, got: {type(data)}'
        nb_items = data.shape[axis]

    cratios = np.cumsum(ratios) / np.sum(ratios)
    sl_idx = [0] + [int(np.round(c * nb_items)) for c in cratios]

    order = list(range(nb_items))
    if randomize:
        if rand_seed:
            random.seed(rand_seed)
        random.shuffle(order)

    if is_list:
        return [[data[i] for i in order[sl_idx[f]:sl_idx[f + 1]]]
                for f in range(nb_groups)]
    return [np.take(data, order[sl_idx[f]:sl_idx[f + 1]], axis=axis)
            for f in range(nb_groups)]


def load_dataset(dataset):
    """
    Download (and cache in ~/.neurite) a named tutorial dataset.

    Parity: reference `neurite/py/data.py:111-127`. NOTE: requires network
    access; raises a clear error when offline.
    """
    import urllib.request
    datadir = Path.home().joinpath('.neurite')
    datadir.mkdir(exist_ok=True)

    if dataset == '2D-OASIS-TUTORIAL':
        filename = datadir.joinpath('2D-OASIS-TUTORIAL.npz')
        if not filename.exists():
            url = ('https://surfer.nmr.mgh.harvard.edu/pub/data/voxelmorph/'
                   '2D-OASIS-TUTORIAL.npz')
            try:
                urllib.request.urlretrieve(url, filename)
            except Exception as e:
                raise RuntimeError(
                    f'could not download {dataset} (offline?): {e}') from e
            print(f'Cached dataset in {datadir}.')
        return np.load(filename)['images']
    raise ValueError(f'Unknown dataset {dataset}.')
