"""
Built-in demo datasets with preprocessing and corruption utilities.

Capability parity with reference `neurite/tf/data.py` (KerasDataset:25-197):
same API (splits, class selection, pad/zoom, corrupt_mix/corrupt_gaussian,
show_examples) over a pluggable source — keras datasets when tensorflow is
installed, a synthetic shapes dataset otherwise (which needs no download).
Counterpart of `neurite_tpu/data.py`: host numpy, the same arrays for the
same seeds.
"""

import numpy as np

from neurite_tpu_torch.py import data as pydata


def synthetic_shapes(nb_items=1000, size=28, nb_classes=10, seed=0):
    """
    Offline stand-in for MNIST: each class is a parametrized shape (disk,
    ring, box, cross, ...) with random position/size/noise. Returns
    (x [N, size, size] uint8-scaled 0-255, y [N] int).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    x = np.zeros((nb_items, size, size), np.float32)
    y = rng.integers(0, nb_classes, nb_items)
    for i in range(nb_items):
        c = int(y[i])
        cx, cy = rng.uniform(size * 0.35, size * 0.65, 2)
        r = rng.uniform(size * 0.12, size * 0.3)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        ang = np.arctan2(yy - cy, xx - cx)
        # class-dependent shape family
        k = c % 5
        if k == 0:
            img = d2 < r ** 2
        elif k == 1:
            img = (d2 < r ** 2) & (d2 > (r * 0.5) ** 2)
        elif k == 2:
            img = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r * 0.6)
        elif k == 3:
            img = (np.abs(xx - cx) < r * 0.25) | (np.abs(yy - cy) < r * 0.25)
            img &= d2 < r ** 2
        else:
            img = (d2 < r ** 2) & (np.cos(ang * (2 + c // 5)) > 0)
        img = img.astype(np.float32)
        if c >= 5:
            img *= 0.5 + 0.5 * (xx / size)
        img += rng.normal(0, 0.05, img.shape)
        x[i] = np.clip(img, 0, 1) * 255
    return x, y


class Dataset:
    """
    Split dataset with processing utilities (pad, zoom, class selection,
    corruption). Construct from 'mnist'/'fashion-mnist' (keras, if
    installed), 'synthetic', or (x_train, y_train, x_test, y_test) arrays.

    Parity: reference `neurite/tf/data.py:25-197` (KerasDataset).
    """

    def __init__(self, dataset='synthetic', tv_ratios=(5 / 6, 1 / 6),
                 sel_class=None, pad_amt=0, zoom_factor=None,
                 randomize=False, nb_items=2000, seed=0):
        self.x = pydata.DataSplit()
        self.y = pydata.DataSplit()

        if isinstance(dataset, str) and dataset in ('mnist', 'fashion-mnist'):
            from tensorflow import keras  # optional dependency
            src = (keras.datasets.mnist if dataset == 'mnist'
                   else keras.datasets.fashion_mnist)
            (x_train, y_train), (x_test, y_test) = src.load_data()
        elif isinstance(dataset, str) and dataset == 'synthetic':
            x_all, y_all = synthetic_shapes(nb_items, seed=seed)
            n_test = max(1, nb_items // 6)
            x_train, y_train = x_all[:-n_test], y_all[:-n_test]
            x_test, y_test = x_all[-n_test:], y_all[-n_test:]
        else:
            x_train, y_train, x_test, y_test = dataset

        self.x.train, self.y.train = x_train, y_train
        self.x.test, self.y.test = x_test, y_test

        rand_seed = np.random.uniform() if randomize else None
        self.x.train, self.x.val = pydata.split_dataset(
            self.x.train, ratios=tv_ratios, randomize=randomize,
            rand_seed=rand_seed)
        self.y.train, self.y.val = pydata.split_dataset(
            self.y.train, ratios=tv_ratios, randomize=randomize,
            rand_seed=rand_seed)

        for dt in ('train', 'test', 'val'):
            self.x[dt] = np.asarray(self.x[dt])[..., np.newaxis] / 255
            self.y[dt] = np.asarray(self.y[dt])

        if sel_class is not None:
            self.select_class(sel_class)
        if pad_amt > 0:
            self.pad(pad_amt)
        if zoom_factor is not None:
            self.reshape(zoom_factor)

    def select_class(self, cls, splits=None):
        """Keep only one class (ref `tf/data.py:95-104`)."""
        for dt in splits or ('train', 'test', 'val'):
            sel = self.y[dt] == cls
            self.x[dt] = self.x[dt][sel]
            self.y[dt] = self.y[dt][sel]

    def pad(self, pad_amt, splits=None):
        """Zero-pad the spatial dims (ref `tf/data.py:106-115`)."""
        for dt in splits or ('train', 'test', 'val'):
            ndims = self.x[dt].ndim - 2
            pad_cell = ((0, 0),) + ((pad_amt, pad_amt),) * ndims + ((0, 0),)
            self.x[dt] = np.pad(self.x[dt], pad_cell, mode='constant')

    def reshape(self, zoom_factor, splits=None, order=1, **kwargs):
        """Spatially zoom the images (ref `tf/data.py:117-123`)."""
        import scipy.ndimage
        for dt in splits or ('train', 'test', 'val'):
            ndims = self.x[dt].ndim - 2
            res = [1] + [zoom_factor] * ndims + [1]
            self.x[dt] = scipy.ndimage.zoom(self.x[dt], res, order=order,
                                            **kwargs)

    def corrupt_mix(self, corruption_ratio=(0.25, 0.75), nb_corrupt=10,
                    splits=None, output_suffix='olap', seed=None):
        """Mix each image with a mean of others (ref `tf/data.py:125-160`)."""
        cr = corruption_ratio
        rng = np.random.default_rng(seed)
        for dt in splits or list(self.x._splits):
            out_dt = dt if output_suffix is None else f'{dt}_{output_suffix}'
            n = self.x[dt].shape[0]
            out = np.zeros_like(self.x[dt])
            for i in range(n):
                idx = rng.integers(0, n, nb_corrupt)
                mean = np.mean(self.x[dt][idx], 0)
                out[i] = self.x[dt][i] * cr[0] + mean * cr[1]
            self.x[out_dt] = out
            self.y[out_dt] = self.y[dt]

    def corrupt_gaussian(self, mean=0., sigma=0.1, splits=None,
                         output_suffix='noise', seed=None):
        """Add clipped gaussian noise (ref `tf/data.py:162-175`)."""
        rng = np.random.default_rng(seed)
        for dt in splits or list(self.x._splits):
            out_dt = dt if output_suffix is None else f'{dt}_{output_suffix}'
            noisy = self.x[dt] + rng.normal(mean, sigma, self.x[dt].shape)
            self.x[out_dt] = np.clip(noisy, 0, 1)
            self.y[out_dt] = self.y[dt]

    def show_examples(self, nb_examples=10, splits=None, seed=0):
        """Plot example images per split (ref `tf/data.py:177-197`)."""
        from neurite_tpu_torch.py import plot as neplot
        rng = np.random.default_rng(seed)
        for dt in splits or list(self.x._splits):
            idx = rng.integers(0, self.x[dt].shape[0], nb_examples)
            ims = [self.x[dt][f, ..., 0] for f in idx]
            titles = [str(self.y[dt][f]) for f in idx]
            neplot.slices(ims, cmaps=['gray'], titles=titles)


KerasDataset = Dataset  # reference naming (tf/data.py:25)
