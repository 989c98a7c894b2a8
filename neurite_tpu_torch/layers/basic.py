"""
Basic layers: negation, rescale, resize, soft quantize, MSE; counterpart of
`neurite_tpu/layers/basic.py` (reference `neurite/tf/layers.py`). Each is a
plain function of its input, with no parameters. (The FFT and complex layers
of `basic.py:102-162` are not ported yet: ROADMAP.md, Queue 1.)
"""

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch.utils import core

__all__ = ['Negate', 'RescaleValues', 'Resize', 'Zoom', 'SoftQuantize', 'MSE']


class Negate(nn.Module):
    """-x (ref `layers.py:49-64`)."""

    def forward(self, x):
        return -x


class RescaleValues(nn.Module):
    """x * resize, a fixed scalar rescale of values (ref `layers.py:67-88`)."""

    def __init__(self, resize):
        super().__init__()
        self.resize = resize

    def forward(self, x):
        return x * self.resize


class Resize(nn.Module):
    """
    Spatial resize (scipy-zoom-like) of a batched [B, *spatial, C] tensor:
    `utils.core.resize` of each batch item.

    Parity: reference `layers.py:91-182`.
    """

    def __init__(self, zoom_factor, interp_method='linear'):
        super().__init__()
        self.zoom_factor = zoom_factor
        self.interp_method = interp_method

    def forward(self, x):
        if isinstance(x, (list, tuple)):
            if len(x) != 1:
                raise ValueError(f'inputs has to be len 1. found: {len(x)}')
            x = x[0]
        ndims = x.ndim - 2
        zoom = self.zoom_factor
        if not isinstance(zoom, (list, tuple)):
            zoom = [zoom] * ndims
        elif len(zoom) != ndims:
            raise ValueError(f'zoom factor length {len(zoom)} does not match '
                             f'number of dimensions {ndims}')
        return torch.stack([core.resize(v, list(zoom),
                                        interp_method=self.interp_method)
                            for v in x])


Zoom = Resize  # scipy naming (ref layers.py:185)


class SoftQuantize(nn.Module):
    """
    Soft-quantization layer. Returns the NEGATIVE of
    `utils.core.soft_quantize`, as the reference layer does (`layers.py:220`).
    """

    def __init__(self, alpha=1, bin_centers=None, nb_bins=16,
                 min_clip=-np.inf, max_clip=np.inf, return_log=False):
        super().__init__()
        self.alpha, self.bin_centers, self.nb_bins = alpha, bin_centers, \
            nb_bins
        self.min_clip, self.max_clip = min_clip, max_clip
        self.return_log = return_log    # kept, unused, as in the reference

    def forward(self, x):
        return -core.soft_quantize(
            x, alpha=self.alpha, bin_centers=self.bin_centers,
            nb_bins=None if self.bin_centers is not None else self.nb_bins,
            min_clip=self.min_clip, max_clip=self.max_clip, return_log=False)


class MSE(nn.Module):
    """Per-item mean squared difference of a 2-list input (ref
    `layers.py:233-248`)."""

    def forward(self, x):
        diff = torch.square(x[0] - x[1])
        return torch.mean(diff.reshape(diff.shape[0], -1), -1)
