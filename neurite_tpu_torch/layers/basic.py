"""
Basic layers: negation, rescale, resize, soft quantize, MSE, the FFT and
complex layers; counterpart of `neurite_tpu/layers/basic.py` (reference
`neurite/tf/layers.py`). Each is a plain function of its input, with no
parameters.
"""

import numpy as np
import torch
import torch.nn as nn

from neurite_tpu_torch.py.utils import normalize_axes
from neurite_tpu_torch.utils import core

__all__ = ['Negate', 'RescaleValues', 'Resize', 'Zoom', 'SoftQuantize', 'MSE',
           'FFT', 'IFFT', 'FFTShift', 'IFFTShift', 'ComplexToChannels',
           'ChannelsToComplex']


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


def _spatial_axes(axes, x):
    """`axes` of a batched [B, *spatial, C] tensor, validated to lie among
    its 1 to 3 spatial axes (None: all of them)."""
    ndims = x.ndim - 2
    if ndims not in (1, 2, 3):
        raise ValueError(f'only 1D, 2D, or 3D supported, got {ndims}D')
    return normalize_axes(axes, tuple(x.shape), allowed=range(1, ndims + 1),
                          none_means_all=True)


class FFT(nn.Module):
    """FFT over validated spatial axes; real inputs become complex64 (ref
    `layers.py:2103-2145`)."""

    def __init__(self, axes=None, inverse=False):
        super().__init__()
        self.axes, self.inverse = axes, inverse

    def forward(self, x):
        return core.fftn(x, axes=_spatial_axes(self.axes, x),
                         inverse=self.inverse)


class IFFT(FFT):
    """Inverse FFT (ref `layers.py:2148-2161`)."""

    def __init__(self, axes=None):
        super().__init__(axes=axes, inverse=True)


class FFTShift(nn.Module):
    """fftshift over validated spatial axes (ref `layers.py:2164-2199`)."""

    def __init__(self, axes=None, inverse=False):
        super().__init__()
        self.axes, self.inverse = axes, inverse

    def forward(self, x):
        f = core.ifftshift if self.inverse else core.fftshift
        return f(x, axes=_spatial_axes(self.axes, x))


class IFFTShift(FFTShift):
    """Inverse fftshift (ref `layers.py:2202-2214`)."""

    def __init__(self, axes=None):
        super().__init__(axes=axes, inverse=True)


class ComplexToChannels(nn.Module):
    """Complex [..., N] -> real [..., 2N] (ref `layers.py:2217-2235`)."""

    def forward(self, x):
        return core.complex_to_channels(x)


class ChannelsToComplex(nn.Module):
    """Real [..., 2N] -> complex [..., N] (ref `layers.py:2238-2254`)."""

    def forward(self, x):
        return core.channels_to_complex(x)
