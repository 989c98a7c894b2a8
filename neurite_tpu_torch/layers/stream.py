"""
Streaming-statistics layers: a mean and a covariance over the data stream.

Counterpart of `neurite_tpu/layers/stream.py` (reference
`neurite/tf/layers.py:1915-2096`). The statistics flax keeps in its
'stream_stats' collection are registered buffers here (`mean`, `count`,
and `cov` for `CovStream`), float32, updated in place by a call with
`training=True` (`neurite_tpu_torch.convert` moves them as that
collection). Torch needs their shapes at construction, so each layer takes
the per-sample `input_shape` that flax infers at its first call.
"""

import math

import torch
import torch.nn as nn

from neurite_tpu_torch import backend


def _global_sums(axis_name, *parts):
    """The batch's sums (tensors; the batch size a float) added over the
    ranks of mesh axis `axis_name` in one all-reduce (JAX's `lax.psum` of
    each); returned as they are when axis_name is None."""
    if axis_name is None:
        return parts
    from neurite_tpu_torch.parallel import mesh
    ts = [torch.as_tensor(p, dtype=torch.float32,
                          device=parts[0].device).reshape(-1) for p in parts]
    flat = mesh._all_reduce_(torch.cat(ts), mesh._axis_group(axis_name))
    out = flat.split([t.numel() for t in ts])
    return [o.view_as(p) if torch.is_tensor(p) else o[0]
            for o, p in zip(out, parts)]


def _mean_update(pre_mean, pre_count, x, pre_cap, axis_name=None):
    """Cap-weighted streaming mean (ref `layers.py:2059-2073`): the new
    mean and count after batch x (with `axis_name`, after the global batch
    of the ranks of that mesh axis)."""
    this_sum, this_bs = _global_sums(axis_name, x.sum(0), x.shape[0])
    new_count = pre_count + this_bs
    alpha = this_bs / torch.clamp(new_count, max=pre_cap)
    new_mean = pre_mean * (1 - alpha) + (this_sum / this_bs) * alpha
    return new_mean, new_count


class _Stream(nn.Module):
    """The shared buffers and the inference scale min(1, count / cap)."""

    flax_buffers = {'stream_stats': ('mean', 'count')}

    def __init__(self, input_shape, cap=100, axis_name=None, device=None):
        super().__init__()
        self.cap = float(cap)
        self.axis_name = axis_name
        self.register_buffer('mean', torch.zeros(tuple(input_shape)))
        self.register_buffer('count', torch.zeros(1))
        self.to(backend.resolve_device(device))

    def reset_parameters(self, generator=None):
        """Zero the statistics (they are drawn from nothing)."""
        for _, b in self.named_buffers(recurse=False):
            b.zero_()

    def _scale(self, count):
        return torch.clamp(count / self.cap, max=1.)


class MeanStream(_Stream):
    """
    A streaming mean of the samples, cap-weighted: forward(x, training=True)
    folds batch x into the stored mean; every call returns the mean scaled
    by min(1, count / cap), repeated over x's batch. Parity: reference
    `layers.py:1915-1975`.
    """

    def forward(self, x, training=False):
        batch = x.shape[0]
        if not training:
            mean, count = self.mean, self.count
        else:
            mean, count = _mean_update(self.mean, self.count, x, self.cap,
                                       self.axis_name)
            with torch.no_grad():
                self.mean.copy_(mean)
                self.count.copy_(count)
        return self._scale(count) * mean[None].expand(batch, *mean.shape)


class CovStream(_Stream):
    """
    A streaming covariance over the flattened samples (V x V, V the size of
    one sample: mind the memory), as the reference computes it, without
    subtracting the mean; the mean is kept beside it. forward returns the
    covariance scaled by min(1, count / cap), repeated over x's batch.
    Parity: reference `layers.py:1978-2056`.
    """

    flax_buffers = {'stream_stats': ('mean', 'cov', 'count')}

    def __init__(self, input_shape, cap=100, axis_name=None, device=None):
        super().__init__(input_shape, cap, axis_name, device)
        v = math.prod(input_shape)
        self.register_buffer('cov', torch.zeros(v, v, device=self.mean.device))

    def forward(self, x, training=False):
        batch = x.shape[0]
        v = self.cov.shape[0]
        if not training:
            cov, count = self.cov, self.count
        else:
            mean, count = _mean_update(self.mean, self.count, x, self.cap,
                                       self.axis_name)
            x_flat = x.reshape(batch, -1)
            c_sum, this_bs = _global_sums(self.axis_name, x_flat.T @ x_flat,
                                          batch)
            prev_cap = torch.clamp(self.count, max=self.cap)
            c = self.cov * (prev_cap - 1) + c_sum
            cov = c / (prev_cap + this_bs - 1)
            with torch.no_grad():
                self.mean.copy_(mean)
                self.cov.copy_(cov)
                self.count.copy_(count)
        return self._scale(count) * cov[None].expand(batch, v, v)
