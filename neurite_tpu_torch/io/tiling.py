"""
Patch extraction and quilt reassembly for N-D volumes.

Counterpart of `neurite_tpu/io/tiling.py` (reference: pystrum's
`patchlib.patch_gen` and `quilt`, `neurite/tf/utils/seg.py:363-374`): the
grid arithmetic and the host quilt are numpy, `quilt_device` adds the
patches of a tensor into a volume on the tensor's device. The host
nan-median of float32 stacks runs the native C++ library (`io/native.py`),
as the JAX package's does; float64 stacks take `np.nanmedian`.
"""

import itertools

import numpy as np
import torch


def _conform(v, ndims, name):
    if np.isscalar(v):
        return (int(v),) * ndims
    v = tuple(int(x) for x in v)
    if len(v) != ndims:
        raise ValueError(f'{name} length {len(v)} != ndims {ndims}')
    return v


def patch_starts(vol_shape, patch_size, stride=None):
    """Per-axis start indices of a covering patch grid (last patch clamped
    so the full volume is covered), and the patch size as a tuple."""
    ndims = len(vol_shape)
    patch_size = _conform(patch_size, ndims, 'patch_size')
    stride = patch_size if stride is None else _conform(stride, ndims, 'stride')

    axis_starts = []
    for d in range(ndims):
        if patch_size[d] > vol_shape[d]:
            raise ValueError(f'patch {patch_size[d]} larger than volume '
                             f'{vol_shape[d]} on axis {d}')
        s = list(range(0, vol_shape[d] - patch_size[d] + 1, stride[d]))
        if s[-1] != vol_shape[d] - patch_size[d]:
            s.append(vol_shape[d] - patch_size[d])
        axis_starts.append(s)
    return axis_starts, patch_size


def grid_size(vol_shape, patch_size, stride=None):
    """Number of patches along each axis."""
    axis_starts, _ = patch_starts(vol_shape, patch_size, stride)
    return tuple(len(s) for s in axis_starts)


def _slices(vol_shape, patch_size, stride):
    """The patch_gen-order slices of a volume's patches."""
    axis_starts, psize = patch_starts(vol_shape, patch_size, stride)
    for starts in itertools.product(*axis_starts):
        yield tuple(slice(s, s + p) for s, p in zip(starts, psize))


def patch_gen(vol, patch_size, stride=None):
    """
    Yield the patches covering `vol` in row-major grid order (pystrum's
    `patch_gen`). A numpy array or a tensor, indexed as it is: a tensor's
    patches are views on its device. Axes past len(patch_size) are kept
    whole.
    """
    if not torch.is_tensor(vol):
        vol = np.asarray(vol)
    ndims = len(patch_size) if not np.isscalar(patch_size) else vol.ndim
    for sl in _slices(tuple(vol.shape[:ndims]), patch_size, stride):
        yield vol[sl]


def quilt(patches, patch_size, vol_shape, stride=None, agg='nanmean'):
    """
    Reassemble patches (in `patch_gen` order) into a volume on the host,
    aggregating overlaps with nan-mean, mean or nan-median (pystrum's
    `quilt` with nan_func_layers=np.nanmedian, ref `seg.py:100-101,363-374`).
    Voxels no valid patch value covers are NaN.
    """
    if agg not in ('nanmean', 'nanmedian', 'mean'):
        raise ValueError(f'bad agg {agg}')
    ndims = len(vol_shape)
    axis_starts, psize = patch_starts(vol_shape, patch_size, stride)
    n_patches = int(np.prod([len(s) for s in axis_starts]))
    patches = np.asarray(list(patches)) if not isinstance(patches, np.ndarray) \
        else patches
    patches = patches.reshape(n_patches, *psize)
    slices = list(_slices(vol_shape, patch_size, stride))

    if agg in ('nanmean', 'mean'):
        acc = np.zeros(vol_shape, np.float64)
        cnt = np.zeros(vol_shape, np.float64)
        for sl, p in zip(slices, patches):
            mask = ~np.isnan(p)
            acc[sl] += np.where(mask, p, 0)
            cnt[sl] += mask
        with np.errstate(invalid='ignore'):
            return acc / cnt

    # nanmedian: layered accumulation (memory ~ max overlap layers)
    max_layers = 1
    for d in range(ndims):
        st = (axis_starts[d][1] - axis_starts[d][0]) \
            if len(axis_starts[d]) > 1 else psize[d]
        max_layers *= int(np.ceil(psize[d] / max(st, 1)))
    acc_dtype = np.result_type(patches.dtype, np.float32)
    layers = np.full((max_layers, *vol_shape), np.nan, acc_dtype)
    layer_idx = np.zeros(vol_shape, np.int32)
    flat_region = tuple(np.indices(psize).reshape(ndims, -1))
    for sl, p in zip(slices, patches):
        li = layer_idx[sl]
        coords = tuple(fr + s.start for fr, s in zip(flat_region, sl))
        layers[(li.reshape(-1), *coords)] = p.reshape(-1)
        layer_idx[sl] += 1
    # the multithreaded native nth_element for float32; float64 stacks stay
    # on the exact numpy path
    if layers.dtype == np.float32:
        from neurite_tpu_torch.io import native
        return native.nan_aggregate_axis0(layers, agg='nanmedian')
    with np.errstate(invalid='ignore'):
        return np.nanmedian(layers, axis=0)


def quilt_device(patches, patch_size, vol_shape, stride=None, agg='mean'):
    """
    Reassemble patches [P, *patch_size, ...] (in `patch_gen` order) into a
    volume [*vol_shape, ...] on their device, with no host read: each patch
    is added into its block of an accumulator in the patches' dtype, and a
    float32 hit count beside it (JAX's `lax.scan` of dynamic_update_slice
    adds, as in-place adds of Python-sliced blocks).

    agg: 'mean' (sum over hit count), 'nanmean' (NaN values are left out of
    both, counted per element) or 'sum'. A voxel nothing covers is 0/0 =
    NaN under the means. The host `quilt` keeps the nan-median.
    """
    if agg not in ('mean', 'nanmean', 'sum'):
        raise ValueError(f'bad agg {agg}')
    ndims = len(vol_shape)
    vol_shape = tuple(int(s) for s in vol_shape)
    slices = list(_slices(vol_shape, patch_size, stride))
    if patches.shape[0] != len(slices):
        raise ValueError(f'{patches.shape[0]} patches != {len(slices)} grid '
                         f'positions')
    trailing = tuple(patches.shape[1 + ndims:])
    nan_skip = agg == 'nanmean'
    acc = patches.new_zeros((*vol_shape, *trailing))
    cnt = torch.zeros((*vol_shape, *trailing) if nan_skip else vol_shape,
                      dtype=torch.float32, device=patches.device)
    for sl, patch in zip(slices, patches):
        if nan_skip:
            valid = ~torch.isnan(patch)
            acc[sl] += torch.where(valid, patch, 0)
            cnt[sl] += valid
        else:
            acc[sl] += patch
            cnt[sl] += 1
    if agg == 'sum':
        return acc
    if not nan_skip:
        cnt = cnt.reshape(cnt.shape + (1,) * len(trailing))
    return acc / cnt.to(acc.dtype)
