"""
N-D tensor utilities; counterpart of `neurite_tpu/utils/core.py` (reference
`neurite/tf/utils/utils.py`), with the same names, arguments and channels-last
[*spatial, C] tensors.

Randomized functions take `seed`: a `torch.Generator` on the tensors' device
(or an int, for a new one). JAX keys and torch generators draw different
numbers, so the tests hand both packages the same draws.

The 3-D interpolation and the 3-D SAME separable blur of a CUDA tensor run
the hand-written kernels of `ops/` (K4, K6); everything else here is plain
PyTorch, as it is plain XLA in the JAX package.
"""

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from neurite_tpu_torch import backend
from neurite_tpu_torch.py.utils import normalize_axes

__all__ = [
    'setup_device', 'interpn', 'resize', 'zoom', 'map_fn_axis',
    'volshape_to_ndgrid', 'volshape_to_meshgrid', 'ndgrid', 'meshgrid',
    'flatten', 'take', 'barycenter',
    'gaussian_kernel', 'separable_conv', 'subsample_axis',
    'softmax', 'logtanh', 'arcsinh', 'logistic', 'sigmoid',
    'logistic_fixed_ends', 'sigmoid_fixed_ends', 'soft_round', 'soft_delta',
    'odd_shifted_relu', 'minmax_norm', 'whiten', 'perlin_vol',
    'sub2ind2d', 'prod_n', 'soft_quantize', 'soft_digitize',
    'batch_channel_flatten', 'flatten_batch_channel', 'flatten_axes',
    'fftn', 'ifftn', 'fftshift', 'ifftshift',
    'complex_to_channels', 'channels_to_complex', 'batch_gather',
    'space_to_depth', 'depth_to_space',
    'as_generator',
]

###############################################################################
# helpers
###############################################################################


@functools.lru_cache(maxsize=512)
def _cached_constant(data, shape, np_dtype, dtype, device):
    a = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def device_constant(array, device, dtype=None):
    """
    The host array `array` as a tensor on `device`, made once per process
    and value: copying it anew at every call would put a host-to-device
    transfer on the path. Callers must not write to the result.
    """
    a = np.ascontiguousarray(array)
    return _cached_constant(a.tobytes(), a.shape, a.dtype.str, dtype,
                            str(torch.device(device)))


def as_float32(a, device):
    """A float32 tensor on `device`: a tensor is cast and moved (keeping its
    autograd graph), host data goes through `device_constant`."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.float32)
    return device_constant(np.asarray(a, np.float32), device)


def clip(x, lo, hi):
    """jnp.clip(x, lo, hi): NaN stays NaN, and at a tie the gradient goes
    half to each side (torch.clamp gives all of it to x)."""
    return torch.minimum(torch.maximum(x, x.new_full((), float(lo))),
                         x.new_full((), float(hi)))


def linspace(start, stop, num):
    """jnp.linspace(start, stop, num) of 0-d tensors, on their device and
    differentiable in both: start * (1 - s) + stop * s with s = k / (num-1)
    in float32, the last point exactly `stop`. Nothing is read back to the
    host."""
    if num < 2:
        return start.reshape(1)[:num]
    s = device_constant(np.arange(num - 1, dtype=np.float32)
                        / np.float32(num - 1), start.device)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def as_generator(seed, device=None):
    """Counterpart of `as_key`: a torch.Generator as it is, or a new one on
    `device` seeded with the int `seed`."""
    if seed is None:
        raise ValueError('a seed or torch.Generator is required for '
                         'randomized ops')
    if isinstance(seed, (int, np.integer)):
        return torch.Generator(
            device=backend.resolve_device(device)).manual_seed(int(seed))
    return seed


def setup_device(gpuid=None):
    """
    The CUDA devices to run on (reference `setup_device`,
    `neurite/tf/utils/utils.py:38-70`; JAX `utils/core.py:50-63`): every
    CUDA device, or the one at index `gpuid` (an int, or a string whose
    first comma-separated entry is one). Raises when there is no CUDA
    device: the port does not fall back to the CPU on its own.
    """
    backend.default_device()
    devices = [torch.device('cuda', i)
               for i in range(torch.cuda.device_count())]
    if gpuid is None or (isinstance(gpuid, str) and gpuid == ''):
        return devices
    if isinstance(gpuid, str):
        gpuid = int(gpuid.split(',')[0])
    return [devices[int(gpuid)]]


def uniform(generator, shape, low, high, device, dtype=torch.float32):
    """low + U[0, 1) * (high - low) on `device` (jax.random.uniform's form);
    low and high may be floats or broadcastable tensors."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return low + u * (high - low)


def batch_channel_flatten(x):
    """[B, ..., C] -> [B, V, C] (ref `utils.py:1175-1189`)."""
    return flatten_axes(x, range(1, x.ndim - 1))


flatten_batch_channel = batch_channel_flatten


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


###############################################################################
# interpolation
###############################################################################

def interpn(vol, loc, interp_method='linear', fill_value=None, impl='auto',
            max_disp=8.0, block=None, guard='runtime'):
    """
    N-D gridded interpolation (linear or nearest) of `vol` at locations `loc`.

    vol: [*vol_shape] or [*vol_shape, C]; loc: a list of N tensors of one
    shape, or one tensor [*out_shape, N] of voxel coordinates. fill_value is
    the value of points outside the volume; None clamps to the edge. Returns
    [*out_shape] (+C when vol had channels).

    A 3-D interpolation goes to `ops.warp.interpn_batch`: K4 for a CUDA
    tensor (float32), the plain gather chain for a CPU one; every other
    dimension runs the plain gather chain. `impl`,
    `max_disp`, `block` and `guard` pick among the JAX package's TPU engines
    and have no effect here: every engine computes this one exact function.

    Under spatial sharding (`parallel.spatial`) vol is this rank's block
    along the sharded axis and loc this rank's points in the whole volume's
    coordinates: vol is gathered (the gather rule), and the result is at
    this rank's points.

    Parity: reference `neurite/tf/utils/utils.py:73-220`, JAX
    `utils/core.py:70-192`.
    """
    del impl, max_disp, block, guard
    from neurite_tpu_torch.parallel import spatial as sharding
    if sharding.active() is not None:
        return sharding.gather_call(
            'interpn', lambda v: interpn(v, loc, interp_method, fill_value),
            vol, blocks=False)
    if isinstance(loc, (list, tuple)):
        loc = torch.stack(list(loc), -1)
    nb_dims = loc.shape[-1]
    if vol.ndim not in (nb_dims, nb_dims + 1):
        raise ValueError(
            f'Number of loc Tensors {nb_dims} does not match volume dimension '
            f'{vol.ndim - 1}')
    if interp_method not in ('linear', 'nearest'):
        raise ValueError(
            f'method should be linear or nearest, got: {interp_method}')
    if nb_dims == 3:
        from neurite_tpu_torch.ops import warp
        return warp.interpn_batch(vol[None], loc[None], interp_method,
                                  fill_value)[0]
    return interpn_plain(vol, loc, interp_method, fill_value)


def interpn_plain(vol, loc, interp_method='linear', fill_value=None,
                  batched=False):
    """
    The gather chain of `interpn`, in plain PyTorch: the plain version of K4
    and the path of every other case. With batched=True, vol and loc carry a
    leading batch axis of the same size.

    Linear: loc0 = clip(floor(loc)), loc1 = clip(loc0 + 1); the weight of
    corner bit 0 is loc1 - clip(loc) (so both corners collapse onto the edge),
    corners are summed in itertools.product order and their weights
    multiplied in axis order (`prod_n`). Nearest: round half to even, then
    clip. `fill_value` replaces every channel of a point whose unclipped loc
    is below 0 or above the last index on any axis.
    """
    nb = 1 if batched else 0
    nb_dims = loc.shape[-1]
    if vol.ndim not in (nb + nb_dims, nb + nb_dims + 1):
        raise ValueError(
            f'Number of loc Tensors {nb_dims} does not match volume dimension '
            f'{vol.ndim - nb - 1}')
    no_channel = vol.ndim == nb + nb_dims
    if no_channel:
        vol = vol[..., None]
    if not loc.is_floating_point():
        loc = loc.to(vol.dtype if vol.is_floating_point() else torch.float32)
    elif vol.is_floating_point() and vol.dtype != loc.dtype:
        loc = loc.to(vol.dtype)

    volshape = tuple(vol.shape[nb:-1])
    max_loc = [d - 1 for d in volshape]
    flat_vol = vol.reshape(-1, vol.shape[-1])
    if batched:
        nvox = int(np.prod(volshape))
        off = torch.arange(vol.shape[0], device=vol.device) * nvox
        off = off.reshape(-1, *[1] * (loc.ndim - 2))
    else:
        off = 0

    def gather(subs):
        return flat_vol[sub2ind2d(volshape, subs) + off]

    if interp_method == 'linear':
        loc0 = torch.floor(loc)
        clipped = [clip(loc[..., d], 0, max_loc[d]) for d in range(nb_dims)]
        loc0lst = [loc0[..., d].clamp(0, max_loc[d]) for d in range(nb_dims)]
        loc1 = [(loc0lst[d] + 1).clamp(0, max_loc[d]) for d in range(nb_dims)]
        locs = [[f.long() for f in loc0lst], [f.long() for f in loc1]]
        diff_loc1 = [loc1[d] - clipped[d] for d in range(nb_dims)]
        diff_loc0 = [1 - d for d in diff_loc1]
        weights_loc = [diff_loc1, diff_loc0]
        interp_vol = 0
        for c in itertools.product([0, 1], repeat=nb_dims):
            vol_val = gather([locs[c[d]][d] for d in range(nb_dims)])
            wt = prod_n([weights_loc[c[d]][d] for d in range(nb_dims)])
            interp_vol = interp_vol + wt[..., None] * vol_val
    elif interp_method == 'nearest':
        roundloc = torch.round(loc).long()
        interp_vol = gather([roundloc[..., d].clamp(0, max_loc[d])
                             for d in range(nb_dims)])
    else:
        raise ValueError(
            f'method should be linear or nearest, got: {interp_method}')

    if fill_value is not None:
        oob = torch.zeros(loc.shape[:-1], dtype=torch.bool, device=loc.device)
        for d in range(nb_dims):
            oob = oob | (loc[..., d] < 0) | (loc[..., d] > max_loc[d])
        interp_vol = torch.where(
            oob[..., None],
            torch.full((), fill_value, dtype=interp_vol.dtype,
                       device=interp_vol.device), interp_vol)
    return interp_vol[..., 0] if no_channel else interp_vol


def resize(vol, zoom_factor, interp_method='linear', new_shape=None):
    """
    N-D volume resize by `zoom_factor` (scipy-zoom-like). A list zoom_factor
    sets ndims (vol may have one more, channel, axis); a scalar one needs vol
    [*spatial, C]. `new_shape` overrides the target spatial shape.

    Parity: reference `neurite/tf/utils/utils.py:223-264`; the resize is
    axis-separable, so it runs as per-axis two-take passes
    (`ops.resize.resize_separable`), identical to `interpn` on the zoom grid.
    Under spatial sharding (`parallel.spatial`) vol is this rank's block
    along the sharded axis: it is gathered (the gather rule), and the
    result is the rank's block of the resized volume.
    """
    from neurite_tpu_torch.parallel import spatial as sharding
    if sharding.active() is not None:
        return sharding.gather_call(
            'resize', lambda v: resize(v, zoom_factor, interp_method,
                                       new_shape), vol)
    if isinstance(zoom_factor, (list, tuple)):
        ndims = len(zoom_factor)
        vol_shape = vol.shape[:ndims]
        if len(vol.shape) not in (ndims, ndims + 1):
            raise ValueError(f'zoom_factor length {ndims} does not match '
                             f'volume rank {vol.ndim}')
    else:
        vol_shape = vol.shape[:-1]
        ndims = len(vol_shape)
        zoom_factor = [zoom_factor] * ndims
    if new_shape is None:
        if all(z == 1 for z in zoom_factor):
            return vol
        new_shape = [int(vol_shape[d] * zoom_factor[d]) for d in range(ndims)]
    from neurite_tpu_torch.ops import resize as resize_ops
    return resize_ops.resize_separable(vol, tuple(int(s) for s in new_shape),
                                       method=interp_method)


zoom = resize


###############################################################################
# grids
###############################################################################

def volshape_to_ndgrid(volshape, dtype=torch.int32, device=None):
    """ndgrid ('ij') of ranges over a volume shape (ref `utils.py:333-351`)."""
    if not all(float(d).is_integer() for d in volshape):
        raise ValueError('volshape needs to be a list of integers')
    device = backend.resolve_device(device)
    return ndgrid(*[torch.arange(int(d), dtype=dtype, device=device)
                    for d in volshape])


def volshape_to_meshgrid(volshape, dtype=torch.int32, device=None):
    """meshgrid ('xy') of ranges over a volume shape (ref `utils.py:354-375`)."""
    if not all(float(d).is_integer() for d in volshape):
        raise ValueError('volshape needs to be a list of integers')
    device = backend.resolve_device(device)
    return meshgrid(*[torch.arange(int(d), dtype=dtype, device=device)
                      for d in volshape])


def ndgrid(*args):
    """N-D grid with 'ij' indexing (ref `utils.py:378-391`)."""
    return meshgrid(*args, indexing='ij')


def meshgrid(*args, indexing='xy'):
    """Broadcast 1-D tensors onto an N-D grid (ref `utils.py:394-476`)."""
    if indexing not in ('xy', 'ij'):
        raise ValueError("indexing parameter must be either 'xy' or 'ij'")
    return list(torch.meshgrid(*args, indexing=indexing))


def grid_points(shape, device, dtype=torch.float32):
    """The voxel grid of `shape` as one tensor [*shape, N] of coordinates."""
    return torch.stack(volshape_to_ndgrid(shape, dtype=dtype, device=device),
                       -1)


def flatten(v):
    """Flatten to 1-D (ref `utils.py:479-490`)."""
    return v.reshape(-1)


def take(x, indices, axis):
    """
    np.take-like gather along an axis (ref `utils.py:493-509`), as
    jnp.take: the result is x.shape[:axis] + indices.shape +
    x.shape[axis + 1:], negative indices count from the end, and an index
    outside [-n, n) gives NaN (the smallest value for an integer x).
    """
    axis = axis % x.ndim
    n = x.shape[axis]
    idx = torch.as_tensor(indices, device=x.device)
    if idx.is_floating_point():
        raise TypeError('take needs integer indices')
    idx = idx.long()
    safe = torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))
    out = x.index_select(axis, safe.reshape(-1)).reshape(
        *x.shape[:axis], *idx.shape, *x.shape[axis + 1:])
    valid = ((idx >= -n) & (idx < n)).reshape(
        *(1,) * axis, *idx.shape, *(1,) * (x.ndim - axis - 1))
    fill = (float('nan') if out.is_floating_point() or out.is_complex()
            else torch.iinfo(out.dtype).min)
    return torch.where(valid, out, torch.full((), fill, dtype=out.dtype,
                                              device=out.device))


def barycenter(x, axes=None, normalize=False, shift_center=False,
               dtype=torch.float32):
    """
    Center of mass of x along `axes` (None: all), computed in float32 on
    the coordinate grid, optionally normalized to unit length or shifted to
    the image center; 0 where the mass is 0. Returns [*other axes, len(axes)].

    Parity: reference `neurite/tf/utils/utils.py:512-573` (SynthMorph).
    """
    x = x.to(torch.float32)
    axes_all = range(x.ndim)
    if axes is None:
        axes = tuple(axes_all)
    axes_sub = tuple(ax for ax in axes_all if ax not in axes)
    if axes_sub:
        x = x.permute(*axes_sub, *axes)
    num_dim = len(axes)
    vol_shape = x.shape[-num_dim:]
    grid = [np.arange(f, dtype=np.float32) for f in vol_shape]
    if shift_center:
        grid = [g - (v - 1) / 2 for g, v in zip(grid, vol_shape)]
    if normalize:
        grid = [g / v for g, v in zip(grid, vol_shape)]
    grid = np.stack(np.meshgrid(*grid, indexing='ij'), axis=-1)
    grid = device_constant(grid.astype(np.float32), x.device)
    red = tuple(axes_all)[-num_dim:]
    x = x[..., None]
    num = torch.sum(grid * x, dim=red)
    den = torch.sum(x, dim=red)
    zero = den == 0
    out = torch.where(zero, torch.zeros((), device=x.device),
                      num / torch.where(zero, torch.ones_like(den), den))
    return out.to(dtype)


def map_fn_axis(fn, elems, axis, **kwargs):
    """
    Apply `fn` to each slice of `elems` (a tensor, or a list of tensors
    with one axis each) along `axis`, and stack the results where the
    mapped axis was: at `axis` (-1: the last axis), clamped to the result's
    rank, as the JAX package's vmap and `_restore` place it. A list input
    hands fn a tuple of slices; a list or tuple result is restacked per
    entry.

    Parity: reference `neurite/tf/utils/utils.py:272-330`; JAX
    `utils/core.py:236-273`. The slices run one after another.
    """
    kwargs.pop('fn_output_signature', None)

    def _restore(ys, ax):
        y = torch.stack(ys)
        if ax < 0:
            ax = y.ndim - 1
        return torch.movedim(y, 0, min(ax, y.ndim - 1))

    def _mapped(n, get):
        outs = [fn(get(i)) for i in range(n)]
        if isinstance(outs[0], (tuple, list)):
            return [list(o) for o in zip(*outs)], True
        return outs, False

    if not isinstance(elems, (tuple, list)):
        if isinstance(axis, (tuple, list)):
            raise ValueError('axis cannot be list if elements are not list')
        outs, is_list = _mapped(elems.shape[axis],
                                lambda i: elems.select(axis, i))
        if is_list:
            return [_restore(y, axis) for y in outs]
        return _restore(outs, axis)
    if not isinstance(axis, (tuple, list)):
        axis = [axis] * len(elems)
    outs, is_list = _mapped(
        elems[0].shape[axis[0]],
        lambda i: tuple(e.select(a, i) for e, a in zip(elems, axis)))
    if is_list:
        return [_restore(y, a) for y, a in zip(outs, axis)]
    return _restore(outs, axis[0])


def sub2ind2d(siz, subs):
    """Row-major linear index from per-dimension subscripts (ref
    `utils.py:1068-1082`)."""
    if len(siz) != len(subs):
        raise ValueError(f'found inconsistent siz and subs: {len(siz)} '
                         f'{len(subs)}')
    k = np.cumprod(siz[::-1])
    ndx = subs[-1]
    for i, v in enumerate(subs[:-1][::-1]):
        ndx = ndx + v * int(k[i])
    return ndx


def prod_n(lst):
    """Fold-multiply a list of tensors (ref `utils.py:1085-1092`)."""
    prod = lst[0]
    for p in lst[1:]:
        prod = prod * p
    return prod


###############################################################################
# filtering
###############################################################################

def gaussian_kernel(sigma, windowsize=None, indexing='ij', separate=False,
                    random=False, min_sigma=0, dtype=torch.float32, seed=None,
                    device=None):
    """
    N-D Gaussian kernel (or a list of separated 1-D kernels).

    With random=True each axis' sigma is drawn uniformly from [min_sigma,
    sigma) with `seed` (a torch.Generator on `device`); the window is sized
    from the nominal sigma, round(3 sigma) * 2 + 1, as in the reference
    (`utils.py:581-662`). sigma may also be a list of 0-d tensors (a sigma
    drawn on the device) when `windowsize` is given: the kernel is then
    computed on the device, without a host sync.
    """
    if not dtype.is_floating_point:
        raise ValueError(f'{dtype} is not floating-point')
    if not isinstance(sigma, (list, tuple)):
        sigma = [sigma]
    if not isinstance(min_sigma, (list, tuple)):
        min_sigma = [min_sigma] * len(sigma)
    eps = float(torch.finfo(dtype).eps)
    is_static = all(isinstance(s, (int, float, np.floating, np.integer))
                    for s in sigma)
    if is_static:
        sigma = [max(float(f), eps) for f in sigma]
    else:
        device = next(s.device for s in sigma if torch.is_tensor(s))
    min_sigma = [max(float(f), eps) for f in min_sigma]
    device = backend.resolve_device(device)

    if windowsize is None:
        if not is_static:
            raise ValueError('windowsize must be given when sigma is a tensor')
        windowsize = [int(np.round(f * 3) * 2 + 1) for f in sigma]
    if not isinstance(windowsize, (list, tuple)):
        windowsize = [windowsize]
    if len(sigma) != len(windowsize):
        raise ValueError(f'sigma {sigma} and width {windowsize} differ in '
                         'length')

    mesh = [-0.5 * (np.arange(w) - (w - 1) / 2) ** 2 for w in windowsize]
    if not separate:
        mesh = np.meshgrid(*mesh, indexing=indexing)
    mesh = [device_constant(m, device, dtype) for m in mesh]

    if random:
        gen = as_generator(seed, device)
        sigma = [uniform(gen, (), a, b, device, dtype)
                 for a, b in zip(min_sigma, sigma)]
    exponent = [m / torch.as_tensor(s, dtype=dtype) ** 2
                for m, s in zip(mesh, sigma)]
    if not separate:
        exponent = [sum(exponent)]
    kernel = [torch.exp(x) for x in exponent]
    kernel = [x / torch.sum(x) for x in kernel]
    return kernel if len(kernel) > 1 else kernel[0]


def _same_pad(length, width, stride, dilation):
    """(low, high) zero padding of TF/XLA 'SAME' along one axis."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (width - 1) * dilation + 1 - length, 0)
    return total // 2, total - total // 2


def conv_axis(x, k, axis, padding='SAME', stride=1, dilation=1):
    """
    Cross-correlate x [N, *space] with the 1-D taps k along spatial axis
    `axis` (0-based), zero padded ('SAME') or not ('VALID'): the plain
    per-axis pass of `separable_conv` (`F.conv{1,2,3}d` over one channel).
    """
    nd = x.ndim - 1
    if nd not in (1, 2, 3):
        raise ValueError(f'separable_conv takes 1 to 3 spatial dims, got {nd}')
    width = k.numel()
    shape = [1] * nd
    shape[axis] = width
    w = k.to(x.dtype).reshape(1, 1, *shape)
    pad = [0] * (2 * nd)
    mode = str(padding).upper()
    if mode == 'SAME':
        lo, hi = _same_pad(x.shape[1 + axis], width, stride, dilation)
        pad[2 * (nd - 1 - axis)] = lo
        pad[2 * (nd - 1 - axis) + 1] = hi
    elif mode != 'VALID':
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    strides = [1] * nd
    strides[axis] = stride
    dilations = [1] * nd
    dilations[axis] = dilation
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    out = conv(F.pad(x[:, None], pad), w, stride=strides, dilation=dilations)
    return out[:, 0]


def separable_conv(x, kernels, axis=None, batched=False, padding='SAME',
                   strides=None, dilations=None, impl='auto'):
    """
    Apply 1-D kernels along chosen spatial axes of a [*spatial, C] (or
    [B, *spatial, C] when batched) tensor; the same filters apply to every
    feature.

    A 3-D CUDA tensor with padding 'SAME', stride 1 and dilation 1 takes the
    separable blur kernel K6 (`ops.blur`, float32 only); every other case runs
    `conv_axis` per axis, and so does every case with impl='plain' (K6's
    plain version on any device).

    Parity: reference `neurite/tf/utils/utils.py:665-752`.
    """
    if not batched:
        x = x[None]
    num_dim = x.ndim - 2
    if np.isscalar(axis):
        axis = [axis]
    if axis is None:
        axis = list(range(num_dim))
    if not all(ax in range(num_dim) for ax in axis):
        raise ValueError('non-spatial axis passed')

    def _conform(v):
        v = [1] if v is None else [int(s) for s in np.ravel(v)]
        return v * len(axis) if len(v) == 1 else v
    strides = _conform(strides)
    dilations = _conform(dilations)
    if len(strides) != len(axis) or len(dilations) != len(axis):
        raise ValueError('number of strides/dilations and axes differ')
    if not isinstance(kernels, (tuple, list)):
        kernels = [kernels]
    if len(kernels) == 1:
        kernels = list(kernels) * len(axis)
    if len(kernels) != len(axis):
        raise ValueError('number of kernels and axes differ')
    kernels = [torch.as_tensor(k, device=x.device).to(x.dtype).reshape(-1)
               for k in kernels]

    # merge batch and features: [B, *space, C] -> [B*C, *space]
    b, c = x.shape[0], x.shape[-1]
    shape_space = tuple(x.shape[1:-1])
    y = x.movedim(-1, 1).reshape(b * c, *shape_space)

    if impl not in ('auto', 'plain'):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if (impl == 'auto' and x.is_cuda and num_dim == 3
            and str(padding).upper() == 'SAME'
            and len(set(axis)) == len(axis)
            and all(s == 1 for s in strides)
            and all(d == 1 for d in dilations)):
        from neurite_tpu_torch.ops import blur
        ks3 = [None] * 3
        for ax, k in zip(axis, kernels):
            ks3[ax] = k
        y = blur.blur3d(y.contiguous(), ks3)
    else:
        for ax, k, s, d in zip(axis, kernels, strides, dilations):
            y = conv_axis(y, k, ax, padding, s, d)
    y = y.reshape(b, c, *y.shape[1:]).movedim(1, -1)
    return y if batched else y[0]


def subsample_axis(x, stride_min=1, stride_max=8, axes=None, prob=1,
                   upsample=True, seed=None):
    """
    Randomly subsample x along one randomly drawn axis by a random factor in
    [stride_min, stride_max) with nearest-neighbour resampling, and with
    upsample=True resample back to the input shape (thick slices).

    The draws stay on the device: every candidate axis is resampled and the
    drawn one selected, so the shape is static and nothing syncs.
    upsample=False changes the shape with the draw and reads it on the host.

    Parity: reference `neurite/tf/utils/utils.py:754-826`.
    """
    num_dim = x.ndim
    if axes is None:
        axes = list(range(num_dim))
    if np.isscalar(axes):
        axes = [axes]
    if not all(i in range(num_dim) for i in axes):
        raise ValueError('invalid axis passed')
    if not 0 < stride_min <= stride_max:
        raise ValueError('invalid strides')
    if not 0 <= prob <= 1:
        raise ValueError(f'{prob} not a probability')
    gen = as_generator(seed, x.device)
    ind, thick = draw_subsample(gen, len(axes), stride_min, stride_max, prob,
                                x.device)
    if not upsample:
        thick_c = float(thick)
        ax = axes[int(ind)]
        width = x.shape[ax]
        num_slice = int(width / thick_c + 0.5)
        idx = np.floor(np.linspace(0., width - 1., num_slice)
                       + 0.5).astype(np.int64)
        return x.index_select(ax, torch.from_numpy(idx).to(x.device))
    return apply_subsample(x, ind, thick, axes)


def draw_subsample(generator, n_axes, stride_min, stride_max, prob, device):
    """The draws of `subsample_axis`: the axis index among the candidates
    and the slice thickness (1 where the prob gate fails), as 0-d tensors."""
    ind = torch.randint(0, n_axes, (), generator=generator, device=device)
    thick = uniform(generator, (), float(stride_min), float(stride_max),
                    device)
    if prob < 1:
        gate = torch.rand((), generator=generator, device=device) < prob
        thick = torch.where(gate, thick, torch.ones_like(thick))
    return ind, thick


def apply_subsample(x, ind, thick, axes):
    """Thick slices along axes[ind] with thickness `thick`: the down- and
    up-sampling gathers composed into one (JAX `_composed_indices`)."""
    out = x
    for i, ax in enumerate(axes):
        width = x.shape[ax]
        num_slice = torch.floor(width / thick + 0.5).to(torch.int32)
        pos = torch.arange(width, dtype=torch.float32, device=x.device)
        u = torch.floor(pos * (num_slice - 1) / max(width - 1, 1) + 0.5)
        denom = torch.clamp(num_slice - 1, min=1).to(torch.float32)
        idx = torch.floor(u * (width - 1) / denom + 0.5).long()
        out = torch.where(ind == i, x.index_select(ax, idx), out)
    return out


###############################################################################
# intensity
###############################################################################

def minmax_norm(x, axis=None):
    """Safe min-max normalization (ref `utils.py:953-967`)."""
    if axis is None:
        axis = tuple(range(x.ndim))
    x_min = torch.amin(x, dim=axis, keepdim=True)
    x_max = torch.amax(x, dim=axis, keepdim=True)
    den = x_max - x_min
    zero = den == 0
    return torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device),
                       (x - x_min) / torch.where(zero, torch.ones_like(den),
                                                 den))


def logistic(x, x0=0., alpha=1., L=1.):
    """L / (1 + exp(-alpha*(x-x0))) (ref `utils.py:878-886`)."""
    if L <= 0:
        raise ValueError('L (height of logistic) should be > 0')
    if alpha <= 0:
        raise ValueError('alpha (slope) of logistic should be > 0')
    return L / (1 + torch.exp(-alpha * (x - x0)))


def soft_delta(x, x0=0., alpha=100, reg='l1'):
    """Soft delta bump around x0 (ref `utils.py:929-941`)."""
    if reg == 'l1':
        xa = torch.abs(x - x0)
    elif reg == 'l2':
        xa = torch.square(x - x0)
    else:
        raise ValueError(f"reg must be 'l1' or 'l2', got {reg!r}")
    return (1 - logistic(xa, alpha=alpha)) * 2


def softmax(x, axis=-1, alpha=1):
    """Softmax with a temperature-like alpha multiplier (ref
    `utils.py:833-857`)."""
    x = alpha * x
    e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
    return e / torch.sum(e, dim=axis, keepdim=True)


def logtanh(x, a=1):
    """tanh(x) * log(2 + a|x|) (ref `utils.py:860-866`)."""
    return torch.tanh(x) * torch.log(2 + a * torch.abs(x))


def arcsinh(x, alpha=1):
    """asinh(alpha*x)/alpha (ref `utils.py:869-875`)."""
    return torch.asinh(x * alpha) / alpha


def sigmoid(x):
    """Standard sigmoid (ref `utils.py:889-890`)."""
    return logistic(x, x0=0., alpha=1., L=1.)


def logistic_fixed_ends(x, start=-1., end=1., L=1., **kwargs):
    """Logistic linearly corrected so f(start) = 0 and f(end) = L (ref
    `utils.py:893-916`); x is clipped to [start, end]."""
    if end <= start:
        raise ValueError('End of fixed points should be greater than start')
    x = clip(x, start, end)
    xv = logistic(x, L=L, **kwargs)
    sv = logistic(torch.tensor(float(start)), L=L, **kwargs)
    ev = logistic(torch.tensor(float(end)), L=L, **kwargs)
    df = end - start
    corr = (end - x) / df * (-sv.item()) + (x - start) / df * (-ev.item() + L)
    return xv + corr


def sigmoid_fixed_ends(x, start=-1., end=1., L=1., **kwargs):
    """Sigmoid with fixed ends (ref `utils.py:919-920`); as the reference,
    it ignores start, end and L and fixes them to (-1, 1, 1)."""
    del start, end, L, kwargs
    return logistic_fixed_ends(x, start=-1., end=1., L=1., x0=0., alpha=1.)


def soft_round(x, alpha=25):
    """Differentiable rounding (ref `utils.py:923-926`)."""
    fx = torch.floor(x)
    return fx + logistic_fixed_ends(x - fx, start=0., end=1., x0=0.5,
                                    alpha=alpha)


def odd_shifted_relu(x, shift=-0.5, scale=2.0):
    """Odd-symmetric shifted ReLU (ref `utils.py:944-951`)."""
    shift, scale = float(shift), float(scale)
    return scale * torch.relu(x - shift) - scale * torch.relu(-x - shift)


def whiten(x, mean=0., std=1.):
    """Whiten all of x to the given mean and std (population std, ddof 0;
    ref `utils.py:970-984`)."""
    x = x - torch.mean(x)
    return x / torch.std(x, correction=0) * std + mean


def soft_quantize(x, bin_centers=None, nb_bins=16, alpha=1,
                  min_clip=-np.inf, max_clip=np.inf, return_log=False):
    """
    Softly quantize (digitize) intensities via RBF bin assignment: each value
    v contributes exp(-alpha * (clip(v) - c)^2) to the bin centered at c.
    Returns [..., B] float32. Bin centers default to linspace(min(x),
    max(x), nb_bins) over the whole tensor, computed on its device.
    `bin_centers` and `nb_bins` exclude each other (so nb_bins=None must
    go with bin_centers); return_log gives the exponent.

    Parity: reference `neurite/tf/utils/utils.py:1095-1172`, JAX
    `utils/core.py:764-795`.
    """
    x = x.to(torch.float32)
    if bin_centers is not None:
        if nb_bins is not None:
            raise ValueError('cannot provide both bin_centers and nb_bins')
        bin_centers = as_float32(bin_centers, x.device)
    else:
        if nb_bins is None:
            nb_bins = 16
        bin_centers = linspace(x.min(), x.max(), nb_bins)

    x = clip(x[..., None], min_clip, max_clip)
    log = -alpha * torch.square(x - bin_centers)
    return log if return_log else torch.exp(log)


soft_digitize = soft_quantize


###############################################################################
# other
###############################################################################

def _perlin_scale_shapes(vol_shape, min_scale, max_scale):
    if max_scale is None:
        max_scale = int(np.ceil(np.log2(np.max(vol_shape))))
    return [tuple(int(s) for s in np.ceil([f / 2 ** i for f in vol_shape]))
            for i in range(min_scale, max_scale + 1)], max_scale


def draw_perlin_vol(vol_shape, min_scale=0, max_scale=None,
                    wt_type='monotonic', seed=None, device=None):
    """
    The draws of `perlin_vol`: the raw scale weights (i + 1 for scale 2^i
    when monotonic, else U[0, 1) each) and one U[0, 1) volume per scale of
    ceil(vol_shape / 2^i) voxels, as (wts [n_scales], [vol, ...]).

    The JAX package draws every scale's volume from one key
    (`keys[n_scales]`, JAX `utils/core.py:733`), so its volumes are
    prefixes of one stream; these are drawn one after another from the
    generator.
    """
    if wt_type not in ('monotonic', 'random'):
        raise ValueError(f"wt_type should be in 'monotonic', 'random', got: "
                         f"{wt_type}")
    device = backend.resolve_device(device)
    gen = as_generator(seed, device)
    shapes, max_scale = _perlin_scale_shapes(vol_shape, min_scale, max_scale)
    if wt_type == 'monotonic':
        wts = torch.arange(min_scale + 1, max_scale + 2, dtype=torch.float32,
                           device=device)
    else:
        wts = torch.rand(len(shapes), generator=gen, device=device)
    return wts, [torch.rand(sc, generator=gen, device=device)
                 for sc in shapes]


def perlin_vol_from_draws(vol_shape, draws, interp_method='linear'):
    """The apply of `perlin_vol`: each scale's volume resized to vol_shape,
    weighted by its weight over the weights' sum, summed."""
    wts, vols = draws
    wts = (wts / torch.sum(wts)).to(torch.float32)
    vol = 0
    for i, rand_vol in enumerate(vols):
        interp = resize(rand_vol, [vol_shape[d] / rand_vol.shape[d]
                                   for d in range(len(vol_shape))],
                        interp_method=interp_method,
                        new_shape=list(vol_shape))
        vol = vol + wts[i] * interp
    return vol


def perlin_vol(vol_shape, min_scale=0, max_scale=None, interp_method='linear',
               wt_type='monotonic', seed=None, device=None):
    """
    Legacy multi-scale uniform-noise "Perlin" volume: the sum of upsampled
    U[0, 1) volumes at dyadic scales 2^min_scale .. 2^max_scale (None: up to
    the largest side), with monotonic or random weights that sum to 1.
    `draw_perlin_vol` and `perlin_vol_from_draws` are its draw and apply.

    Parity: reference `neurite/tf/utils/utils.py:991-1065`, JAX
    `utils/core.py:699-739`.
    """
    draws = draw_perlin_vol(vol_shape, min_scale, max_scale, wt_type, seed,
                            device)
    return perlin_vol_from_draws(vol_shape, draws, interp_method)


def fftn(x, axes=None, inverse=False):
    """
    FFT along any axes (None: all); real inputs are promoted to complex64
    (ref `utils.py:1229-1272`).
    """
    axes = normalize_axes(axes, tuple(x.shape), none_means_all=True)
    if not x.is_complex():
        x = x.to(torch.complex64)
    fft = torch.fft.ifftn if inverse else torch.fft.fftn
    return fft(x, dim=axes)


def ifftn(x, axes=None):
    """Inverse FFT along any axes (ref `utils.py:1275-1277`)."""
    return fftn(x, axes, inverse=True)


def fftshift(x, axes=None):
    """Shift the zero frequency to the center along `axes` (None: all), as
    jnp.fft.fftshift."""
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x, axes=None):
    """Inverse of `fftshift`, as jnp.fft.ifftshift."""
    return torch.fft.ifftshift(x, dim=axes)


def complex_to_channels(x):
    """Complex [..., N] -> real [..., 2N], real parts then imaginary (ref
    `utils.py:1285-1306`)."""
    if not x.is_complex():
        raise ValueError('non-complex input passed')
    return torch.cat((x.real, x.imag), dim=-1)


def channels_to_complex(x):
    """Real [..., 2N] -> complex [..., N], the first half the real parts
    (ref `utils.py:1309-1341`); anything but float64 is computed in
    float32, so the result is complex64."""
    if x.is_complex():
        raise ValueError('complex input passed')
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    real, imag = torch.chunk(x, 2, dim=-1)
    return torch.complex(real, imag)


def batch_gather(reference, indices):
    """Per-batch-row gather: out[b] = reference[b, indices[b]] (ref
    `utils.py:1348-1379`)."""
    indices = torch.as_tensor(indices, device=reference.device).long()
    rows = torch.arange(reference.shape[0], device=reference.device)
    return reference[rows.reshape(-1, *(1,) * (indices.ndim - 1)), indices]


def space_to_depth(x, block=2, batched=True):
    """
    Fold `block`-sized spatial tiles into channels: [B, *spatial, C] ->
    [B, *spatial / block, C * block^N], the block offsets (in axis order)
    ahead of the channel. A reshape and a permute, as in the JAX package
    (`utils/core.py:873-903`), so the numbers are the same.
    """
    nd = x.ndim - 1 - int(batched)
    lead = 1 if batched else 0
    shape = tuple(x.shape)
    for d in range(nd):
        if shape[lead + d] % block:
            raise ValueError(f'spatial dim {shape[lead + d]} not divisible '
                             f'by block {block}')
    split = [shape[0]] if batched else []
    for d in range(nd):
        split += [shape[lead + d] // block, block]
    split += [shape[-1]]
    x = x.reshape(split)
    perm = [0] if batched else []
    perm += [lead + 2 * d for d in range(nd)]
    perm += [lead + 2 * d + 1 for d in range(nd)]
    perm += [x.ndim - 1]
    out_spatial = [shape[lead + d] // block for d in range(nd)]
    return x.permute(perm).reshape(*shape[:lead], *out_spatial,
                                   shape[-1] * block ** nd)


def depth_to_space(x, block=2, batched=True):
    """Inverse of `space_to_depth` (JAX `utils/core.py:906-926`)."""
    nd = x.ndim - 1 - int(batched)
    lead = 1 if batched else 0
    shape = tuple(x.shape)
    c_out = shape[-1] // block ** nd
    if shape[-1] != c_out * block ** nd:
        raise ValueError(f'channels {shape[-1]} not divisible by '
                         f'block^{nd}')
    x = x.reshape(*shape[:lead + nd], *[block] * nd, c_out)
    perm = [0] if batched else []
    for d in range(nd):
        perm += [lead + d, lead + nd + d]
    perm += [x.ndim - 1]
    out_spatial = [shape[lead + d] * block for d in range(nd)]
    return x.permute(perm).reshape(*shape[:lead], *out_spatial, c_out)
