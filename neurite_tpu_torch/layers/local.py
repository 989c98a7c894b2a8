"""
"Local" layers, with per-voxel parameters, including LocallyConnected
(an unshared-weight convolution). Counterpart of
`neurite_tpu/layers/local.py` (reference `neurite/tf/layers.py`, cited per
class), under the same names, parameter names and parameter layouts.

Torch needs shapes at construction, so every layer whose parameters depend
on its input takes `input_shape=(*spatial, C)` (the input without its batch
axis), as `models.unet` does. Parameters are drawn on the CPU from a
`torch.Generator` (seed 0 when none is given) and then moved to `device`
(the card unless the caller passes device='cpu'). An initializer is a
callable `init(generator, shape, dtype)`: `normal_init`, `lecun_normal` and
`zeros_init` are the defaults the JAX layers use.

LocallyConnected routes as `local.py:324-407` does, with the device in place
of the TPU test: a 3-D layer with transposed weights takes the CUDA kernels
K7/K8/K9 (`ops/lc_cuda.py`) for a CUDA tensor; other transposed layers
take the plain tap sum (`ops/lc_tap.py`); keras-layout layers take the
per-tap form or one batched matmul (`einsum('bvi,vio->bvo')`) under the same
1 GB rule. The JAX switch `NEURITE_PALLAS_LC` is not read.
"""

import itertools
import math

import torch
import torch.nn as nn

from neurite_tpu_torch import backend
from neurite_tpu_torch.models.unet import (_lecun_normal, _tuple,
                                           get_activation)
from neurite_tpu_torch.ops import lc_cuda, lc_tap
from neurite_tpu_torch.utils import spatial

__all__ = ['LocalBias', 'LocalLinear', 'LocalParamLayer',
           'LocalParamWithInput', 'LocalParam', 'LocalCrossLinear',
           'LocalCrossLinearTrf', 'LocallyConnected', 'LocallyConnected1D',
           'LocallyConnected2D', 'LocallyConnected3D', 'normal_init',
           'lecun_normal', 'zeros_init']


def normal_init(stddev=0.05, mean=0.0):
    """mean + stddev * standard normal (the JAX layers' `_normal_init`)."""
    def init(generator, shape, dtype=torch.float32):
        w = torch.randn(tuple(shape), generator=generator)
        return (mean + stddev * w).to(dtype)
    return init


def lecun_normal():
    """flax `lecun_normal`: a normal truncated to +-2 std with variance
    1/fan_in, where fan_in = prod(shape[:-1]) as flax's variance_scaling
    computes it (in axis -2, out axis -1, the rest receptive field)."""
    def init(generator, shape, dtype=torch.float32):
        fan_in = math.prod(shape[:-1])
        return _lecun_normal(tuple(shape), fan_in, generator).to(dtype)
    return init


def zeros_init():
    def init(generator, shape, dtype=torch.float32):
        del generator
        return torch.zeros(tuple(shape), dtype=dtype)
    return init


class _Local(nn.Module):
    """Base of the local layers: their parameters are stored in the flax
    layout under the flax names, so `convert` copies them as they are."""

    flax_same_layout = True

    def __init__(self, generator, device):
        super().__init__()
        self._generator = generator or torch.Generator().manual_seed(0)
        self._device = backend.resolve_device(device)

    def _param(self, name, init, shape, dtype=torch.float32):
        w = init(self._generator, tuple(int(s) for s in shape), dtype)
        setattr(self, name, nn.Parameter(w.to(self._device)))

    def _done(self):
        del self._generator, self._device


class LocalBias(_Local):
    """Per-voxel additive bias: out[v] = in[v] + b[v]*mult (ref
    `layers.py:746-775`)."""

    def __init__(self, input_shape, my_initializer=None, biasmult=1.0,
                 generator=None, device=None):
        super().__init__(generator, device)
        self.biasmult = biasmult
        self._param('kernel', my_initializer or normal_init(), input_shape)
        self._done()

    def forward(self, x):
        return x + self.kernel * self.biasmult


class LocalLinear(_Local):
    """Per-voxel affine: out[v] = a[v]*in[v] + b[v] (ref
    `layers.py:778-808`)."""

    def __init__(self, input_shape, initializer=None, generator=None,
                 device=None):
        super().__init__(generator, device)
        init = initializer or normal_init()
        self._param('mult', init, input_shape)
        self._param('bias', init, input_shape)
        self._done()

    def forward(self, x):
        return x * self.mult + self.bias


class LocalParamLayer(_Local):
    """
    Trainable free tensor exposed as a layer output, broadcast over the
    batch (ref `layers.py:1711-1907`, LocalParamLayer / LocalParamWithInput /
    LocalParam, which one module covers). Call with any tensor carrying the
    batch axis (otherwise ignored), or with batch_size.
    """

    def __init__(self, shape, initializer=None, mult=1.0, generator=None,
                 device=None):
        super().__init__(generator, device)
        self.shape = tuple(shape)
        self.mult = mult
        self._param('kernel', initializer or normal_init(), self.shape)
        self._done()

    def forward(self, x=None, batch_size=None):
        out = self.kernel[None] * self.mult
        if x is not None:
            batch_size = x.shape[0]
        if batch_size is not None:
            out = out.expand(batch_size, *self.shape)
        return out


LocalParamWithInput = LocalParamLayer
LocalParam = LocalParamLayer


class LocalCrossLinear(_Local):
    """
    Per-voxel feature mixing: out[b,v,:] = in[b,v,:] @ M[v] (+ bias[v])
    (ref `layers.py:1535-1607`), one einsum.
    """

    def __init__(self, input_shape, output_features, mult_initializer=None,
                 bias_initializer=None, use_bias=True, generator=None,
                 device=None):
        super().__init__(generator, device)
        in_feats = int(input_shape[-1])
        self.use_bias = use_bias
        self._param('mult', mult_initializer or normal_init(
            mean=1 / in_feats, stddev=0.01),
            (1, *input_shape, output_features))
        if use_bias:
            self._param('bias', bias_initializer or normal_init(
                mean=1 / in_feats, stddev=0.01),
                (1, *input_shape[:-1], output_features))
        self._done()

    def forward(self, x):
        ct = torch.promote_types(x.dtype, self.mult.dtype)
        y = torch.einsum('b...i,...io->b...o', x.to(ct),
                         self.mult[0].to(ct)).to(x.dtype)
        return y + self.bias if self.use_bias else y


class LocalCrossLinearTrf(_Local):
    """
    Per-voxel feature mixing where each (in, out) connection also warps its
    input by a learned per-connection displacement field (ref
    `layers.py:1610-1708`, whose `transform` is never imported; this is the
    working equivalent). All Cin*Cout warps of a batch are one call of
    `utils.spatial.batch_transform`, so a 3-D CUDA layer launches K4 once.
    """

    def __init__(self, input_shape, output_features, mult_initializer=None,
                 bias_initializer=None, use_bias=True, trf_mult=1,
                 interp_method='linear', generator=None, device=None):
        super().__init__(generator, device)
        vol_shape, in_feats = tuple(input_shape[:-1]), int(input_shape[-1])
        self.use_bias, self.trf_mult = use_bias, trf_mult
        self.interp_method = interp_method
        self._param('mult', mult_initializer or normal_init(
            mean=1 / in_feats, stddev=0.01),
            (*vol_shape, in_feats, output_features))
        self._param('trf', normal_init(stddev=0.001),
                    (*vol_shape, in_feats, output_features, len(vol_shape)))
        if use_bias:
            self._param('bias', bias_initializer or normal_init(
                mean=1 / in_feats, stddev=0.01),
                (*vol_shape, output_features))
        self._done()

    def forward(self, x):
        b, *vol, cin = x.shape
        cout = self.mult.shape[-1]
        # input i warped by trf[..., i, j, :] for every (i, j), every item
        shift = (self.trf * self.trf_mult).movedim((-3, -2), (0, 1))
        shift = shift[None].expand(b, cin, cout, *vol, len(vol))
        vols = x.movedim(-1, 1)[:, :, None].expand(b, cin, cout, *vol)
        warped = spatial.batch_transform(
            vols.reshape(b * cin * cout, *vol),
            shift.reshape(b * cin * cout, *vol, len(vol)),
            interp_method=self.interp_method).reshape(b, cin, cout, *vol)
        w = self.mult.movedim((-2, -1), (0, 1))            # [Cin, Cout, *vol]
        y = (warped * w).sum(1).movedim(1, -1)             # [B, *vol, Cout]
        if self.use_bias:
            # the reference adds the bias once per input feature
            # (layers.py:1703-1704), so Cin times
            y = y + self.bias * cin
        return y


def _extract_patches(x, kernel_size, strides, padding):
    """[B, *spatial, C] -> ([B, *out, K, C], out_shape), K = prod(k),
    kernel-position-major, channel-minor (the keras LC weight layout)."""
    nd = len(kernel_size)
    if padding == 'same':
        x = lc_tap._pad_spatial(x, kernel_size)
    out_shape = [(x.shape[1 + d] - kernel_size[d]) // strides[d] + 1
                 for d in range(nd)]
    slabs = []
    for offs in itertools.product(*[range(k) for k in kernel_size]):
        sl = tuple(slice(offs[d], offs[d] + (out_shape[d] - 1) * strides[d]
                         + 1, strides[d]) for d in range(nd))
        slabs.append(x[(slice(None), *sl, slice(None))])
    return torch.stack(slabs, -2), out_shape


def _lc_out_shape(spatial_shape, kernel_size, strides, padding):
    """Output spatial shape of a locally-connected conv."""
    if padding == 'same':
        spatial_shape = [s + k - 1 for s, k in zip(spatial_shape, kernel_size)]
    return [(spatial_shape[d] - kernel_size[d]) // strides[d] + 1
            for d in range(len(kernel_size))]


def _lc_per_tap(x, kernel, kernel_size, strides, padding):
    """
    Locally-connected conv with keras weights [V, prod(k)*C, O] as a sum of
    per-tap multiply-reduces: y[b, v, o] = sum_tap sum_c shift_tap(x)[b, v,
    c] * k[v, tap*C + c, o], each product in x's dtype, the sums in float32.
    Returns ([B, V, O] float32, out_shape).
    """
    nd = len(kernel_size)
    in_ch = x.shape[-1]
    if padding == 'same':
        x = lc_tap._pad_spatial(x, kernel_size)
    out_shape = [(x.shape[1 + d] - kernel_size[d]) // strides[d] + 1
                 for d in range(nd)]
    nb_out = math.prod(out_shape)
    y = None
    for tap, offs in enumerate(
            itertools.product(*[range(k) for k in kernel_size])):
        sl = tuple(slice(offs[d], offs[d] + (out_shape[d] - 1) * strides[d]
                         + 1, strides[d]) for d in range(nd))
        xs = x[(slice(None), *sl, slice(None))]
        xs = xs.reshape(xs.shape[0], nb_out, in_ch, 1)
        kt = kernel[:, tap * in_ch:(tap + 1) * in_ch, :][None]
        term = (xs * kt).float().sum(-2)
        y = term if y is None else y + term
    return y, out_shape


class LocallyConnected(_Local):
    """
    N-D locally-connected (unshared-weight) convolution (ref
    LocallyConnected3D `layers.py:811-1532`).

    `kernel_layout` picks the weight storage: 'keras' = [V, prod(k)*Cin,
    filters] (the reference layout); 'transposed' = [filters, prod(k)*Cin,
    V]; 'auto' picks 'transposed' for one filter, Cin <= 64 and stride 1.
    The kernel is drawn by `kernel_initializer` (default flax's
    `lecun_normal`, whose fan_in is prod(shape[:-1]): prod(k)*Cin*V in the
    keras layout and prod(k)*Cin*filters in the transposed one, as flax
    draws them) in `param_dtype`; the bias, [*out, filters], by
    `bias_initializer` (zeros). `dtype` is the compute type (default x's):
    x and the kernel are cast to it, the result back to x's dtype, then the
    bias is added. `implementation` is accepted for API parity and ignored.

    `impl` is 'auto' (a 3-D transposed layer on a CUDA tensor runs the
    kernels) or 'plain' (the plain PyTorch forms on every device: the twin
    that holds the kernels against their plain versions).
    """

    rank = 3

    def __init__(self, filters, kernel_size, input_shape, rank=None,
                 strides=1, padding='valid', activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 implementation=2, kernel_layout='auto',
                 param_dtype=torch.float32, dtype=None, impl='auto',
                 generator=None, device=None):
        super().__init__(generator, device)
        del implementation
        self.rank = int(rank or self.rank)
        nd = self.rank
        if len(input_shape) != nd + 1:
            raise ValueError(f'input_shape must be (*spatial, C) with {nd} '
                             f'spatial dims, got {tuple(input_shape)}')
        self.input_shape = tuple(int(s) for s in input_shape)
        self.filters = int(filters)
        self.kernel_size = _tuple(kernel_size, nd)
        self.strides = _tuple(strides, nd)
        self.padding = padding.lower()
        if self.padding not in ('valid', 'same'):
            raise ValueError(f'bad padding {padding}')
        if kernel_layout not in ('auto', 'transposed', 'keras'):
            raise ValueError(f'bad kernel_layout {kernel_layout}')
        if impl not in ('auto', 'plain'):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        self.impl = impl
        self.activation = get_activation(activation)
        self.use_bias = use_bias
        self.dtype = dtype
        in_ch = self.input_shape[-1]
        unit = all(s == 1 for s in self.strides)
        if kernel_layout == 'auto':
            self.transposed = self.filters == 1 and in_ch <= 64 and unit
        else:
            self.transposed = kernel_layout == 'transposed'
            if self.transposed and not unit:
                raise ValueError(
                    "kernel_layout='transposed' supports stride 1 only")
        self.out_shape = _lc_out_shape(self.input_shape[:-1],
                                       self.kernel_size, self.strides,
                                       self.padding)
        nb_out = math.prod(self.out_shape)
        feature_dim = math.prod(self.kernel_size) * in_ch
        kshape = ((self.filters, feature_dim, nb_out) if self.transposed
                  else (nb_out, feature_dim, self.filters))
        self._param('kernel', kernel_initializer or lecun_normal(), kshape,
                    param_dtype)
        if use_bias:
            self._param('bias', bias_initializer or zeros_init(),
                        (*self.out_shape, self.filters), param_dtype)
        self._done()

    def forward(self, x):
        nd = self.rank
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(f'expected input [B, *{self.input_shape}], got '
                             f'{tuple(x.shape)}')
        ks, st, padding = self.kernel_size, self.strides, self.padding
        in_ch = x.shape[-1]
        nb_out = math.prod(self.out_shape)
        feature_dim = math.prod(ks) * in_ch
        ct = self.dtype or x.dtype
        kernel = self.kernel if self.kernel.dtype == ct else self.kernel.to(ct)
        if self.transposed:
            if nd == 3 and x.is_cuda and self.impl == 'auto':
                y = lc_cuda.lc_transposed_pallas(x.to(ct), kernel, ks,
                                                 padding=padding)
            else:
                y = lc_tap.lc_transposed(x.to(ct), kernel, ks, padding)
            y = y.to(x.dtype)
            out_shape = self.out_shape
        elif (in_ch * self.filters <= 64
              and nb_out * feature_dim * 4 > 2 ** 30):
            # small per-voxel matrices at a huge V: the [V, k^N*Cin] patch
            # tensor would pass 1 GB; the per-tap form never builds it
            y, out_shape = _lc_per_tap(x.to(ct), kernel, ks, st, padding)
            y = y.to(x.dtype)
        else:
            patches, out_shape = _extract_patches(x, ks, st, padding)
            p = patches.to(ct).reshape(patches.shape[0], nb_out, feature_dim)
            # one batched local matmul, [B,V,I] x [V,I,O] -> [B,V,O], with
            # float32 products and sums (preferred_element_type=f32)
            y = torch.einsum('bvi,vio->bvo', p.float(),
                             kernel.float()).to(x.dtype)
        y = y.reshape(y.shape[0], *out_shape, self.filters)
        if self.use_bias:
            y = y + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y


class LocallyConnected1D(LocallyConnected):
    rank = 1


class LocallyConnected2D(LocallyConnected):
    rank = 2


class LocallyConnected3D(LocallyConnected):
    rank = 3
