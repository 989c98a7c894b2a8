"""
Locally-connected 3-D conv by the hand-written CUDA kernels of
`csrc/lc.cu`: K7 (forward), K8 (kernel cotangent, dk) and K9 (input
cotangent, dx). Counterpart of `neurite_tpu/ops/pallas_lc2.py` (v2,
transposed weights [O, prod(k)*C, V]) and `neurite_tpu/ops/pallas_lc.py`
(v1, keras weights [V, prod(k)*C] with one filter): the kernels read the
weights through the element strides of their [O, TC, V] view, so the same
three kernels serve both layouts.

Each op takes its plain version (`ops/lc_tap.py`) for a CPU tensor and
launches its kernel for a CUDA tensor, raising on what the kernel does not
take. Every launch adds one to `_build.launches['lc_fwd' | 'lc_dk' |
'lc_dx']`; a launch that takes its kernel's row body (`fwd_body`,
`dk_body`, `dx_body`: the transposed layout at the config #3 head) also
adds one to `_build.launches['lc_fwd_row' | 'lc_dk_row' | 'lc_dx_row']`,
and one by its keras row body (the keras layout at the head's shapes: the
v1 path, `lc3d_pallas`) to `_build.launches['lc_fwd_keras_row' |
'lc_dk_keras_row' | 'lc_dx_keras_row']`. The domain (`supported`) is 3-D,
stride 1, 'same' or 'valid', any filters and channels, float32 or
bfloat16: the TPU gates of `pallas_lc2.supported` (H % 8, the 512-term
unroll cap, VMEM) have no counterpart on the card. `interpret` is
accepted for the JAX names and has no effect.
"""

import ctypes
import math

import torch

from neurite_tpu_torch.ops import _build, lc_tap

_DTYPES = (torch.float32, torch.bfloat16)


def supported(x_shape, kernel_size, filters, strides, padding):
    """True when the CUDA kernels take a layer of input shape x_shape
    [B, D, H, W, C] (3-D, stride 1, 'same' or 'valid', a non-empty output,
    fewer than 2^31 voxels, a batch of at most 65535: the batch item is a
    grid axis)."""
    if len(x_shape) != 5 or len(kernel_size) != 3 or filters < 1:
        return False
    if padding not in ('same', 'valid') or any(s != 1 for s in strides):
        return False
    out = lc_tap._out_shape(x_shape[1:4], kernel_size, padding)
    return (x_shape[-1] >= 1 and all(o >= 1 for o in out)
            and math.prod(x_shape[1:4]) < 2 ** 31 and x_shape[0] <= 65535)


def _weight_view(kernel, keras):
    """The weights as their [O, TC, V] view (no copy): the transposed
    layout as it is, the keras layout [V, TC, O] (or [V, TC] for one
    filter) permuted."""
    if not keras:
        return kernel
    k3 = kernel if kernel.ndim == 3 else kernel[..., None]
    return k3.permute(2, 1, 0)


def _check(x, kview, kernel_size, padding):
    if x.ndim != 5 or kview.ndim != 3:
        raise ValueError(f'the LC kernels take x [B, D, H, W, C] and weights '
                         f'[O, TC, V], got {tuple(x.shape)} and '
                         f'{tuple(kview.shape)}')
    if not supported(tuple(x.shape), kernel_size, kview.shape[0], (1, 1, 1),
                     padding):
        raise ValueError(f'the LC kernels do not take x {tuple(x.shape)} with '
                         f'kernel_size {kernel_size} and padding {padding!r}')
    out = lc_tap._out_shape(x.shape[1:4], kernel_size, padding)
    want = (kview.shape[0], math.prod(kernel_size) * x.shape[-1],
            math.prod(out))
    if tuple(kview.shape) != want:
        raise ValueError(f'weights {tuple(kview.shape)} do not fit x '
                         f'{tuple(x.shape)}: expected {want}')
    if x.dtype not in _DTYPES or kview.dtype not in _DTYPES:
        raise ValueError(f'the LC kernels take float32 or bfloat16, got x '
                         f'{x.dtype} and weights {kview.dtype}')


def _launch_args(x_shape, kview, kernel_size, padding, x_dtype):
    """The kernels' Geo fields (csrc/lc.cu) and dtype flags."""
    out = lc_tap._out_shape(x_shape[1:4], kernel_size, padding)
    lows = ([lo for lo, _ in lc_tap._pads(kernel_size)] if padding == 'same'
            else [0, 0, 0])
    geo = (ctypes.c_int64 * 18)(*x_shape, *out, kview.shape[0], *kernel_size,
                                *lows, *kview.stride())
    return geo, int(x_dtype == torch.bfloat16), int(
        kview.dtype == torch.bfloat16)


def _on_cuda(*ts):
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError('the LC kernels take CUDA tensors on one device')


def fwd_cuda(x, kview, kernel_size, padding):
    """K7: x [B, D, H, W, C] (contiguous) and the weights' [O, TC, V] view
    (any strides) -> y [B, Do, Ho, Wo, O] float32."""
    _on_cuda(x, kview)
    _check(x, kview, kernel_size, padding)
    if not x.is_contiguous():
        raise ValueError('x must be contiguous')
    out = lc_tap._out_shape(x.shape[1:4], kernel_size, padding)
    y = torch.empty((x.shape[0], *out, kview.shape[0]), dtype=torch.float32,
                    device=x.device)
    _fwd_launch(x, kview, y, kernel_size, padding,
                fwd_body(x, kview, kernel_size, padding))
    return y


_BODY = {'voxel': 0, 'row': 1, 'keras_row': 2}   # the launchers' body codes


def _fwd_launch(x, kview, y, kernel_size, padding, body):
    """Launch K7's `body` on checked tensors, writing y; `body` must hold
    `fwd_body`'s conditions for them."""
    geo, xb, kb = _launch_args(tuple(x.shape), kview, kernel_size, padding,
                               x.dtype)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call('neurite_lc_fwd', x.data_ptr(), kview.data_ptr(),
                 y.data_ptr(), geo, xb, kb, _BODY[body], _build.stream_of(x))
    _count('lc_fwd', body)


def _count(name, body):
    """One launch of kernel `name` by `body` ('voxel', 'row' or
    'keras_row')."""
    _build.launches[name] += 1
    if body != 'voxel':
        _build.launches[f'{name}_{body}'] += 1


def _rows_of_16_bytes(x_shape, view, kernel_size, wo):
    """Batch 1, 4 channels, a kernel at most 3 wide along W, and 16 bytes of
    weights (8 bfloat16 or 4 float32 voxels) a thread within one row of
    length wo of the transposed layout: unit voxel stride, rows and base
    16-byte aligned."""
    nv = 16 // view.element_size()
    s_o, s_t, s_v = view.stride()
    return (x_shape[0] == 1 and x_shape[-1] == 4 and kernel_size[2] <= 3
            and wo % nv == 0 and s_v == 1 and s_t % nv == 0
            and s_o % nv == 0 and view.data_ptr() % 16 == 0)


def _row(x, view, kernel_size, padding):
    """K8's and K7's row conditions: 16 bytes of voxels (8 bfloat16 or 4
    float32) a thread within one output row, each (tap, channel, filter)
    row of them one aligned 16-byte access: batch 1, 4 channels, a kernel
    at most 3 wide along W, Wo a multiple of those voxels, the transposed
    layout (unit voxel stride, rows and base 16-byte aligned) and x
    aligned to its 4-channel voxels."""
    wo = lc_tap._out_shape(x.shape[1:4], kernel_size, padding)[2]
    return (_rows_of_16_bytes(tuple(x.shape), view, kernel_size, wo)
            and x.data_ptr() % (4 * x.element_size()) == 0)


KERAS_TILE_BYTES = 48 * 1024   # shared memory of a 'keras_row' block
KERAS_TILE_VOXELS = 32         # the fewest voxels a 'keras_row' block owns


def _keras_head(x_shape, view, kernel_size):
    """The keras row bodies' layout and shape: the weights' [O, TC, V] view
    is the keras layout [V, TC, O] contiguous with its base 16-byte
    aligned, at the config #3 head's batch 1, 4 channels, 1 filter and a
    kernel at most 3 wide along H and W."""
    o = view.shape[0]
    return (view.permute(2, 1, 0).is_contiguous()
            and view.data_ptr() % 16 == 0
            and x_shape[0] == 1 and x_shape[-1] == 4 and o == 1
            and max(kernel_size[1:]) <= 3)


def _keras_row(x, view, kernel_size):
    """K8's and K7's keras row conditions: `_keras_head`, x aligned to its
    4-channel voxels, and a [32, TC] tile of the voxels' weight runs fits
    the block's 48 KB of shared memory."""
    tc = view.shape[1]
    return (_keras_head(tuple(x.shape), view, kernel_size)
            and x.data_ptr() % (4 * x.element_size()) == 0
            and KERAS_TILE_VOXELS * tc * view.element_size()
            <= KERAS_TILE_BYTES)


def _keras_dx_row(x_shape, view, kernel_size, padding):
    """K9's keras row conditions: `_keras_head` with 'same' padding, and a
    z-plane's weights H * W * TC within 32-bit offsets."""
    return (padding == 'same'
            and _keras_head(tuple(x_shape), view, kernel_size)
            and x_shape[2] * x_shape[3] * view.shape[1] < 2 ** 31)


def dk_body(x, view, kernel_size, padding):
    """The K8 body (`csrc/lc.cu`) that writes dk's [O, TC, V] view `view`
    from x [B, D, H, W, C]: 'row' on `_row`'s conditions (the config #3
    head); 'keras_row' where dk is the keras layout [V, TC, O], one
    contiguous run, at the head's shapes (`_keras_row`), which a block
    stages in shared memory and streams out in 16-byte chunks; else
    'voxel', one voxel a thread (any layout and shape). At the head the
    row body runs 0.33 ms against the one-voxel body's 1.35, and in the
    keras layout the keras row body 0.3290 ms against the one-voxel
    body's 8.3317 (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py` phase
    10)."""
    if _row(x, view, kernel_size, padding):
        return 'row'
    return 'keras_row' if _keras_row(x, view, kernel_size) else 'voxel'


def fwd_body(x, view, kernel_size, padding):
    """The K7 body (`csrc/lc.cu`) that reads the weights' [O, TC, V] view
    `view` for x [B, D, H, W, C]: 'row' on K8's row conditions (`_row`),
    where each (tap, channel, filter) row of a thread's voxels is one
    aligned 16-byte load and its taps' input voxels are loaded once per
    (tz, ty); 'keras_row' on K8's keras row conditions (`_keras_row`),
    where a block stages its voxels' contiguous [VB, TC] weight run in
    shared memory by 16-byte loads and each thread sums its voxel from
    there; else 'voxel', one voxel a thread and a 2-byte load a weight.
    Each reads the weights whose taps reach the volume once (873.7 MB at
    the config #3 head, bf16), where the row body runs 0.31 ms and the
    one-voxel body 0.79, and in the keras layout the keras row body 0.32
    and the one-voxel body 2.01 (NVIDIA H100 80GB HBM3, 700 W;
    `chip_smoke.py` phase 10)."""
    if _row(x, view, kernel_size, padding):
        return 'row'
    return 'keras_row' if _keras_row(x, view, kernel_size) else 'voxel'


def dx_body(x_shape, view, kernel_size, padding):
    """The K9 body (`csrc/lc.cu`) that writes dx [*x_shape] from the
    weights' [O, TC, V] view `view`: 'row' on K8's row conditions with
    'same' padding (W = Wo), where a thread owns the input voxels of 16
    bytes of weights (8 bfloat16 or 4 float32) in one row and reads each
    (tap, channel, filter) row with one aligned 16-byte load, the one
    element beyond it for the taps off the centre along W coming from the
    neighbouring lane; 'keras_row' on `_keras_dx_row`'s conditions, where
    a block owns a 16 x 8 tile of input voxels of one z-plane and, per tz,
    stages the ky * kx tap quads of that tz (one contiguous part of each
    keras run) of every output row the tile's taps reach, and g there, in
    shared memory; else 'voxel', one voxel a thread and a 2-byte load a
    weight.
    Each reads the weights whose taps reach the volume once (873.7 MB at
    the config #3 head, bf16), where the row body runs 0.36 ms and the
    one-voxel body 0.85, and in the keras layout the keras row body 0.42
    and the one-voxel body 0.95 (NVIDIA H100 80GB HBM3, 700 W;
    `chip_smoke.py` phase 10)."""
    row = padding == 'same' and _rows_of_16_bytes(
        tuple(x_shape), view, kernel_size, x_shape[3])
    if row:
        return 'row'
    return ('keras_row' if _keras_dx_row(x_shape, view, kernel_size, padding)
            else 'voxel')


def dk_cuda(g, x, kernel_size, padding, dtype, keras=False):
    """K8: g [B, Do, Ho, Wo, O] float32 and x [B, D, H, W, C] (both
    contiguous) -> dk in `dtype`, [O, TC, V] (or [V, TC, O] if keras), the
    batch summed in float32 and cast once, by the body `dk_body` picks."""
    _on_cuda(g, x)
    if g.dtype != torch.float32 or not (g.is_contiguous()
                                        and x.is_contiguous()):
        raise ValueError('g must be float32 and g and x contiguous')
    out = lc_tap._out_shape(x.shape[1:4], kernel_size, padding)
    if tuple(g.shape[:4]) != (x.shape[0], *out) or g.ndim != 5:
        raise ValueError(f'g {tuple(g.shape)} does not fit x '
                         f'{tuple(x.shape)}')
    # dk in the weights' own layout, and its [O, TC, V] view
    shape = (g.shape[-1], math.prod(kernel_size) * x.shape[-1], math.prod(out))
    dk = torch.empty(shape[::-1] if keras else shape, dtype=dtype,
                     device=x.device)
    view = _weight_view(dk, keras)
    _check(x, view, kernel_size, padding)
    _dk_launch(g, x, view, kernel_size, padding,
               dk_body(x, view, kernel_size, padding))
    return dk


def _dk_launch(g, x, view, kernel_size, padding, body):
    """Launch K8's `body` on checked tensors, writing dk's [O, TC, V] view
    `view`; `body` must hold `dk_body`'s conditions for it."""
    geo, xb, kb = _launch_args(tuple(x.shape), view, kernel_size, padding,
                               x.dtype)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call('neurite_lc_dk', g.data_ptr(), x.data_ptr(), view.data_ptr(),
                 geo, xb, kb, _BODY[body], _build.stream_of(x))
    _count('lc_dk', body)


def dx_cuda(g, kview, kernel_size, padding, x_shape, x_dtype, round_q=False):
    """K9: g [B, Do, Ho, Wo, O] float32 (contiguous) and the weights'
    [O, TC, V] view -> dx [*x_shape] in x_dtype, summed in float32 and
    rounded once; round_q rounds each product to the weights' dtype first
    (the v1 semantics)."""
    _on_cuda(g, kview)
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError('g must be float32 and contiguous')
    dx = torch.empty(x_shape, dtype=x_dtype, device=g.device)
    _check(dx, kview, kernel_size, padding)
    out = lc_tap._out_shape(x_shape[1:4], kernel_size, padding)
    if tuple(g.shape) != (x_shape[0], *out, kview.shape[0]):
        raise ValueError(f'g {tuple(g.shape)} does not fit x {x_shape}')
    _dx_launch(g, kview, dx, kernel_size, padding, round_q,
               dx_body(tuple(x_shape), kview, kernel_size, padding))
    return dx


def _dx_launch(g, kview, dx, kernel_size, padding, round_q, body):
    """Launch K9's `body` on checked tensors, writing dx; `body` must hold
    `dx_body`'s conditions for them."""
    geo, xb, kb = _launch_args(tuple(dx.shape), kview, kernel_size, padding,
                               dx.dtype)
    lib = _build.library()
    with torch.cuda.device(g.device):
        lib.call('neurite_lc_dx', g.data_ptr(), kview.data_ptr(),
                 dx.data_ptr(), geo, xb, kb, int(bool(round_q)), _BODY[body],
                 _build.stream_of(g))
    _count('lc_dx', body)


# the plain versions, with the kernels' signatures

def fwd_plain(x, kview, kernel_size, padding):
    return lc_tap._lc_transposed_impl(x, kview, kernel_size, padding)


def dk_plain(g, x, kernel_size, padding, dtype, keras=False):
    dk = lc_tap.lc_transposed_dk(g, x, kernel_size, padding).to(dtype)
    return dk.permute(2, 1, 0).contiguous() if keras else dk


def dx_plain(g, kview, kernel_size, padding, x_shape, x_dtype, round_q=False):
    return lc_tap.lc_transposed_dx(g, kview, kernel_size, padding, x_shape,
                                   round_q).to(x_dtype)


class LCTransposed(torch.autograd.Function):
    """
    Locally-connected 3-D conv: forward K7, backward K8 (dk in the weights'
    dtype and layout) and K9 (dx in x's dtype) for CUDA tensors; the plain
    versions for CPU tensors. `keras` reads the weights in the keras layout
    and rounds K9's products to their dtype, as the v1 kernels do.
    """

    @staticmethod
    def forward(ctx, x, kernel, kernel_size, padding, keras):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.kernel_size, ctx.padding, ctx.keras = kernel_size, padding, keras
        fwd = fwd_cuda if x.is_cuda else fwd_plain
        return fwd(x, _weight_view(kernel, keras), kernel_size, padding)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        ks, padding, keras = ctx.kernel_size, ctx.padding, ctx.keras
        g = g.float().contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            fn = dx_cuda if g.is_cuda else dx_plain
            dx = fn(g, _weight_view(kernel, keras), ks, padding,
                    tuple(x.shape), x.dtype, keras)
        if ctx.needs_input_grad[1]:
            fn = dk_cuda if g.is_cuda else dk_plain
            dk = fn(g, x, ks, padding, kernel.dtype, keras).reshape(
                kernel.shape)
        return dx, dk, None, None, None


def lc_transposed_pallas(x, kernel, kernel_size, interpret=False,
                         padding='same'):
    """
    Locally-connected 3-D conv (stride 1) with transposed weights (the
    JAX package's v2 name). x: [B, D, H, W, C]; kernel: [O, prod(k)*C, V].
    Returns [B, Do, Ho, Wo, O] float32. `padding` may also be 'valid' here.
    """
    del interpret
    return LCTransposed.apply(x, kernel, tuple(kernel_size), padding, False)


def lc3d_pallas(xf, kernel2, shape3, kernel_size, interpret=False):
    """
    Flat locally-connected 3-D conv, stride 1, SAME, one filter (the JAX
    package's v1 name). xf: [V, C] (flattened [D, H, W, C]); kernel2: [V, K]
    (K = prod(k)*C, tap-major, channel-minor: the keras layout). Returns
    [V, 1] float32. Its dx rounds each g*k product to kernel2's dtype before
    the sum (`pallas_lc.py:292`).
    """
    del interpret
    V, C = xf.shape
    x5 = xf.reshape(1, *shape3, C)
    y = LCTransposed.apply(x5, kernel2, tuple(kernel_size), 'same', True)
    return y.reshape(V, 1)
