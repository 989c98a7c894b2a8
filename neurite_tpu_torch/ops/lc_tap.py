"""
Locally-connected conv (stride 1) with the transposed weight layout, in
plain PyTorch: the counterpart of `neurite_tpu/ops/lc_tap.py`.

The weight is stored [O, prod(k)*C, V]: per output filter, the keras
feature axis (tap-major, channel-minor), then the output voxels. The
forward, the input cotangent (dx) and the kernel cotangent (dk) are written
out per (tap, channel) term and sum in the JAX package's order: taps outer,
channels inner, float32 accumulation. They are the plain versions of the
CUDA kernels K7, K9 and K8 (`lc_cuda.py`, `csrc/lc.cu`), which sum in the
same order, and every layer that is not a 3-D CUDA layer runs them.

Any rank, stride 1, padding 'same' or 'valid'. The JAX module's
`NEURITE_LC_DX_FORM` and `NEURITE_LC_DX_LAYOUT` knobs steer XLA's layouts
and have no counterpart here.
"""

import itertools

import torch
import torch.nn.functional as F


def _pads(kernel_size):
    """(low, high) SAME padding per axis."""
    out = []
    for k in kernel_size:
        total = k - 1
        out.append((total // 2, total - total // 2))
    return out


def _out_shape(spatial, kernel_size, padding):
    if padding == 'same':
        return list(spatial)
    return [s - k + 1 for s, k in zip(spatial, kernel_size)]


def _taps(kernel_size):
    return list(itertools.product(*[range(k) for k in kernel_size]))


def _pad_trailing(t, pads):
    """Zero-pad the trailing len(pads) axes of t by (low, high) each."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(t, flat)


def _pad_spatial(x, kernel_size):
    """Zero SAME padding of the spatial axes of x [B, *spatial, C]."""
    return _pad_trailing(x.movedim(-1, 1), _pads(kernel_size)).movedim(1, -1)


def _lc_transposed_impl(x, kernel, kernel_size, padding):
    """x [B, *spatial, C], kernel [O, prod(k)*C, V] -> [B, *out, O] float32:
    y = term(0, 0), then y + term(t, c) for taps t, channels c in order,
    term = float(k) * float(x_tap)."""
    nd = len(kernel_size)
    C = x.shape[-1]
    O = kernel.shape[0]
    out_sp = _out_shape(x.shape[1:-1], kernel_size, padding)
    xcm = x.movedim(-1, 1)                                 # [B, C, *sp]
    if padding == 'same':
        xcm = _pad_trailing(xcm, _pads(kernel_size))
    k3 = kernel.reshape(O, kernel.shape[1], *out_sp)
    y = None
    for t, offs in enumerate(_taps(kernel_size)):
        sl = tuple(slice(offs[d], offs[d] + out_sp[d]) for d in range(nd))
        xt = xcm[(slice(None), slice(None), *sl)]          # [B, C, *out]
        for c in range(C):
            term = k3[:, t * C + c][None].float() * xt[:, c][:, None].float()
            y = term if y is None else y + term            # [B, O, *out]
    return y.movedim(1, -1)


def lc_transposed_dx(g, kernel, kernel_size, padding, x_shape,
                     round_products=False):
    """
    Input cotangent of `lc_transposed`: g [B, *out, O], kernel [O, prod(k)*C,
    V] -> dx [B, *spatial, C] float32 (callers cast).

    dx[u, c] = sum over taps t (in order) of m_t[u + p0 - offs_t], with
    m_t = sum over o (in order) of k[o, t*C+c] * g[o], zero outside the
    output. With round_products each product is first rounded to the
    kernel's dtype: the v1 kernel's q (`neurite_tpu/ops/pallas_lc.py:292`).
    """
    nd = len(kernel_size)
    C = x_shape[-1]
    O = kernel.shape[0]
    sp = list(x_shape[1:-1])
    out_sp = _out_shape(sp, kernel_size, padding)
    gcm = g.movedim(-1, 1).float()                         # [B, O, *out]
    k3 = kernel.reshape(O, kernel.shape[1], *out_sp)
    pads = _pads(kernel_size) if padding == 'same' else [(0, 0)] * nd
    # m padded so that index r + (k-1) - offs reads m[r + p0 - offs]
    padcfg = [(k - 1 - p0, s + p0 - o)
              for k, (p0, _), s, o in zip(kernel_size, pads, sp, out_sp)]
    dxs = []
    for c in range(C):
        acc = torch.zeros((g.shape[0], *sp), dtype=torch.float32,
                          device=g.device)
        for t, offs in enumerate(_taps(kernel_size)):
            kc = k3[:, t * C + c]                          # [O, *out]
            m = None
            for o in range(O):
                p = kc[o].float() * gcm[:, o]
                if round_products:
                    p = p.to(kernel.dtype).float()
                m = p if m is None else m + p              # [B, *out]
            mp = _pad_trailing(m, padcfg)
            sl = tuple(slice(kernel_size[d] - 1 - offs[d],
                             kernel_size[d] - 1 - offs[d] + sp[d])
                       for d in range(nd))
            acc = acc + mp[(slice(None), *sl)]
        dxs.append(acc)
    return torch.stack(dxs, -1)                            # [B, *sp, C]


def lc_transposed_dk(g, x, kernel_size, padding):
    """
    Kernel cotangent of `lc_transposed` in the transposed layout, float32
    (callers cast): dk[o, t*C+c, v] = sum over b (left to right) of
    g[b, v, o] * x_tap[b, v, c].
    """
    nd = len(kernel_size)
    C = x.shape[-1]
    out_sp = _out_shape(x.shape[1:-1], kernel_size, padding)
    gcm = g.movedim(-1, 1).float()                         # [B, O, *out]
    xp = x
    if padding == 'same':
        xp = _pad_spatial(x, kernel_size)
    O = gcm.shape[1]
    dk = torch.empty((O, len(_taps(kernel_size)) * C, *out_sp),
                     dtype=torch.float32, device=g.device)
    for t, offs in enumerate(_taps(kernel_size)):
        sl = tuple(slice(offs[d], offs[d] + out_sp[d]) for d in range(nd))
        for c in range(C):
            xt = xp[(slice(None), *sl, c)].float()         # [B, *out]
            r = gcm[0] * xt[0][None]
            for b in range(1, gcm.shape[0]):
                r = r + gcm[b] * xt[b][None]
            dk[:, t * C + c] = r                           # [O, *out]
    return dk.reshape(O, dk.shape[1], -1)


class LCTransposedPlain(torch.autograd.Function):
    """`_lc_transposed_impl` with the hand-written backward, as the JAX
    custom_vjp (`lc_tap.py:242-254`): dx cast to x's dtype, dk to the
    kernel's."""

    @staticmethod
    def forward(ctx, x, kernel, kernel_size, padding):
        ctx.save_for_backward(x, kernel)
        ctx.kernel_size, ctx.padding = kernel_size, padding
        return _lc_transposed_impl(x, kernel, kernel_size, padding)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        ks, padding = ctx.kernel_size, ctx.padding
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = lc_transposed_dx(g, kernel, ks, padding,
                                  tuple(x.shape)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = lc_transposed_dk(g, x, ks, padding).to(kernel.dtype)
        return dx, dk, None, None


def lc_transposed(x, kernel, kernel_size, padding):
    """
    Locally-connected conv (stride 1) with a transposed weight layout, in
    plain PyTorch on any device.

    x: [B, *spatial, C]; kernel: [O, prod(k)*C, V] (V = prod(out_spatial)).
    Returns [B, *out_spatial, O] in float32 (callers cast).
    """
    padding = padding.lower()
    if padding not in ('same', 'valid'):
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return LCTransposedPlain.apply(x, kernel, tuple(kernel_size), padding)


def keras_to_transposed(kernel):
    """[V, TC, O] keras layout -> [O, TC, V] (checkpoint migration)."""
    return kernel.permute(2, 1, 0).contiguous()


def transposed_to_keras(kernel):
    """[O, TC, V] -> [V, TC, O] keras layout."""
    return kernel.permute(2, 1, 0).contiguous()
