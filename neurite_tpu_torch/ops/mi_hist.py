"""
Unnormalized soft-MI histograms: fused RBF soft-quantize + joint histogram.

Counterpart of `neurite_tpu/ops/mi_hist.py`. For x, y [bs, V] and bin
centers c (B of them), with q(v) = exp(-alpha * (clip(v) - c)^2):

    pxy = sum_v xq^T yq   [bs, B, B]
    px  = sum_v xq        [bs, B]
    py  = sum_v yq        [bs, B]

Two semantics, each on the route that has it in JAX:

- 'jnp': the plain form, differentiated by autograd; gradients reach the
  centers and alpha (JAX `_mi_histograms_jnp`, `mi_hist.py:118-128`).
- 'pallas': `MIHistograms`, the kernel route. Its backward recomputes the
  maps in plain torch and returns zero for the centers and alpha, as the
  JAX custom VJP does (`mi_hist.py:147-168`). The forward is K10
  (`mi_hist_cuda.py`, `csrc/mi_hist.cu`) for a CUDA tensor and the plain
  sums for a CPU one.
- 'plain': `MIHistograms` with the plain forward on any device: the twin K10
  is held against on the card.
- 'auto': 'pallas' for a CUDA tensor, 'jnp' for a CPU one (JAX: Pallas on
  the accelerator, jnp elsewhere).

With data-derived centers the two semantics give different gradients at the
argmin and argmax of x (ROADMAP Queue 3).
"""

import numpy as np
import torch

from neurite_tpu_torch.utils import core

_IMPLS = ('auto', 'pallas', 'plain', 'jnp')


def _mi_histograms_plain(x, y, bin_centers_x, bin_centers_y, alpha,
                         min_clip=-np.inf, max_clip=np.inf):
    """The plain form (JAX `_mi_histograms_jnp`), differentiable by
    autograd in every argument."""
    xq, yq = (core.soft_quantize(v, c, None, alpha, min_clip, max_clip)
              for v, c in ((x, bin_centers_x), (y, bin_centers_y)))
    return torch.bmm(xq.transpose(1, 2), yq), xq.sum(1), yq.sum(1)


def _quant_and_grad(v, centers, alpha, min_clip, max_clip):
    """q and dq/dv of one map (`mi_hist.py:153-159`); the inside mask
    matches the clip's VJP."""
    diff = core.clip(v, min_clip, max_clip)[..., None] - centers
    q = torch.exp(-alpha * torch.square(diff))
    inside = ((v >= min_clip) & (v <= max_clip)).to(q.dtype)
    return q, q * (-2. * alpha) * diff * inside[..., None]


class MIHistograms(torch.autograd.Function):
    """The kernel route: K10 (CUDA, `use_kernel`) or the plain sums forward;
    the backward recomputes the maps and gives the centers and alpha zero
    gradient. alpha is a float or a 0-d tensor."""

    @staticmethod
    def forward(ctx, x, y, bin_centers_x, bin_centers_y, alpha, min_clip,
                max_clip, use_kernel):
        ctx.alpha_is_tensor = torch.is_tensor(alpha)
        ctx.save_for_backward(x, y, bin_centers_x, bin_centers_y,
                              *([alpha] if ctx.alpha_is_tensor else []))
        ctx.alpha, ctx.clip = (None if ctx.alpha_is_tensor else alpha,
                               (min_clip, max_clip))
        if use_kernel and x.is_cuda:
            from neurite_tpu_torch.ops import mi_hist_cuda
            return mi_hist_cuda.mi_histograms_cuda(
                x, y, bin_centers_x, bin_centers_y, alpha, min_clip,
                max_clip)
        return _mi_histograms_plain(x, y, bin_centers_x, bin_centers_y,
                                    alpha, min_clip, max_clip)

    @staticmethod
    def backward(ctx, g_pxy, g_px, g_py):
        x, y, cx, cy, *saved_alpha = ctx.saved_tensors
        alpha = saved_alpha[0] if ctx.alpha_is_tensor else ctx.alpha
        lo, hi = ctx.clip
        need_x, need_y = ctx.needs_input_grad[:2]
        dx = dy = None
        if need_x or need_y:
            xq, dxq = _quant_and_grad(x, cx, alpha, lo, hi)
            yq, dyq = _quant_and_grad(y, cy, alpha, lo, hi)
        if need_x:   # einsum('bij,bvj->bvi', g_pxy, yq) + g_px
            tx = torch.matmul(yq, g_pxy.transpose(1, 2)) + g_px[:, None, :]
            dx = (tx * dxq).sum(-1)
        if need_y:   # einsum('bij,bvi->bvj', g_pxy, xq) + g_py
            ty = torch.matmul(xq, g_pxy) + g_py[:, None, :]
            dy = (ty * dyq).sum(-1)
        zeros = [torch.zeros_like(t) if n and torch.is_tensor(t) else None
                 for t, n in zip((cx, cy, alpha), ctx.needs_input_grad[2:5])]
        return (dx, dy, *zeros, None, None, None)


def mi_histograms(x, y, bin_centers, alpha, min_clip=-np.inf,
                  max_clip=np.inf, impl='auto', interpret=False,
                  bin_centers_y=None):
    """
    Unnormalized soft-MI histograms for batched flat volumes.

    Args:
        x, y: [bs, V] raw intensities (cast to float32).
        bin_centers: [B] (for x; also for y unless bin_centers_y); a tensor
            keeps its autograd graph, host data is copied to the device once.
        alpha: RBF sharpness 1 / (2 sigma^2), a float or a 0-d tensor (K10
            reads a CUDA tensor on the card: no host sync).
        min_clip/max_clip: intensity clip bounds (+-inf: no clip).
        impl: 'auto', 'pallas', 'plain' or 'jnp' (module docstring).
        interpret: accepted for the JAX signature; no effect.
        bin_centers_y: optional separate [B] centers for y.

    Returns:
        (pxy [bs, B, B], px [bs, B], py [bs, B]) float32 raw sums.
    """
    del interpret
    if impl not in _IMPLS:
        raise ValueError(f'impl must be one of {_IMPLS}, got {impl!r}')
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    cbx = core.as_float32(bin_centers, x.device)
    cby = cbx if bin_centers_y is None else core.as_float32(bin_centers_y,
                                                            x.device)
    if torch.is_tensor(alpha):
        alpha = alpha.to(device=x.device, dtype=torch.float32)
    else:
        alpha = float(np.float32(alpha))
    min_clip, max_clip = float(min_clip), float(max_clip)
    if impl == 'auto':
        impl = 'pallas' if x.is_cuda else 'jnp'
    if impl == 'jnp':
        return _mi_histograms_plain(x, y, cbx, cby, alpha, min_clip, max_clip)
    return MIHistograms.apply(x.contiguous(), y.contiguous(), cbx, cby, alpha,
                              min_clip, max_clip, impl == 'pallas')
