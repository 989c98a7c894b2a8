"""
Separable 3-D SAME blur (counterpart of `neurite_tpu/ops/blur.py`).

Zero-padded cross-correlation of x [N, D, H, W] with one odd-width 1-D tap
vector per axis (width 1 scales by its tap), the function behind every
Gaussian blur of the synthesis path. The JAX package computes it three ways
on the TPU (banded matmuls, per-axis convs, and the opt-in fused Pallas
kernel); the port has one: for a CUDA tensor the hand-written kernel K6
(`blur_cuda`, three launches, one per axis) with no cap on the widths; for
a CPU tensor the plain per-axis convs (`core.conv_axis`).

Gradients (`SeparableBlur3d`): dx is K6 with the taps flipped, as on the
TPU (`blur.py:180-184`); the tap gradients are plain torch (`:186-208`).
"""

import torch

from neurite_tpu_torch.utils import core


def _plain(x, kernels):
    """The plain version: per-axis SAME convs in (D, H, W) order; a None
    entry skips its axis."""
    for ax, k in enumerate(kernels):
        if k is not None:
            x = core.conv_axis(x, k, ax)
    return x


def _kernel(x, kernels):
    from neurite_tpu_torch.ops import blur_cuda
    for ax, k in enumerate(kernels):
        if k is not None:
            x = blur_cuda.blur_axis(x, k, ax + 1)
    return x


class SeparableBlur3d(torch.autograd.Function):
    """K6 forward; dx by K6 with flipped taps; tap gradients in plain torch:
    dk_a[t] = sum(g * (x blurred along the other axes, shifted by t - r))."""

    @staticmethod
    def forward(ctx, x, kz, ky, kx):
        ctx.save_for_backward(x, kz, ky, kx)
        return _kernel(x, (kz, ky, kx))

    @staticmethod
    def backward(ctx, g):
        x, *ks = ctx.saved_tensors
        ks = [None if k is None or k.numel() == 0 else k for k in ks]
        g = g.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _kernel(g, [None if k is None else k.flip(0).contiguous()
                             for k in ks])
        dks = []
        for a, k in enumerate(ks):
            if k is None or not ctx.needs_input_grad[1 + a]:
                dks.append(None)
                continue
            others = [None if b == a else kb for b, kb in enumerate(ks)]
            u = _plain(x, others)
            r = k.numel() // 2
            pad = [0] * 6
            pad[2 * (2 - a)] = pad[2 * (2 - a) + 1] = r
            up = torch.nn.functional.pad(u, pad)
            n = x.shape[1 + a]
            dks.append(torch.stack([(g * up.narrow(1 + a, t, n)).sum()
                                    for t in range(k.numel())]))
        return (dx, *dks)


def blur3d(x, kernels):
    """
    Separable SAME blur of x [N, D, H, W] with `kernels`, three entries in
    (D, H, W) order, each a 1-D tap tensor on x's device or None (the axis
    is left as it is). A CUDA tensor runs K6 (float32) and raises on what K6
    does not take; a CPU tensor runs the plain version.
    """
    if len(kernels) != 3:
        raise ValueError(f'one kernel (or None) per axis, got {len(kernels)}')
    if not x.is_cuda:
        return _plain(x, kernels)
    return SeparableBlur3d.apply(x, *[None if k is None else k.contiguous()
                                      for k in kernels])


def separable_blur3d(x, kernels, impl='auto', interpret=False):
    """
    Separable SAME blur of x [N, D, H, W] with three 1-D tap vectors (odd
    widths; width 1 scales by its tap).

    A CUDA tensor runs K6 and a CPU tensor the plain version. `impl` ('auto'
    or the JAX package's 'pallas' and 'jnp') and `interpret` pick among the
    JAX package's TPU forms and have no effect here.
    """
    del interpret
    impls = ('auto', 'pallas', 'jnp')
    if impl not in impls:
        raise ValueError(f'impl must be one of {impls}, got {impl!r}')
    if len(kernels) != 3:
        raise ValueError(f'three kernels expected, got {len(kernels)}')
    ks = [torch.as_tensor(k, device=x.device).to(x.dtype).reshape(-1)
          for k in kernels]
    if any(k.numel() % 2 == 0 for k in ks):
        raise ValueError(f'tap widths must be odd, got '
                         f'{[k.numel() for k in ks]}')
    return blur3d(x.contiguous() if x.is_cuda else x, ks)
