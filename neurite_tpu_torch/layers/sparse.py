"""
Sparse-observation layers; counterpart of `neurite_tpu/layers/sparse.py`
(reference `neurite/tf/layers.py:635-739`, SpatiallySparse_Dense).

Everything here is float32 matrix algebra that the JAX package leaves to
XLA outside any kernel: `torch.matmul` products, and the d x d inverse and
solves of `torch.linalg.inv_ex` and `solve_ex`, which keep their error
flags on the device (no host read per call) and give NaN for a singular
matrix, as jnp.linalg does. The products stay float32: TF32
(`torch.backends.cuda.matmul.allow_tf32`) is off by default, and a TF32 Gram
of 2-million-long columns is not the JAX package's float32 answer.

Citation (as in the reference): Dalca AV, Guttag J, Sabuncu MR. Anatomical
Priors in Convolutional Networks for Unsupervised Biomedical Segmentation,
CVPR 2018.
"""

import math

import torch
import torch.nn as nn

from neurite_tpu_torch import backend

__all__ = ['SpatiallySparse_Dense']

# D*d element count above which the encode switches from the one-shot
# masked-Wo form to the normal equations that never build [N, D, d], as in
# the JAX package (`layers/sparse.py:28`); module-level so tests can patch it
_ENCODE_CHUNK_ELEMS = 1 << 25


class SpatiallySparse_Dense(nn.Module):
    """
    Densely-connected layer for sparsely observed inputs, used in both
    directions with shared weights `mult_kernel` M [D, d] (D the product of
    `input_shape`, d = `output_len`) and, with use_bias, `bias_kernel` [d];
    both drawn N(0, 0.05^2) from `generator` (on its device; seed 0 on the
    CPU when none is given), then moved to `device`.

    W = inv(M^T M) @ M^T [d, D] is computed at every call, as the flax module
    does (the explicit inverse with no ridge, JAX `layers/sparse.py:73-75`).

    - encode, forward([y, mask]) -> [B, d]: the mask is repeated over the
      a_fact = C_y / C_mask channels; per sample the masked normal
      equations wotwo @ res = rhs are solved (+ bias).
      At D*d <= `_ENCODE_CHUNK_ELEMS`, the one-shot form: Wo = W^T * m,
      wotwo = Wo^T Wo, rhs = Wo^T y, which weighs the mask squared (m^2) in
      wotwo. Above it, wotwo = (A * m)^T A with A = W^T, one [d, D] @ [D, d]
      product a sample, and rhs = (m * y) @ A: the mask once (m), as the
      JAX chunked branch (which sums 2^16-row chunks) does. The two agree
      for a binary mask only, as the JAX package's two branches do.
    - decode, forward([x]) -> [B, *input_shape]: (x - bias) @ W.

    Parity: reference `layers.py:635-739`, JAX `layers/sparse.py:37-137`.
    """

    flax_same_layout = True   # `convert` copies mult_kernel, bias_kernel as is

    def __init__(self, input_shape, output_len, use_bias=False,
                 generator=None, device=None):
        super().__init__()
        self.input_shape = tuple(int(s) for s in input_shape)
        self.output_len = int(output_len)
        self.use_bias = use_bias
        gen = generator or torch.Generator().manual_seed(0)
        dim = math.prod(self.input_shape)
        device = backend.resolve_device(device)

        def normal(shape):
            return 0.05 * torch.randn(shape, generator=gen,
                                      device=gen.device).to(device)
        self.mult_kernel = nn.Parameter(normal((dim, self.output_len)))
        self.bias_kernel = (nn.Parameter(normal((self.output_len,)))
                            if use_bias else None)

    def decode_matrix(self):
        """W = inv(M^T M) @ M^T, [d, D], differentiable in M."""
        m = self.mult_kernel
        inv, _ = torch.linalg.inv_ex(m.T @ m)
        return inv @ m.T

    def forward(self, args):
        if not isinstance(args, (list, tuple)):
            args = [args]
        w = self.decode_matrix()
        if len(args) == 2:
            return self._encode(w, *args)
        x = args[0].reshape(args[0].shape[0], -1)
        if self.bias_kernel is not None:
            x = x - self.bias_kernel
        return (x @ w).reshape(-1, *self.input_shape)

    def _encode(self, w, y, y_mask):
        a_fact = y.shape[-1] // y_mask.shape[-1]
        if a_fact > 1:
            y_mask = torch.repeat_interleave(y_mask, a_fact, dim=-1)
        n = y.shape[0]
        y_flat = y.reshape(n, -1)
        m = y_mask.reshape(n, -1).to(y_flat.dtype)
        a = w.T                                              # D x d
        if a.shape[0] * a.shape[1] <= _ENCODE_CHUNK_ELEMS:
            wo = a[None] * m[..., None]                      # N x D x d
            wo_t = wo.transpose(1, 2)                        # N x d x D
            wotwo = wo_t @ wo                                # N x d x d
            rhs = (wo_t @ y_flat[..., None])[..., 0]         # N x d
        else:
            wotwo = torch.stack([(a * m[i, :, None]).T @ a for i in range(n)])
            rhs = (m * y_flat) @ a
        res = torch.linalg.solve_ex(wotwo, rhs[..., None])[0][..., 0]
        if self.bias_kernel is not None:
            res = res + self.bias_kernel[None]
        return res
