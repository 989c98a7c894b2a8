"""
The soft-MI histograms by the hand-written CUDA kernel K10 of
`csrc/mi_hist.cu`: the forward of `mi_hist.MIHistograms` for CUDA tensors.

Counterpart of the Pallas kernel `_mi_histograms_p`
(`neurite_tpu/ops/mi_hist.py:90`). Its backward is plain torch
(`mi_hist.MIHistograms.backward`), as the JAX VJP is jnp: the TPU has no
backward kernel to port. K10 cuts the bins into chunks of 64 and runs one
block per pair of chunks (`csrc/mi_hist.cu`): the grid's third axis bounds
it at MAX_BINS = 16320. Its scratch of per-block partial sums is kept to
SCRATCH_ENTRIES floats by running fewer, longer blocks as the bins grow,
or to one block's sums per batch row (the size of pxy) past that, so
memory, not the kernel, sets the number of bins a card takes: pxy alone is
bs * B^2 floats, 1.07 GB a batch row at 16320 bins.
"""

import math

import numpy as np
import torch

from neurite_tpu_torch.ops import _build

CHUNK = 64          # bins per chunk (kChunk of mi_hist.cu)
# the pairs of chunks are the grid's third axis, at most 65535 long
MAX_BINS = CHUNK * math.isqrt(65535)
TILE = 64           # voxels per tile (kTile of mi_hist.cu)
MAX_BLOCKS = 1024   # first-pass blocks per batch row
SCRATCH_ENTRIES = 1 << 24   # floats of partial sums (64 MiB), over all rows


def _launch_blocks(n_vox, nb_bins, bs):
    """Blocks per batch row of K10's first pass: one per tile of 64 voxels,
    at most MAX_BLOCKS and at most as many as keep the scratch
    [bs, nblk, B*B + 2B] within SCRATCH_ENTRIES, and at least one (then
    each walks several tiles)."""
    per_block = max(1, bs) * nb_bins * (nb_bins + 2)
    return max(1, min(MAX_BLOCKS, -(-n_vox // TILE),
                      SCRATCH_ENTRIES // per_block))


def mi_histograms_cuda(x, y, bin_centers_x, bin_centers_y, alpha,
                       min_clip=-np.inf, max_clip=np.inf):
    """K10: (pxy [bs, B, B], px [bs, B], py [bs, B]) of x, y [bs, V] with
    centers [B] (float32, contiguous, CUDA, one device); min_clip and
    max_clip are floats; alpha is a float, passed by value, or a one-element
    tensor: on the card the kernel reads it there, so the host never
    waits for it."""
    ts = (x, y, bin_centers_x, bin_centers_y)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError('x, y and the bin centers must be CUDA tensors on '
                         'one device')
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError('the MI histogram kernel takes float32, got '
                         f'{[str(t.dtype) for t in ts]}')
    if not all(t.is_contiguous() for t in ts):
        raise ValueError('x, y and the bin centers must be contiguous')
    if x.ndim != 2 or y.shape != x.shape or bin_centers_x.ndim != 1 \
            or bin_centers_y.shape != bin_centers_x.shape:
        raise ValueError(f'the MI histogram kernel takes x, y [bs, V] and '
                         f'centers [B], got {tuple(x.shape)}, '
                         f'{tuple(y.shape)}, {tuple(bin_centers_x.shape)} '
                         f'and {tuple(bin_centers_y.shape)}')
    bs, n_vox = x.shape
    nb_bins = bin_centers_x.shape[0]
    if not 1 <= nb_bins <= MAX_BINS:
        raise ValueError(f'the MI histogram kernel takes 1 to {MAX_BINS} '
                         f'bins, got {nb_bins}')
    if bs > 65535:
        raise ValueError(f'the MI histogram kernel takes bs <= 65535, got '
                         f'{bs}')
    alpha_ptr = None
    if torch.is_tensor(alpha) and alpha.is_cuda:
        if alpha.numel() != 1:
            raise ValueError(f'alpha must be one number, got a tensor of '
                             f'shape {tuple(alpha.shape)}')
        alpha = alpha.to(device=x.device, dtype=torch.float32).contiguous()
        alpha_ptr, alpha_val = alpha.data_ptr(), 0.
    else:
        alpha_val = float(alpha)
    nblk = _launch_blocks(n_vox, nb_bins, bs)
    partial = torch.empty((bs, nblk, nb_bins * (nb_bins + 2)),
                          dtype=torch.float32, device=x.device)
    pxy = torch.empty((bs, nb_bins, nb_bins), dtype=torch.float32,
                      device=x.device)
    px = torch.empty((bs, nb_bins), dtype=torch.float32, device=x.device)
    py = torch.empty((bs, nb_bins), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        lib.call('neurite_mi_hist_f32', x.data_ptr(), y.data_ptr(),
                 bin_centers_x.data_ptr(), bin_centers_y.data_ptr(),
                 partial.data_ptr(), pxy.data_ptr(), px.data_ptr(),
                 py.data_ptr(), bs, n_vox, nb_bins, nblk, alpha_val,
                 alpha_ptr, float(min_clip), float(max_clip),
                 _build.stream_of(x))
    _build.launches['mi_hist'] += 1
    return pxy, px, py
