"""
The soft-MI histograms by the hand-written CUDA kernel K10 of
`csrc/mi_hist.cu`: the forward of `mi_hist.MIHistograms` for CUDA tensors.

Counterpart of the Pallas kernel `_mi_histograms_p`
(`neurite_tpu/ops/mi_hist.py:90`). Its backward is plain torch
(`mi_hist.MIHistograms.backward`), as the JAX VJP is jnp: the TPU has no
backward kernel to port.
"""

import numpy as np
import torch

from neurite_tpu_torch.ops import _build

MAX_BINS = 64
TILE = 64           # voxels per tile (kTile of mi_hist.cu)
MAX_BLOCKS = 1024   # first-pass blocks per batch row


def _launch_blocks(n_vox):
    """Blocks per batch row of K10's first pass: one per tile of 64 voxels,
    at most MAX_BLOCKS (then each walks several tiles)."""
    return max(1, min(MAX_BLOCKS, -(-n_vox // TILE)))


def mi_histograms_cuda(x, y, bin_centers_x, bin_centers_y, alpha,
                       min_clip=-np.inf, max_clip=np.inf):
    """K10: (pxy [bs, B, B], px [bs, B], py [bs, B]) of x, y [bs, V] with
    centers [B] (float32, contiguous, CUDA, one device); alpha, min_clip
    and max_clip are floats (a tensor alpha is read back to the host)."""
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
    nblk = _launch_blocks(n_vox)
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
                 py.data_ptr(), bs, n_vox, nb_bins, nblk, float(alpha),
                 float(min_clip), float(max_clip), _build.stream_of(x))
    _build.launches['mi_hist'] += 1
    return pxy, px, py
