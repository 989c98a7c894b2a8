"""
The soft-MI histograms by the hand-written CUDA kernel K10 of
`csrc/mi_hist.cu`: the forward of `mi_hist.MIHistograms` for CUDA tensors.

Counterpart of the Pallas kernel `_mi_histograms_p`
(`neurite_tpu/ops/mi_hist.py:90`). Its backward is plain torch
(`mi_hist.MIHistograms.backward`), as the JAX VJP is jnp: the TPU has no
backward kernel to port. K10 cuts the bins into chunks of 64 and runs one
block per pair of chunks (`csrc/mi_hist.cu`): the grid's third axis bounds
it at MAX_BINS = 16320. In a block each thread owns a tile of 4 x 4 bin
pairs in registers, and the threads form voxel groups whose sums are added
in a fixed order at the end; `plan` gives the voxel tile, the groups and
the shared bytes, and every launch adds one to `_build.launches['mi_hist']`
and to `['mi_hist_tiled']`, the name of that body. Its scratch of per-block
partial sums is kept to SCRATCH_ENTRIES floats by running fewer, longer
blocks as the bins grow, or to one block's sums per batch row (the size of
pxy) past that, so memory, not the kernel, sets the number of bins a card
takes: pxy alone is bs * B^2 floats, 1.07 GB a batch row at 16320 bins.
"""

import collections
import functools
import math

import numpy as np
import torch

from neurite_tpu_torch.ops import _build

CHUNK = 64          # bins per chunk (kChunk of mi_hist.cu)
# the pairs of chunks are the grid's third axis, at most 65535 long
MAX_BINS = CHUNK * math.isqrt(65535)
TILES = (256, 128, 64)   # voxels a tile, the largest whose maps fit
MAP_FLOATS = 8192   # the maps' shared floats (32 KB)
THREADS = 256       # threads of a block (kThreads of mi_hist.cu)
MAX_BLOCKS = 1024   # first-pass blocks per batch row
SCRATCH_ENTRIES = 1 << 24   # floats of partial sums (64 MiB), over all rows

Plan = collections.namedtuple('Plan', 'tile groups smem')


def _chunk_sizes(nb_bins):
    """The bins of K10's chunks: 64 (or B), and the remainder past them."""
    sizes = {min(nb_bins, CHUNK)}
    if nb_bins > CHUNK and nb_bins % CHUNK:
        sizes.add(nb_bins % CHUNK)
    return sizes


def _block_layout(bx, by, tile):
    """(voxel groups, shared floats) of a block on chunks of bx and by bins
    with `tile` voxels a tile: its maps [tile][4 ceil(bx/4)] and
    [tile][4 ceil(by/4)], then, at its end, the groups' pair sums
    [G][P][16] and the map threads' bin sums (csrc/mi_hist.cu)."""
    nti, ntj = -(-bx // 4), -(-by // 4)
    pairs = nti * ntj
    groups = min(tile, THREADS // pairs)
    sums = (groups * pairs * 16 + 4 * (THREADS // nti * nti)
            + 4 * (THREADS // ntj * ntj))
    return groups, max(4 * tile * (nti + ntj), sums)


@functools.cache
def plan(nb_bins):
    """K10's Plan for B bins: its tile, the most voxels
    (256, 128 or 64) whose maps fit MAP_FLOATS (256 at B <= 16, 64 past 32
    bins); the voxel groups of a block on the first pair of chunks (16 at
    B = 16, one from 64 bins); and the dynamic shared bytes, the most that
    any pair of chunks needs."""
    sizes = _chunk_sizes(nb_bins)
    widest = 4 * -(-max(sizes) // 4)
    tile = next(t for t in TILES if 2 * t * widest <= MAP_FLOATS)
    floats = max(_block_layout(bx, by, tile)[1]
                 for bx in sizes for by in sizes)
    first = min(nb_bins, CHUNK)
    return Plan(tile, _block_layout(first, first, tile)[0], 4 * floats)


def _launch_blocks(n_vox, nb_bins, bs):
    """Blocks per batch row of K10's first pass: one per tile of the plan's
    voxels, at most MAX_BLOCKS and at most as many as keep the scratch
    [bs, nblk, B*B + 2B] within SCRATCH_ENTRIES, and at least one (then
    each walks several tiles)."""
    per_block = max(1, bs) * nb_bins * (nb_bins + 2)
    return max(1, min(MAX_BLOCKS, -(-n_vox // plan(nb_bins).tile),
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
    p = plan(nb_bins)
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
                 alpha_ptr, float(min_clip), float(max_clip), p.tile, p.smem,
                 _build.stream_of(x))
    _build.launches['mi_hist'] += 1
    _build.launches['mi_hist_tiled'] += 1
    return pxy, px, py
