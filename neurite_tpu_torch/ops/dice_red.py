"""
One-pass Dice sums: per-label sum(x*y), sum(x^2), sum(y^2) over the voxels.

Counterpart of `neurite_tpu/ops/dice_red.py`. For CUDA tensors the forward is
the hand-written kernel K3 of `csrc/dice_red.cu`; the backward is plain torch,
as in the JAX package (`dice_red.py:80-84`).

`plan` picks K3's body and its launch shape, and the launcher trusts it:
'vec' (L a multiple of 4, both maps 16-byte aligned) is one device launch
of float4 streams that adds its blocks' partials in its last block;
'scalar' (any other L or alignment) is two launches, the partials' pass
and a final pass. Both add in a fixed order, so a result is the same from
call to call. Every call adds one to `_build.launches['dice_sums']`, and a
call of the 'vec' body one to `_build.launches['dice_sums_vec']` too.
"""

import collections

import torch

from neurite_tpu_torch.ops import _build

THREADS = 512       # threads of a 'vec' block, rounded down to whole label
                    # groups of L/4 (the scalar body: `_launch_shape`)
UNROLL = 4          # float4 pairs in flight a thread (kUnroll of the source)
BLOCKS = 2 * 132    # 'vec' blocks over all rows: two on each of 132 SMs

Plan = collections.namedtuple('Plan', 'body threads nblk fin')

_IMPLS = {'auto': 'auto', 'kernel': 'kernel', 'plain': 'plain',
          'pallas': 'kernel', 'jnp': 'plain'}  # JAX's names are aliases


def _dice_sums_plain(x, y):
    """(sum_v x*y, sum_v x*x, sum_v y*y) of [bs, V, L] -> 3 x [bs, L]."""
    return (x * y).sum(1), (x * x).sum(1), (y * y).sum(1)


def _launch_shape(n_vox, nb_labels):
    """(threads, blocks per batch row) of K3's first pass: a block holds a
    whole number of label groups, and each thread sums ~16 elements."""
    threads = nb_labels * max(1, 256 // nb_labels)
    nblk = max(1, min(1024, -(-n_vox * nb_labels // (threads * 16))))
    return threads, nblk


def plan(bs, n_vox, nb_labels, ptrs):
    """K3's Plan(body, threads, nblk, fin) for maps [bs, V, L] whose data
    pointers are `ptrs`. 'vec' where L is a multiple of 4, every pointer is
    16-byte aligned and a row has fewer than 2^31 elements (its float4s take
    a 32-bit index): threads L/4 * (THREADS // (L/4)), a multiple of L/4;
    nblk blocks a row, about BLOCKS / bs and no more than give each thread
    UNROLL float4s; fin threads of the last block add each float4 column
    of the partials (bs * 3L/4 columns, at most `threads` a pass), as many
    as fit and at most nblk.
    'scalar' otherwise, with `_launch_shape`'s threads and blocks (fin
    None)."""
    n = n_vox * nb_labels
    if (nb_labels % 4 or not nb_labels or n >= 2 ** 31
            or any(p % 16 for p in ptrs)):
        return Plan('scalar', *_launch_shape(n_vox, nb_labels), None)
    l4 = nb_labels // 4
    threads = l4 * max(1, THREADS // l4)
    nblk = max(1, min(-(-(n // 4) // (threads * UNROLL)),
                      -(-BLOCKS // max(bs, 1))))
    cols = min(3 * l4 * max(bs, 1), threads)   # float4 columns a pass
    return Plan('vec', threads, nblk, max(1, min(nblk, threads // cols)))


_counters = {}   # (device index, stream) -> the 'vec' body's zeroed int32


def _counter(x):
    """The 'vec' body's ticket counter of x's device and current stream:
    allocated (and zeroed, one fill) at the first call there; each launch
    leaves it 0."""
    key = (x.device.index, _build.stream_of(x))
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=x.device)
    return _counters[key]


def dice_sums_cuda(x, y):
    """K3: the three sums of [bs, V, L] float32 contiguous CUDA tensors."""
    if not (x.is_cuda and y.is_cuda):
        raise ValueError('x and y must be CUDA tensors')
    if x.shape != y.shape or x.ndim != 3 or x.device != y.device:
        raise ValueError(f'x and y must be [bs, V, L] on one device, got '
                         f'{tuple(x.shape)} and {tuple(y.shape)}')
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError('x and y must be float32')
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError('x and y must be contiguous')
    bs, n_vox, nb_labels = x.shape
    if nb_labels > 1024 or bs > 65535:
        raise ValueError(f'the Dice kernel takes L <= 1024 and bs <= 65535, '
                         f'got {tuple(x.shape)}')
    p = plan(bs, n_vox, nb_labels, (x.data_ptr(), y.data_ptr()))
    partial = torch.empty((bs, p.nblk, 3, nb_labels), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((3, bs, nb_labels), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        if p.body == 'vec':
            lib.call('neurite_dice_sums_vec_f32', x.data_ptr(), y.data_ptr(),
                     partial.data_ptr(), out.data_ptr(),
                     _counter(x).data_ptr(), bs, n_vox, nb_labels, p.threads,
                     p.nblk, p.fin, _build.stream_of(x))
        else:
            lib.call('neurite_dice_sums_f32', x.data_ptr(), y.data_ptr(),
                     partial.data_ptr(), out.data_ptr(), bs, n_vox,
                     nb_labels, p.threads, p.nblk, _build.stream_of(x))
    _build.launches['dice_sums'] += 1
    if p.body == 'vec':
        _build.launches['dice_sums_vec'] += 1
    return out[0], out[1], out[2]


class DiceSums(torch.autograd.Function):
    """K3 forward; backward g_xy*y + 2*g_xx*x (and symmetric) in plain torch."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return dice_sums_cuda(x, y)

    @staticmethod
    def backward(ctx, g_xy, g_xx, g_yy):
        x, y = ctx.saved_tensors
        g_xy, g_xx, g_yy = (g[:, None, :] for g in (g_xy, g_xx, g_yy))
        return g_xy * y + 2. * g_xx * x, g_xy * x + 2. * g_yy * y


def dice_sums(x, y, impl='auto', interpret=False):
    """
    One-pass Dice partial sums.

    Args:
        x, y: [bs, V, L] probability maps (cast to float32).
        impl: 'auto' or 'kernel' (K3 for CUDA tensors, the plain version for
            CPU tensors), or 'plain'. JAX's 'pallas' and 'jnp' are aliases of
            'kernel' and 'plain'.
        interpret: True takes the plain version whatever `impl` says, the
            port's counterpart of running the Pallas kernel in interpret
            mode.

    Returns:
        (sum_xy, sum_xx, sum_yy), each [bs, L] float32.
    """
    if impl not in _IMPLS:
        raise ValueError(f'impl must be one of {sorted(_IMPLS)}, got {impl!r}')
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if interpret or _IMPLS[impl] == 'plain' or not x.is_cuda:
        return _dice_sums_plain(x, y)
    return DiceSums.apply(x.contiguous(), y.contiguous())
