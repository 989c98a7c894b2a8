"""
Explicit spatial sharding with halo exchange (counterpart of
`neurite_tpu/parallel/halo.py`).

A volume's spatial axis is split over the mesh's 'space' dim: each rank
holds its block of rows, and an op that reads a window across the block's
edges first takes `halo` rows from each neighbour (`halo_exchange`, a ring
of neighbour sends). JAX writes these ops inside `shard_map` on the global
array; here each op is called on every rank of the group with the rank's
local block (as `parallel.shard_batch` gives it) and returns the rank's
block of the result. Each one runs the port's own op per shard: K6
(`ops.blur`) for a 3-D CUDA blur, K3 (`ops.dice_red`) for the Dice sums,
K7 with K8 and K9 in its backward (`ops.lc_cuda`) for the LC head, K4
(`ops.warp`) for the bounded warp, cuDNN for the convs; a CPU tensor takes
the plain versions, as everywhere in the port.

The halos travel by `torch.distributed.batch_isend_irecv` on the 'space'
group: card to card under NCCL; through host memory under gloo, whose
point-to-point calls move CPU tensors only (decided from the group's
backend, and counted in `parallel.mesh.host_staged`).
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from neurite_tpu_torch.ops import blur, dice_red, lc_cuda, lc_tap, warp
from neurite_tpu_torch.parallel import mesh as pmesh
from neurite_tpu_torch.parallel.mesh import SPACE_AXIS
from neurite_tpu_torch.utils import core


def _swap(ax, to_left, to_right, kind):
    """Send `to_left` to the left neighbour of the group's chain and
    `to_right` to the right one; return (from_left, from_right), what each
    neighbour sent this way, None at a global edge (the chain does not wrap:
    JAX's ring sends the wrapped slabs, and the boundary replaces them)."""
    i, n = ax.index, ax.size
    staged = pmesh._staged(ax, to_left)
    dev = to_left.device
    ops = []
    got = {}
    # rightward messages carry tag 0, leftward ones tag 1
    for side, peer, send, tag_out, tag_in in (
            ('left', i - 1, to_left, 1, 0), ('right', i + 1, to_right, 0, 1)):
        if not 0 <= peer < n:
            continue
        send = send.contiguous()
        if staged:
            send = send.cpu()
        got[side] = torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, ax.ranks[peer], ax.group,
                           tag=tag_out),
                dist.P2POp(dist.irecv, got[side], ax.ranks[peer], ax.group,
                           tag=tag_in)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            pmesh.host_staged[kind] += 1
            got = {k: v.to(dev) for k, v in got.items()}
    return got.get('left'), got.get('right')


class _HaloExchange(torch.autograd.Function):
    """The ring exchange; its backward sends each halo slab's gradient back
    to the rank that sent the slab, which adds it onto its edge rows (the
    transposed ppermute that JAX's shard_map derives)."""

    @staticmethod
    def forward(ctx, x, halo, axis, ax, boundary):
        ctx.halo, ctx.axis, ctx.ax, ctx.boundary = halo, axis, ax, boundary
        first, last = x.narrow(axis, 0, halo), x.narrow(axis, -halo, halo)
        from_left, from_right = _swap(ax, first, last, 'halo')
        if from_left is None:
            from_left = (first if boundary == 'edge' else
                         torch.zeros_like(first))
        if from_right is None:
            from_right = (last if boundary == 'edge' else
                          torch.zeros_like(last))
        return torch.cat([from_left, x, from_right], axis)

    @staticmethod
    def backward(ctx, g):
        halo, axis, ax = ctx.halo, ctx.axis, ctx.ax
        n = g.shape[axis] - 2 * halo
        g_left, g_right = g.narrow(axis, 0, halo), g.narrow(axis, -halo, halo)
        dx = g.narrow(axis, halo, n).clone()
        from_left, from_right = _swap(ax, g_left, g_right, 'halo_grad')
        if from_left is None and ctx.boundary == 'edge':
            from_left = g_left
        if from_right is None and ctx.boundary == 'edge':
            from_right = g_right
        if from_left is not None:
            dx.narrow(axis, 0, halo).add_(from_left)
        if from_right is not None:
            dx.narrow(axis, n - halo, halo).add_(from_right)
        return dx, None, None, None, None


def _halo(x, halo, axis, ax, boundary='zero'):
    if boundary not in ('zero', 'edge'):
        raise ValueError(f'unknown boundary {boundary}')
    if halo == 0:
        return x
    if x.shape[axis] < halo:
        raise ValueError(f'halo {halo} exceeds local extent {x.shape[axis]}')
    return _HaloExchange.apply(x, halo, axis, ax, boundary)


def halo_exchange(x, halo, axis, axis_name=SPACE_AXIS, boundary='zero'):
    """
    Concatenate `halo`-wide neighbour slabs onto both ends of `axis` of this
    rank's block x, over the mesh axis `axis_name` of the process's mesh
    (`create_mesh`). The global edges get zeros (boundary='zero', SAME
    zero padding) or their own edge rows (boundary='edge') in place of a
    neighbour's. Returns the block padded to local extent + 2 * halo along
    `axis`; differentiable (the halos' gradients go back to their ranks).
    """
    return _halo(x, halo, axis, pmesh._axis_group(axis_name), boundary)


def sharded_conv(x, kernel, mesh, sharded_axis=1, axis_name=SPACE_AXIS):
    """
    SAME-padding N-D convolution of this rank's block x [B, *spatial, C]
    of a batch whose `sharded_axis` is split over `axis_name`: the kernel
    radius is halo-exchanged, then the block is convolved VALID along that
    axis and SAME along the others (`F.conv{1,2,3}d`, cuDNN on the card).

    kernel: [*k_spatial, C_in, C_out], the same on every rank (flax's
    layout; cast to x's dtype). Returns this rank's block [B, *spatial,
    C_out]. An even kernel on the sharded axis raises.
    """
    kernel = torch.as_tensor(kernel, device=x.device)
    nd = kernel.ndim - 2
    k_ax = kernel.shape[sharded_axis - 1]
    if k_ax % 2 != 1:
        raise ValueError('even kernel size on the sharded axis is not '
                         'supported')
    xs = _halo(x, (k_ax - 1) // 2, sharded_axis, pmesh._axis(mesh, axis_name))
    pads = []
    for d in reversed(range(nd)):
        k = kernel.shape[d]
        pads += [0, 0] if d == sharded_axis - 1 else [(k - 1) // 2, k // 2]
    w = kernel.to(x.dtype).permute(nd + 1, nd, *range(nd))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    return conv(F.pad(xs.movedim(-1, 1), pads), w).movedim(1, -1)


def _blur_pass(y, k, d):
    """One SAME pass of taps k along spatial axis d of y [N, *space]: K6 for
    a 3-D CUDA tensor, the plain per-axis conv otherwise."""
    if y.is_cuda and y.ndim == 4:
        return blur.blur3d(y.contiguous(),
                           [k if a == d else None for a in range(3)])
    return core.conv_axis(y, k, d)


def sharded_separable_blur(x, kernels_1d, mesh, sharded_axis=1,
                           axis_name=SPACE_AXIS):
    """
    Separable SAME blur of this rank's block x [B, *spatial, C] with one
    odd-width 1-D kernel a spatial axis, in axis order, `sharded_axis` split
    over `axis_name`: the pass along the sharded axis runs over the
    halo-padded block and drops the halo rows after; the other passes run
    on the block. A 3-D CUDA tensor takes K6 (float32) one axis a launch,
    the taps in the same order as the unsharded `ops.blur.blur3d`, so each
    output voxel is the same sum; rank 2 and CPU tensors take the plain
    per-axis convs.
    """
    nd = len(kernels_1d)
    if x.ndim != nd + 2:
        raise ValueError(f'{nd} kernels for a block of shape '
                         f'{tuple(x.shape)}')
    ks = [torch.as_tensor(k, device=x.device).to(x.dtype).reshape(-1)
          for k in kernels_1d]
    ax = pmesh._axis(mesh, axis_name)
    b, c, space = x.shape[0], x.shape[-1], tuple(x.shape[1:-1])
    y = x.movedim(-1, 1).reshape(b * c, *space)     # [B*C, *space]
    for d, k in enumerate(ks):
        if d + 1 != sharded_axis:
            y = _blur_pass(y, k, d)
            continue
        if k.numel() % 2 != 1:
            raise ValueError('sharded-axis blur kernels must be odd-sized')
        halo = (k.numel() - 1) // 2
        y = _blur_pass(_halo(y, halo, d + 1, ax), k, d).narrow(
            d + 1, halo, space[d])
    return y.reshape(b, c, *space).movedim(1, -1)


class _SumOverGroup(torch.autograd.Function):
    """The sum of t over the group, replicated on each rank. The backward
    passes the cotangent through: the result is replicated, so a function
    of it that every rank computes alike gives each rank the gradient of
    its own share (JAX's psum under shard_map with a replicated output)."""

    @staticmethod
    def forward(ctx, t, ax):
        return pmesh._all_reduce_(t.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_dice_sums(y_true, y_pred, mesh, sharded_axis=1,
                      axis_name=SPACE_AXIS):
    """
    Dice partial sums of a batch [B, *spatial, L] whose `sharded_axis` is
    split over `axis_name`: this rank's block reduced by `ops.dice_sums`
    (K3 for CUDA tensors, float32), then one all-reduce of the three [B, L]
    sums over the group. Returns (sum_xy, sum_xx, sum_yy), each [B, L],
    the same on every rank of the group. `sharded_axis` has no effect: the
    block's voxels reduce whichever axis was split.
    """
    del sharded_axis
    b, nb = y_true.shape[0], y_true.shape[-1]
    sums = dice_red.dice_sums(y_true.reshape(b, -1, nb),
                              y_pred.reshape(b, -1, nb))
    out = _SumOverGroup.apply(torch.stack(sums),
                              pmesh._axis(mesh, axis_name))
    return out[0], out[1], out[2]


def sharded_lc(x, kernel, kernel_size, mesh, padding='same', impl='tap',
               interpret=False, axis_name=SPACE_AXIS):
    """
    Locally-connected conv (the config #3 head) of this rank's z block
    x [B, D/n, H, W, C] with its z block of the transposed kernel
    [O, prod(k)*C, D/n, H*W]: the weights are per voxel, so z-sharding the
    volume shards them with it, and the only exchange is the (kz-1)/2-plane
    halo of x; dk lands on the rank that owns those weights, and dx's halo
    rows go back to the ranks that sent them.

    impl: 'tap' runs the plain `ops.lc_tap.lc_transposed` per shard, VALID
    along z over the halo-padded block; 'pallas' runs
    `ops.lc_cuda.lc_transposed_pallas` per shard (K7 forward, K8 dk and K9
    dx for CUDA tensors; their plain versions for CPU ones): SAME over the
    halo-padded block with `halo` zero weight planes a side, whose outputs
    are dropped (and their dk with them). `interpret` has no effect.
    Returns this rank's block [B, D/n, H, W, O] in float32.
    """
    del interpret
    if padding != 'same':
        raise ValueError('sharded_lc supports SAME padding only')
    kz = kernel_size[0]
    if kz % 2 != 1:
        raise ValueError('even z kernels are not supported under sharding')
    halo = (kz - 1) // 2
    o, tc = kernel.shape[:2]
    xs = _halo(x, halo, 1, pmesh._axis(mesh, axis_name))
    if impl == 'pallas':
        kp = F.pad(kernel, (0, 0, halo, halo))
        y = lc_cuda.lc_transposed_pallas(xs, kp.reshape(o, tc, -1),
                                         tuple(kernel_size))
        return y[:, halo:y.shape[1] - halo]
    if impl != 'tap':
        raise ValueError(f"impl must be 'tap' or 'pallas', got {impl!r}")
    xs = lc_tap._pad_trailing(xs.movedim(-1, 1),
                              lc_tap._pads(kernel_size[1:])).movedim(1, -1)
    return lc_tap.lc_transposed(xs, kernel.reshape(o, tc, -1),
                                tuple(kernel_size), 'valid')


def sharded_bounded_warp(vol, loc_shift, mesh, max_disp=8.0,
                         interp_method='linear', fill_value=None,
                         impl='onehot', matmul_dtype=None,
                         axis_name=SPACE_AXIS):
    """
    Warp this rank's z block of a batch of 3-D volumes, out(x) = vol(x +
    shift(x)), |shift| <= max_disp along z: a halo of ceil(max_disp) + 1
    source rows, then the exact warp of `ops.warp` (K4 for CUDA tensors)
    over the halo-padded block. z coordinates are clipped against the
    global extent (and, for 'nearest', rounded) before they are made local
    by an exact subtraction, so the block's result is the unsharded warp's
    rows, bit for bit; with `fill_value`, points outside the global volume
    take it.

    vol: [B, D/n, H, W] or [B, D/n, H, W, C]; loc_shift: [B, D/n, H, W, 3]
    displacements (z in global voxel units), the same block. `impl` and
    `matmul_dtype` pick among JAX's TPU engines and have no effect: the
    port's one engine is exact beyond any window.
    """
    del impl, matmul_dtype
    ax = pmesh._axis(mesh, axis_name)
    local = vol.shape[1]
    d_global = local * ax.size
    halo = int(math.ceil(float(max_disp))) + 1
    if halo > local:
        raise ValueError(f'halo {halo} exceeds local z extent {local}')
    s = loc_shift.to(torch.float32)
    z_off = ax.index * local
    grid = core.grid_points(s.shape[1:-1], s.device)
    zg = grid[..., 0] + z_off                       # global z, exact
    loc_z = torch.clamp(zg[None] + s[..., 0], 0., d_global - 1.)
    if interp_method == 'nearest':
        # round where the unsharded warp rounds: the block's offset may be
        # odd, which would turn a half-to-even tie the other way
        loc_z = torch.round(loc_z)
    vp = _halo(vol, halo, 1, ax)
    if ax.index == 0:
        # z clips at 0, so the first block's low halo is never read;
        # without it the block's offset is 0 and the others' is at most z:
        # loc_z - offset is then exact in float32, as the unsharded warp's
        # coordinate is
        vp = vp[:, halo:]
    offset = z_off - (halo if ax.index else 0)
    loc = torch.stack([loc_z - offset, grid[None, ..., 1] + s[..., 1],
                       grid[None, ..., 2] + s[..., 2]], -1)
    out = warp.interpn_batch(vp, loc, interp_method)
    if fill_value is not None:
        glob = torch.stack([zg[None] + s[..., 0], loc[..., 1], loc[..., 2]],
                           -1)
        maxl = torch.tensor([d_global - 1., s.shape[2] - 1., s.shape[3] - 1.],
                            device=s.device)
        oob = ((glob < 0.) | (glob > maxl)).any(-1)
        if vol.ndim == 5:
            oob = oob[..., None]
        out = torch.where(oob, torch.as_tensor(fill_value, dtype=out.dtype,
                                               device=out.device), out)
    return out
