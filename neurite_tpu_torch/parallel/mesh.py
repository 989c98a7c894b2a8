"""
Device mesh, batch placement and the data-parallel train step on
`torch.distributed` (counterpart of `neurite_tpu/parallel/mesh.py`).

JAX drives every device of a ('data', 'space') mesh from one controller:
it annotates shardings and XLA inserts the collectives. PyTorch runs SPMD:
one process a rank, each holding its own shard. The port keeps the
semantics and changes the mechanism:

- `create_mesh` returns a `DeviceMesh` of shape (data, space) with the dim
  names ('data', 'space') over the process group that the caller (or
  `torchrun`) initialised. The backend is the caller's: 'nccl' for one card
  a rank, 'gloo' for CPU ranks and for several ranks on one card; the
  mesh's groups take the same backend, and the port never picks or
  switches one.
- A batch is a local tensor on each rank, not a DTensor: `shard_batch`
  gives this rank's slice of the global host batch. `batch_sharding`,
  `replicated` and `state_shardings_for` describe layouts as
  `torch.distributed.tensor` placements, one per mesh dim.
- `make_sharded_train_step` averages the gradients and the metrics over
  the 'data' group (all-reduce, then divide by its size) around a port
  step, as DDP does.

Gloo moves CPU tensors only in its point-to-point calls, so a send of a
CUDA tensor over a gloo group goes through host memory, decided from the
group's backend and counted in `host_staged` (the halo exchanges of
`parallel.halo`).

`torch.distributed.device_mesh` and `torch.distributed.tensor` are imported
where they are used: they take a second to import, and the package imports
this module.
"""

import collections
import weakref

import numpy as np
import torch
import torch.distributed as dist

from neurite_tpu_torch import backend

DATA_AXIS = 'data'
SPACE_AXIS = 'space'

# transfers that went through host memory because the group's backend is
# gloo and the tensor lies on the card, by kind ('halo': a halo exchange,
# 'halo_grad': its backward); cleared by the caller
host_staged = collections.Counter()

# the mesh this process made last: mesh axis names (`axis_name=`) resolve
# through it, as JAX's resolve through the enclosing shard_map
_process_mesh = None

# one mesh dim as this rank sees it: its process group (None on the
# one-process mesh), its size, this rank's index in it and the group's
# global ranks in order
_Axis = collections.namedtuple('_Axis', 'group size index ranks')


def create_mesh(data=None, space=1, devices=None, device=None):
    """
    A ('data', 'space') `DeviceMesh` of shape (data, space) over the process
    group the caller initialised (`torch.distributed.init_process_group`, or
    `torchrun`). `data=None` takes the ranks left over: the world size
    divided by `space`. `devices` are the mesh's global ranks in row-major
    order (JAX's device list: a rank holds one device), all of the world by
    default. `device` is the device this rank's shards live on, the card
    unless the caller passes 'cpu'.

    With no process group, the world is this one process: the mesh is 1 x 1
    and holds no process group (a `DeviceMesh` built with
    `_init_backend=False` at rank 0), and every collective over one of its
    dims is the identity, so a single-process caller runs the same code as
    on several ranks, as a JAX user does on one device.

    Each dim's group takes the world's backend; this function never picks
    one. The mesh becomes the process's mesh, through which `axis_name=`
    arguments (the stream layers', `training.make_train_step`'s,
    `halo_exchange`'s) resolve.
    """
    from torch.distributed.device_mesh import DeviceMesh
    global _process_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                        devices]
    n = len(ranks)
    if data is None:
        if n % space:
            raise ValueError(f'{n} devices not divisible by space={space}')
        data = n // space
    if data * space > n:
        raise ValueError(f'mesh {data}x{space} exceeds {n} devices')
    dev = backend.resolve_device(device)
    grid = torch.tensor(ranks[:data * space], dtype=torch.int).reshape(
        data, space)
    names = (DATA_AXIS, SPACE_AXIS)
    if dist.is_initialized():
        # the world's backend for both dims: left to itself, DeviceMesh
        # would give a gloo world a second, NCCL group where CUDA exists
        b = dist.get_backend()
        mesh = DeviceMesh(dev.type, grid, mesh_dim_names=names,
                          backend_override=((b, None), (b, None)))
    else:
        mesh = DeviceMesh(dev.type, grid, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    _process_mesh = mesh
    return mesh


def _axis(mesh, name):
    """Mesh dim `name` as this rank sees it (an `_Axis`)."""
    if name not in mesh.mesh_dim_names:
        raise ValueError(f'no mesh axis {name!r}: the mesh has '
                         f'{mesh.mesh_dim_names}')
    if mesh.get_coordinate() is None:
        raise ValueError(f'rank {dist.get_rank()} is not in the mesh')
    if not dist.is_initialized():
        return _Axis(None, 1, 0, (0,))
    group = mesh.get_group(name)
    return _Axis(group, dist.get_world_size(group), dist.get_rank(group),
                 tuple(dist.get_process_group_ranks(group)))


def _axis_group(axis_name):
    """Mesh dim `axis_name` of the mesh this process made last."""
    if _process_mesh is None:
        raise ValueError(f'axis_name={axis_name!r} names a mesh axis, but '
                         f'this process has made no mesh: call '
                         f'parallel.create_mesh first')
    return _axis(_process_mesh, axis_name)


def _device(mesh):
    """The device this rank's shards of `mesh` live on."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _staged(ax, t):
    """True when a transfer of t over the group must go through the host:
    the group's backend is gloo and t lies on the card."""
    return (ax.group is not None and t.is_cuda
            and dist.get_backend(ax.group) == 'gloo')


def _all_reduce_(t, ax):
    """Sum t over the group in place (the identity without a group)."""
    if ax.group is not None:
        dist.all_reduce(t, group=ax.group)
    return t


def _flat_(tensors, fn):
    """fn(flat) in place on the tensors of each dtype flattened together
    (one collective a dtype), copied back into them."""
    by_dtype = collections.defaultdict(list)
    for t in tensors:
        by_dtype[t.dtype].append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def _mean_(tensors, ax):
    """Replace each tensor of a list by its mean over the group, in place:
    an all-reduce, then a division by the group's size (JAX's
    `lax.pmean`)."""
    if ax.group is not None:
        _flat_(tensors, lambda flat: _all_reduce_(flat, ax).div_(ax.size))


def _mean_grads(params, ax):
    """Average the gradients of `params` over the group in place."""
    _mean_([p.grad for p in params if p.grad is not None], ax)


def _mean_metrics(metrics, ax):
    """Each metric (a 0-d tensor or a number) averaged over the group."""
    if ax.group is None:
        return metrics
    out = {k: torch.as_tensor(v).detach().clone() for k, v in metrics.items()}
    _mean_(list(out.values()), ax)
    return out


def _broadcast_state(model, ax):
    """Give every rank of the group the first rank's parameters and buffers
    (JAX commits the one state to the mesh, replicated)."""
    if ax.group is not None:
        _flat_([t.data for t in model.parameters()] + list(model.buffers()),
               lambda flat: dist.broadcast(flat, ax.ranks[0], group=ax.group))


def _tree_map(fn, tree):
    """fn over the leaves of nested dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x):
    if torch.is_tensor(x):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _placements(spec, mesh):
    """A PartitionSpec-like tuple (one mesh axis name, a tuple of names, or
    None per tensor dim) as one placement a mesh dim: Shard(d) where the
    spec names the mesh dim at tensor dim d, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec)
                if s == name or (isinstance(s, (tuple, list)) and name in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _local(x, mesh, placements):
    """This rank's block of a global tensor laid out by `placements`."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f'rank {dist.get_rank()} is not in the mesh')
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(i)
        if x.shape[p.dim] % n:
            raise ValueError(f'axis {p.dim} of shape {tuple(x.shape)} does '
                             f'not divide over mesh axis '
                             f'{mesh.mesh_dim_names[i]!r} of size {n}')
        size = x.shape[p.dim] // n
        x = x.narrow(p.dim, coord[i] * size, size)
    return x


def batch_sharding(mesh, ndim, space_axis=1):
    """
    The placements of a [B, *spatial, C] batch of `ndim` axes: batch over
    'data' (Shard(0)) and, when the 'space' dim is larger than 1 and
    `space_axis` is not None, axis `space_axis` over 'space'.
    """
    if space_axis is not None and not 0 < space_axis < ndim:
        raise ValueError(f'space_axis {space_axis} is not a spatial axis of '
                         f'a {ndim}-axis batch')
    spec = [None] * ndim
    spec[0] = DATA_AXIS
    if space_axis is not None and mesh.size(1) > 1:
        spec[space_axis] = SPACE_AXIS
    return _placements(spec, mesh)


def replicated(mesh):
    """Replicated on every mesh dim (parameters, small tensors)."""
    return _placements((), mesh)


def _place(batch, mesh, space_axis, split_batch):
    """Each leaf's block by `batch_sharding` (axis 0 left whole unless
    split_batch), copied onto the rank's device."""
    from torch.distributed.tensor import Replicate
    dev = _device(mesh)

    def place(x):
        x = _as_tensor(x)
        pl = batch_sharding(mesh, x.ndim, space_axis)
        if not split_batch:
            pl = (Replicate(),) + pl[1:]
        x = _local(x, mesh, pl)
        return x.to(dev, copy=True, memory_format=torch.contiguous_format)

    return _tree_map(place, batch)


def shard_batch(batch, mesh, space_axis=1):
    """
    This rank's slice of a global host batch (a tuple, list or dict of
    arrays or tensors, or one): axis 0 over 'data' and `space_axis` over
    'space' (`batch_sharding`), copied onto the rank's device.
    """
    return _place(batch, mesh, space_axis, True)


def shard_batch_multihost(batch, mesh, space_axis=1):
    """
    This rank's slice of a batch that each process feeds itself (JAX:
    per-host generators feeding their addressable devices): axis 0 of the
    local batch is this rank's share of the global batch (the global batch
    is the local one times the 'data' size; the ranks of one 'data' row
    pass the same share), and `space_axis` is split over 'space'. On one
    process this is `shard_batch`.
    """
    return _place(batch, mesh, space_axis, False)


def _keystr(name):
    """A torch parameter name as JAX's `keystr` path of the same leaf:
    'lc_head.kernel' -> "['lc_head']['kernel']"."""
    return ''.join(f"['{p}']" for p in name.split('.'))


def _named_tensors(state):
    """The named parameters and buffers of a TrainState, a module or a dict
    of tensors."""
    model = getattr(state, 'model', state)
    if isinstance(model, torch.nn.Module):
        return [n for n, _ in model.named_parameters()] + \
            [n for n, _ in model.named_buffers()]
    return list(state)


def state_shardings_for(state, mesh, param_specs=None):
    """
    The placements of a train state's tensors by name (`{name: placements}`,
    one placement a mesh dim): replicated by default, with the overrides of
    `param_specs`, a dict mapping a path substring to a PartitionSpec-like
    tuple (a mesh axis name, a tuple of names, or None per tensor dim). The
    first matching entry wins. A torch name matches a substring of either
    its own form ('lc_head.kernel') or JAX's `keystr` form of the same path
    ("['lc_head']['kernel']"), so JAX's specs apply as they are:

        {"['lc_head']['kernel']": (None, None, 'space')}

    `state` is a TrainState (its model's parameters and buffers; the
    optimizer's moments take their parameter's placements, as JAX's do
    through the same spec), a module or a dict of tensors.
    """
    rep = replicated(mesh)
    out = {}
    for name in _named_tensors(state):
        out[name] = rep
        for pat, spec in (param_specs or {}).items():
            if pat in name or pat in _keystr(name):
                out[name] = _placements(tuple(spec), mesh)
                break
    return out


def make_sharded_train_step(train_step, mesh, space_axis=1,
                            donate_state=True, param_specs=None):
    """
    Data parallelism around a port train step (`training.make_train_step`):
    run(state, local_batch, generator) runs the wrapped step on this rank's
    batch (`shard_batch`), averages every gradient over the 'data' group
    (one all-reduce a dtype, then a division by the group's size) before
    the optimizer steps, and returns the state and the metrics averaged
    over the same group. The result equals the step on the global batch
    when the loss is a mean over the batch and the ranks hold equal shares
    (SoftDice is one: its mean runs over [B, L]); BatchNorm statistics and
    dropout masks stay per rank, as under DDP.

    The machinery is built once, at the first call with a state: the
    parameters and buffers are broadcast from the group's first rank (JAX
    commits the state to the mesh, replicated) and a step pre-hook that
    averages the gradients is registered on its optimizer; later calls
    reuse both (JAX's trace cache). The hook acts only inside `run`.

    `param_specs` (see `state_shardings_for`) may only keep the parameters
    replicated over mesh dims larger than 1: a parameter split over ranks
    is the explicit route of `parallel.halo` (`sharded_lc`).
    `donate_state` has no effect: the port's step updates the state in
    place, so there is no copy to donate. `space_axis` has none either,
    since the 'space' dim must be 1.

    A 'space' dim larger than 1 raises NotImplementedError: that is GSPMD's
    whole-model spatial partitioning, which torch has no counterpart of
    (DTensor's conv halo shards W only). The port's spatial route is the
    explicit halo ops of `parallel.halo` (ROADMAP Queue 1 item 9c).
    """
    from torch.distributed.tensor import Shard
    del donate_state, space_axis
    if mesh.size(1) > 1:
        raise NotImplementedError(
            f"make_sharded_train_step: a 'space' mesh axis of "
            f"{mesh.size(1)} needs GSPMD's whole-model spatial "
            f"partitioning, which torch has no counterpart of; shard the "
            f"volume explicitly with parallel.halo's ops (sharded_conv, "
            f"sharded_lc, ...) or use a 'data' mesh (ROADMAP Queue 1 item 9c)")
    data = _axis(mesh, DATA_AXIS)
    hooked = weakref.WeakKeyDictionary()   # optimizer -> its hook's handle
    inside = [False]

    def average(optimizer, args, kwargs):
        if inside[0]:
            _mean_grads([p for g in optimizer.param_groups
                         for p in g['params']], data)

    def run(state, batch, generator=None):
        opt = state.optimizer
        if opt not in hooked:
            shardings = state_shardings_for(state, mesh, param_specs)
            split = [n for n, pl in shardings.items()
                     if any(isinstance(p, Shard) and mesh.size(i) > 1
                            for i, p in enumerate(pl))]
            if split:
                raise NotImplementedError(
                    f'make_sharded_train_step keeps parameters replicated; '
                    f'param_specs split {split} over ranks (use '
                    f'parallel.sharded_lc for a z-sharded LC head)')
            _broadcast_state(state.model, data)
            hooked[opt] = opt.register_step_pre_hook(average)
        inside[0] = True
        try:
            state, metrics = train_step(state, batch, generator)
        finally:
            inside[0] = False
        return state, _mean_metrics(metrics, data)

    return run
