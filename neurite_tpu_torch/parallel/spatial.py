"""
Whole-model spatial sharding: what `parallel.make_sharded_train_step` does
to a model on a mesh whose 'space' dim is above 1 (GSPMD partitions the
whole JAX step along the sharded axis, `neurite_tpu/parallel/mesh.py`).

Each rank holds its block of the batch's sharded axis (`shard_batch`) and
runs the model on it. While a sharded step runs, this module holds the
active (mesh, sharded axis), and each module type of the port follows one
rule, named by its class attribute `spatial_rule`:

- 'halo' (`models.unet.Conv`, stride 1, SAME, an odd kernel on the axis):
  the (k // 2) * dilation rows each side come from the neighbours
  (`halo._halo`, whose backward returns the halo's gradient), then the
  conv runs VALID along the axis and SAME along the others. Any other
  conv form takes the gather rule.
- 'local': the module computes on the block as it is (`PointwiseConv`,
  the activations, softmax, the skip concat, `ops.max_pool` with window =
  stride dividing the block, the nearest upsampling, dropout, whose mask is
  broadcast over space, so equal generators give the unsharded mask, and
  the containers: `UNet`, `ConvEnc`, `ConvDec`, `AddPrior`).
- 'reduce' (`BatchNorm` in training): the block's moments summed over the
  'space' group (the blocks are equal), so every rank normalises by the
  whole volume's statistics.
- 'split' (`layers.local.LocallyConnected`, transposed, 3-D, SAME, stride
  1, sharded along z): the layer runs `halo.sharded_lc` (K7, K8 and K9 per
  shard on the card) with its kernel's and bias' z block: the block itself
  where `param_specs` split them over 'space', else the block of the whole
  parameter. Other forms take the gather rule, unless split.
- 'gather' (`models.synth.LabelsToImage`, `utils.core.resize` and
  `interpn`, and the conv forms above): the input is all-gathered along
  the axis, the module computes on the whole volume, and the rank's block
  of each volume output is returned. Each call adds one to `gathered`
  under the module's name, as `mesh.host_staged` counts staged halos.

`training.make_train_step` gathers `y_pred` and `y_true` before the loss
under the active context (`gathered['loss']`, two a step), so every loss
sees whole tensors and every rank of the 'space' group computes the same
loss. Gradients then follow from two conventions: a gather whose result
feeds a replicated computation (the loss) gives back the rank's slice of
the cotangent; a gather whose result feeds only this rank's block sums
the cotangents of the group first. A replicated parameter's gradient on a
rank is its block's share, summed over 'space' by the step.

`check(model, ...)` walks a model's modules when a step is built and
raises NotImplementedError for a module type with no rule, so no unruled
layer computes on a block unnoticed. A caller's own container declares
its rule with the same class attribute.
"""

import collections
import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from neurite_tpu_torch.parallel import mesh as pmesh
from neurite_tpu_torch.parallel.mesh import SPACE_AXIS

RULES = ('halo', 'local', 'reduce', 'split', 'gather')

# gather-rule calls by module (or function) name, and 'loss': one per
# tensor the train step gathers for its loss; cleared by the caller
gathered = collections.Counter()

# the active sharding while a sharded step runs: the mesh, the array axis
# split over 'space' and the 'space' dim as this rank sees it
_Context = collections.namedtuple('_Context', 'mesh axis ax')
_active = None


def active():
    """The active `_Context`, or None outside a sharded step (or inside a
    gather rule's whole-volume computation)."""
    return _active


@contextlib.contextmanager
def sharded(mesh, axis):
    """Make (mesh, axis) the active sharding for the block of code: `axis`
    is the array axis that `shard_batch` split over 'space'. A 'space' dim
    of 1 activates nothing."""
    global _active
    prev = _active
    ax = pmesh._axis(mesh, SPACE_AXIS)
    _active = _Context(mesh, int(axis), ax) if ax.size > 1 else None
    try:
        yield
    finally:
        _active = prev


@contextlib.contextmanager
def _suspended():
    """No active sharding: a gather rule's whole-volume computation."""
    global _active
    prev, _active = _active, None
    try:
        yield
    finally:
        _active = prev


###############################################################################
# collectives with their autograd
###############################################################################

# dtypes summed in float32 (exact: each sum adds zeros to one value)
_WIDEN = {torch.bfloat16: torch.float32}


class _Gather(torch.autograd.Function):
    """The blocks of the group concatenated along `axis`: each rank's block
    placed in zeros, then one all-reduce (exact, and gloo's all-reduce
    takes CUDA tensors where its all-gather may not). backward: the rank's
    slice of the cotangent, summed over the group first when `sum_grads`
    (the whole result fed only this rank's block of what follows)."""

    @staticmethod
    def forward(ctx, x, axis, ax, sum_grads):
        ctx.axis, ctx.ax, ctx.sum_grads = axis, ax, sum_grads
        n = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = n * ax.size
        wide = _WIDEN.get(x.dtype, x.dtype)
        full = torch.zeros(shape, dtype=wide, device=x.device)
        full.narrow(axis, ax.index * n, n).copy_(x)
        return pmesh._all_reduce_(full, ax).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        axis, ax = ctx.axis, ctx.ax
        if ctx.sum_grads:
            wide = _WIDEN.get(g.dtype, g.dtype)
            g = pmesh._all_reduce_(g.to(wide, copy=True), ax).to(g.dtype)
        n = g.shape[axis] // ax.size
        return g.narrow(axis, ax.index * n, n).contiguous(), None, None, None


class _SumOverSpace(torch.autograd.Function):
    """The sum of t over the group, on every rank; backward: the
    cotangents summed over the group (each rank used the sum on its own
    block)."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return pmesh._all_reduce_(t.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return pmesh._all_reduce_(g.clone(), ctx.ax), None


def gather(x, name, sum_grads=True):
    """This rank's block x, all-gathered along the active axis, counted in
    `gathered[name]`."""
    ctx = _active
    gathered[name] += 1
    return _Gather.apply(x, ctx.axis, ctx.ax, sum_grads)


def gather_loss_inputs(*tensors):
    """The train step's (y_true, y_pred), each tensor gathered whole for
    the loss (`gathered['loss']`); the loss is computed alike on every rank
    of the group, so each gather gives back the rank's slice of its
    cotangent."""
    def one(t):
        if not torch.is_tensor(t) or t.ndim <= _active.axis:
            return t
        return gather(t, 'loss', sum_grads=False)
    return pmesh._tree_map(one, tensors)


def _block(t, whole, ctx):
    """The rank's block of an output t of the whole volume: tensors of the
    input's rank are volumes, split along the axis; others are returned
    whole."""
    if not torch.is_tensor(t) or t.ndim != whole.ndim:
        return t
    n = t.shape[ctx.axis]
    if n % ctx.ax.size:
        raise ValueError(f'an output of {n} along the sharded axis does not '
                         f'split over {ctx.ax.size} ranks')
    n //= ctx.ax.size
    return t.narrow(ctx.axis, ctx.ax.index * n, n)


def gather_call(name, fn, x, blocks=True):
    """The gather rule: fn on the whole volume of this rank's block x, with
    no active sharding inside; the rank's block of each volume output
    (`blocks`), or fn's result as it is (the outputs are this rank's
    already, as `interpn`'s at this rank's points)."""
    ctx = _active
    whole = gather(x, name)
    with _suspended():
        out = fn(whole)
    if not blocks:
        return out
    return pmesh._tree_map(lambda t: _block(t, whole, ctx), out)


def gathers(method):
    """Decorator of a module method whose first argument is a volume: the
    gather rule under an active sharding (counted under the class name),
    the method as it is otherwise."""
    @functools.wraps(method)
    def wrapped(self, x, *args, **kwargs):
        if _active is None:
            return method(self, x, *args, **kwargs)
        return gather_call(type(self).__name__,
                           lambda w: method(self, w, *args, **kwargs), x)
    return wrapped


###############################################################################
# the rules of the port's layers
###############################################################################

def conv(layer, x):
    """`models.unet.Conv` on this rank's block: the halo rule for stride 1,
    SAME and an odd kernel on the sharded axis, else the gather rule."""
    from neurite_tpu_torch.parallel import halo
    ctx = _active
    d = ctx.axis - 1                       # the axis among the kernel's
    ks, dil = layer.kernel_size, layer.dilation
    if not (0 <= d < len(ks) and layer.padding == 'same'
            and all(s == 1 for s in layer.strides) and ks[d] % 2 == 1):
        return gather_call('Conv', layer._forward, x)
    dt = layer.dtype or x.dtype
    xs = halo._halo(x.to(dt), (ks[d] // 2) * dil, ctx.axis, ctx.ax)
    pads = [dil * (k - 1) for k in ks]
    pads[d] = 0
    xc = xs.movedim(-1, 1)
    if all(p % 2 == 0 for p in pads):
        padding = tuple(p // 2 for p in pads)
    else:                                  # an even kernel elsewhere
        flat = []
        for p in reversed(pads):
            flat += [p // 2, p - p // 2]
        xc, padding = F.pad(xc, flat), 0
    b = None if layer.bias is None else layer.bias.to(dt)
    y = layer._conv(xc, layer.weight.to(dt), b, padding=padding,
                    dilation=dil)
    return y.movedim(1, -1)


def batch_moments(mean, sq, axis):
    """BatchNorm's block moments (the mean and the mean square over the
    block's batch and spatial axes) as the whole volume's: summed over the
    'space' group and divided by its size, the blocks being equal."""
    ctx = _active
    if axis == ctx.axis:
        raise NotImplementedError(
            'BatchNorm over the sharded axis: its statistics and running '
            'averages are per plane of the whole axis')
    both = _SumOverSpace.apply(torch.stack([mean, sq]), ctx.ax) / ctx.ax.size
    return both[0], both[1]


def check_pool(shape, window, strides):
    """`ops.max_pool` on a block is the block of the whole pool when the
    windows tile the block along the sharded axis."""
    ctx = _active
    d = ctx.axis - 1
    if tuple(strides) != tuple(window):
        raise NotImplementedError(
            f'max_pool with strides {tuple(strides)} != window '
            f'{tuple(window)} on a spatially sharded block')
    if shape[ctx.axis] % window[d]:
        raise ValueError(f'max_pool window {window[d]} does not divide the '
                         f'block\'s {shape[ctx.axis]} rows along the sharded '
                         f'axis')


def locally_connected(layer, x):
    """`layers.local.LocallyConnected` on this rank's z block: the split
    rule through `halo.sharded_lc` with the kernel's and bias' z block (the
    parameter itself when split over 'space', else its block), or the
    gather rule for other forms of a layer whose parameters are whole."""
    from neurite_tpu_torch.parallel import halo
    ctx = _active
    n, i = ctx.ax.size, ctx.ax.index
    d = layer.out_shape[0]
    split = layer.kernel.shape[-1] != math.prod(layer.out_shape)
    if not (layer.transposed and layer.rank == 3 and ctx.axis == 1
            and layer.padding == 'same'
            and all(s == 1 for s in layer.strides)):
        if split:
            raise NotImplementedError(
                f'{type(layer).__name__} with split parameters takes the '
                f'transposed 3-D SAME stride-1 form sharded along z only')
        return gather_call(type(layer).__name__, layer._forward, x)
    want = (d // n, *layer.input_shape[1:])
    if tuple(x.shape[1:]) != want:
        raise ValueError(f'expected a z block [B, *{want}], got '
                         f'{tuple(x.shape)}')
    ct = layer.dtype or x.dtype
    o, tc = layer.kernel.shape[:2]
    kernel = layer.kernel.reshape(o, tc, -1, layer.out_shape[1]
                                  * layer.out_shape[2])
    if not split:
        kernel = kernel.narrow(2, i * (d // n), d // n)
    impl = 'pallas' if x.is_cuda and layer.impl == 'auto' else 'tap'
    y = halo.sharded_lc(x.to(ct), kernel.to(ct), layer.kernel_size,
                        ctx.mesh, impl=impl).to(x.dtype)
    if layer.use_bias:
        bias = layer.bias
        if bias.shape[0] == d:
            bias = bias.narrow(0, i * (d // n), d // n)
        y = y + bias
    if layer.activation is not None:
        y = layer.activation(y)
    return y


###############################################################################
# the build-time checks
###############################################################################

def rule_of(cls):
    """The rule of a module type: its own `spatial_rule`, or the one of the
    class that defines the `forward` it runs; None when that class declares
    none (a subclass that overrides `forward` declares its own)."""
    for c in cls.__mro__:
        if 'spatial_rule' in vars(c):
            return vars(c)['spatial_rule']
        if 'forward' in vars(c):
            return None
    return None


def check(model, split):
    """Raise NotImplementedError for a module of `model` whose type has no
    rule, and for a parameter split over 'space' (`split`: {name:
    (tensor dim split over 'space', split over 'data' too)}) that no
    'split' rule holds: only a transposed 3-D LocallyConnected layer's
    kernel (its voxel axis, dim 2) and bias (its z axis, dim 0)."""
    for name, m in model.named_modules():
        rule = rule_of(type(m))
        if rule not in RULES:
            raise NotImplementedError(
                f'module {name or "(the model)"!r} of type '
                f'{type(m).__module__}.{type(m).__qualname__} has no rule '
                f'for spatial sharding (rules: {", ".join(RULES)}); it would '
                f'compute on a block as if it were the whole volume')
    owners = {f'{mn}.{pn}' if mn else pn: (m, pn)
              for mn, m in model.named_modules()
              for pn, _ in m.named_parameters(recurse=False)}
    for name, (dim, over_data) in split.items():
        m, pn = owners.get(name, (None, None))
        ok = (m is not None and rule_of(type(m)) == 'split' and not over_data
              and m.transposed and m.rank == 3 and m.padding == 'same'
              and all(s == 1 for s in m.strides)
              and (pn, dim) in (('kernel', 2), ('bias', 0)))
        if not ok:
            raise NotImplementedError(
                f'param_specs split {name!r} (dim {dim}'
                + (', and over \'data\'' if over_data else '')
                + '): only a transposed 3-D LocallyConnected layer\'s '
                  'kernel (dim 2) and bias (dim 0) split over \'space\' have '
                  'a rule')
