"""
Adam whose update of CUDA parameters is one fused pass: K11 of
`csrc/adam.cu`. CPU parameters take the plain version in this module.

The JAX package leaves Adam to `optax.adam`; the port had
`torch.optim.Adam`, whose foreach path makes seven passes over each
tensor, each reading and writing device memory and rounding to the
stored type. K11 reads a parameter, its gradient and both moments once,
computes in float32 in `torch.optim.Adam`'s order and writes the parameter
and the moments once each, rounded to their own type.

`Adam` keeps `torch.optim.Adam`'s interface: its `defaults` (lr, betas,
eps, and weight_decay, amsgrad and maximize, which it does not implement
and so takes only at their off values), and per-parameter state 'step' (a
CPU float tensor), 'exp_avg' and 'exp_avg_sq' in the parameter's dtype.
A state dict passes between the two either way. Step hooks run, as for
every `torch.optim.Optimizer`.

CUDA parameters are float32 or bfloat16: K11 raises on any other dtype
and never falls back to the plain version.

`plan` picks each tensor's body, and the launcher trusts it. `adam_cuda`
launches once for each (device, dtype, step) group of up to MAX_TENSORS
tensors. The counters count launches, not tensors: every launch adds one
to `_build.launches['adam']`, and one to `['adam_vec']` where all of its
tensors take the 'vec' body, or else to `['adam_scalar']`, a launch in
which at least one tensor (a 2-element bias, say) takes the scalar body
while the others take 'vec'.
"""

import ctypes

import torch

from neurite_tpu_torch.ops import _build

MAX_TENSORS = 64    # rows of a launch's table (kMaxTensors of the source)
_LAUNCHERS = {torch.float32: 'neurite_adam_f32',
              torch.bfloat16: 'neurite_adam_bf16'}


def plan(ptrs, numel, itemsize):
    """K11's body for one tensor whose four streams (parameter, gradient,
    exp_avg, exp_avg_sq) start at `ptrs`: 'vec' where every pointer is
    16-byte aligned and `numel` a multiple of a 16-byte vector's width
    (16 // itemsize elements), 'scalar' otherwise. Offsets are 64-bit in
    both, so the length sets no other limit."""
    p, g, m, v = ptrs
    if numel % (16 // itemsize) or (p % 16 or g % 16 or m % 16 or v % 16):
        return 'scalar'
    return 'vec'


def _dense(t):
    """True where t's elements fill numel consecutive places from its data
    pointer in some order of its dims: a contiguous tensor, or one permuted
    as the convs' channels-last weights are. The update is elementwise, so
    four tensors of one such layout are updated as flat arrays."""
    if t.is_contiguous():
        return True
    run = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(), t.shape)
                               if sz != 1):
        if stride != run:
            return False
        run *= size
    return True


def _adam_plain(p, g, m, v, step, lr, b1, b2, eps):
    """One Adam step of one tensor in place, in `torch.optim.Adam`'s order:
    m.lerp_(g, 1 - b1); v.mul_(b2).addcmul_(g, g, 1 - b2); denom =
    sqrt(v) / sqrt(1 - b2^t) + eps; p.addcdiv_(m, denom, -lr / (1 - b1^t)).
    In float32 (or the parameter's type where wider): a bfloat16 or float16
    tensor is upcast for the arithmetic and rounded once at the end."""
    work = torch.promote_types(p.dtype, torch.float32)
    P, G, M, V = (t if t.dtype == work else t.to(work) for t in (p, g, m, v))
    M.lerp_(G, 1 - b1)
    V.mul_(b2).addcmul_(G, G, value=1 - b2)
    denom = (V.sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
    P.addcdiv_(M, denom, value=-(lr / (1 - b1 ** step)))
    for t, w in ((p, P), (m, M), (v, V)):
        if w is not t:
            t.copy_(w)


def adam_cuda(params, grads, exp_avgs, exp_avg_sqs, step, lr, b1, b2, eps):
    """
    K11: one Adam step at `step` (the count after this step) of CUDA
    tensors of one device and dtype (float32 or bfloat16), one launch for
    each MAX_TENSORS of them. Each parameter is dense (`_dense`), its
    moments of its shape and layout; its gradient of its shape, and laid
    out as it is or copied so. Every call checks every tensor.
    """
    dev, dtype = params[0].device, params[0].dtype
    if dev.type != 'cuda' or dtype not in _LAUNCHERS:
        raise ValueError(f'the Adam kernel takes float32 or bfloat16 CUDA '
                         f'tensors, got {dtype} on {dev}')
    itemsize = params[0].element_size()
    cols = ([], [], [], [], [], [])   # p, g, m, v pointers; lengths; 'vec'
    keep = []                         # copied gradients, alive to the launch
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        shape, stride = p.shape, p.stride()
        for t in (p, g, m, v):
            if t.device != dev or t.dtype != dtype or t.shape != shape:
                raise ValueError(
                    f'the Adam kernel takes a parameter, its gradient and '
                    f'moments of one device, dtype and shape, got '
                    f'{t.dtype} {tuple(t.shape)} on {t.device} beside '
                    f'{dtype} {tuple(shape)} on {dev}')
        if m.stride() != stride or v.stride() != stride:
            raise ValueError('the Adam kernel takes moments laid out as '
                             'their parameter')
        if not _dense(p):
            raise ValueError('the Adam kernel takes dense tensors')
        if g.stride() != stride:
            g = torch.empty_like(p).copy_(g)   # the parameter's layout
            keep.append(g)
        n = p.numel()
        if n:
            ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
            vec = plan(ptrs, n, itemsize) == 'vec'
            for col, x in zip(cols, (*ptrs, n, vec)):
                col.append(x)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    hyper = (1 - b1, b2, 1 - b2, 1 / bc2 ** 0.5, eps, -(lr / bc1))
    lib, name = _build.library(), _LAUNCHERS[dtype]
    stream = _build.stream_of(params[0])
    types = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_uint8]
    with torch.cuda.device(dev):
        for at in range(0, len(cols[0]), MAX_TENSORS):
            part = [col[at:at + MAX_TENSORS] for col in cols]
            k = len(part[0])
            arrays = [(ty * k)(*col) for ty, col in zip(types, part)]
            lib.call(name, *(ctypes.addressof(a) for a in arrays), k,
                     *hyper, stream)
            _build.launches['adam'] += 1
            _build.launches['adam_vec' if all(part[5]) else
                            'adam_scalar'] += 1


class Adam(torch.optim.Optimizer):
    """
    Adam (Kingma and Ba, 2015) as `torch.optim.Adam` computes it without
    weight decay, amsgrad or maximize, its update of CUDA parameters one
    launch of K11 for each (device, dtype, step) group of parameters.
    CUDA parameters must be float32 or bfloat16 (K11 raises on others,
    where `torch.optim.Adam` takes them); CPU parameters may be of any
    floating dtype.

    Args:
        params: the parameters, or parameter groups, to optimise.
        lr, betas, eps: as `torch.optim.Adam`'s.
        weight_decay, amsgrad, maximize: `torch.optim.Adam`'s options,
            accepted only off (0, False, False); any other value raises
            NotImplementedError, here or at a step whose group (from a
            loaded state dict) sets it.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0, amsgrad=False, maximize=False):
        if not 0. <= lr:
            raise ValueError(f'Invalid learning rate: {lr}')
        if not 0. <= eps:
            raise ValueError(f'Invalid epsilon value: {eps}')
        for i, b in enumerate(betas):
            if not 0. <= b < 1.:
                raise ValueError(f'Invalid beta parameter at index {i}: {b}')
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay, amsgrad=amsgrad,
                        maximize=maximize)
        _check_options(defaults)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every parameter that has a gradient; returns
        `closure()`'s loss where a closure is given."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            _check_options(group)
            b1, b2 = group['betas']
            hyper = (float(group['lr']), b1, b2, group['eps'])
            todo = []
            for p in group['params']:
                g = p.grad
                if g is None:
                    continue
                if g.is_sparse:
                    raise RuntimeError('Adam does not support sparse '
                                       'gradients')
                state = self.state[p]
                if not state:
                    state['step'] = torch.tensor(0.)
                    state['exp_avg'] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state['exp_avg_sq'] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                todo.append((p, g, state['exp_avg'], state['exp_avg_sq'],
                             state['step']))
            if not todo:
                continue
            # a CPU tensor as the addend: the fast path for CPU steps
            torch._foreach_add_([row[4] for row in todo], torch.tensor(1.),
                                alpha=1.)
            groups = {}
            for p, g, m, v, s in todo:
                t = s.item()
                if p.is_cuda:
                    groups.setdefault((p.device, p.dtype, t), []).append(
                        (p, g, m, v))
                else:
                    _adam_plain(p, g, m, v, t, *hyper)
            for (_, _, t), rows in groups.items():
                adam_cuda(*zip(*rows), t, *hyper)
        return loss


def _check_options(group):
    """Raise on the options of `torch.optim.Adam` that K11 does not
    implement."""
    on = [k for k in ('weight_decay', 'amsgrad', 'maximize') if group.get(k)]
    if on:
        raise NotImplementedError(
            f'Adam implements no {", ".join(on)}: use torch.optim.Adam')
