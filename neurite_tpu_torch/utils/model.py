"""
Model composition and weight utilities.

Counterpart of `neurite_tpu/utils/model.py` (reference
`neurite/tf/utils/model.py`). Models are modules holding their weights, so
the weight utilities work on modules in place. A module path is the flax
path of the same submodule, '/'-joined ('enc/conv_downarm_0_0',
'dec/likelihood'): the port names its submodules as flax scopes them, so
the path strings of `module_paths`, `sub_apply` and `mod_submodel` are the
JAX package's. `sub_apply` cuts a forward pass with forward hooks: `until`
stops it once the named modules have run, `inject` replaces the named
modules (they do not run).
"""

import numpy as np
import torch
import torch.distributed as dist


def stack_models(apply_fns):
    """
    Compose models or apply functions end to end:
    stack_models([f, g, h])(x) = h(g(f(x))); extra arguments go to the
    first (ref `stack_models`, `model.py:36-83`).
    """
    fns = list(apply_fns)
    if not fns:
        raise ValueError('need at least one model')

    def stacked(x, *args, **kwargs):
        out = fns[0](x, *args, **kwargs)
        for fn in fns[1:]:
            out = fn(out)
        return out

    return stacked


def _path(name):
    return name.replace('.', '/')


def _module(model, path):
    """The submodule at a '/'-joined path."""
    names = dict(model.named_modules())
    name = path.replace('/', '.')
    if not path or name not in names:
        raise KeyError(f'module path {path!r} not found; available: '
                       f'{sorted(_path(n) for n in names if n)}')
    return names[name]


def module_paths(model, sample_input, **forward_kwargs):
    """
    The sorted '/'-joined paths of every submodule that a forward pass on
    `sample_input` runs: the names `sub_apply` and `mod_submodel` take
    (JAX's from flax's captured intermediates).
    """
    ran = set()
    handles = [mod.register_forward_hook(
        lambda m, a, o, name=name: ran.add(_path(name)))
        for name, mod in model.named_modules() if name]
    try:
        with torch.no_grad():
            model(sample_input, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    return sorted(ran)


class _Stop(Exception):
    """Raised by a hook once every tapped module has run."""


def sub_apply(model, inputs, until=None, inject=None, **forward_kwargs):
    """
    Run `model` cut at interior modules (ref `mod_submodel` graph surgery,
    `neurite/tf/utils/model.py:86-249`).

    until: a module path or a list of them: return that module's output
        (a list gives {path: output}); the forward pass stops once all of
        them have run.
    inject: {module path: value}: those modules are not run and give
        `value` as their output, so everything downstream sees it;
        `inputs` then only has to reach them (zeros of the input's shape
        work).
    """
    paths = ([until] if isinstance(until, str) else
             list(until) if until is not None else [])
    taps, handles, replaced = {}, [], []

    def tap(path):
        def hook(mod, args, out):
            taps[path] = out
            if len(taps) == len(paths):
                raise _Stop
        return hook

    try:
        for path in paths:
            handles.append(_module(model, path).register_forward_hook(
                tap(path)))
        for path, value in (inject or {}).items():
            mod = _module(model, path)
            mod.forward = lambda *a, value=value, **k: value
            replaced.append(mod)
        try:
            out = model(inputs, **forward_kwargs)
        except _Stop:
            out = None
    finally:
        for h in handles:
            h.remove()
        for mod in replaced:
            del mod.forward   # back to the class's forward
    if not paths:
        return out
    missing = [p for p in paths if p not in taps]
    if missing:
        raise KeyError(f'modules {missing} did not run')
    return taps[until] if isinstance(until, str) else taps


def mod_submodel(model, sample_input, from_layer=None, to_layer=None,
                 **forward_kwargs):
    """
    A callable sub-model cut between two module paths (ref `mod_submodel`,
    `model.py:86-249`): fn(value) gives `to_layer`'s output (the model's
    output when None) for `value` as `from_layer`'s output; with no
    `from_layer`, value is the model's input (None: `sample_input`).
    `sample_input` reaches the bypassed part of the model.
    """
    def fn(value=None):
        if from_layer is not None:
            return sub_apply(model, sample_input, until=to_layer,
                             inject={from_layer: value}, **forward_kwargs)
        return sub_apply(model, sample_input if value is None else value,
                         until=to_layer, **forward_kwargs)

    return fn


def reset_weights(model, generator=None):
    """
    Draw the model's weights anew in place (ref `reset_weights`,
    `model.py:252-273`): every submodule's `reset_parameters(generator)`,
    in module order, from `generator` (seed 0 when None), so a model built
    from one seed and reset with another holds the second seed's weights.
    A submodule with parameters of its own and no `reset_parameters` is an
    error. Returns the model.
    """
    generator = generator or torch.Generator().manual_seed(0)
    for name, mod in model.named_modules():
        if hasattr(mod, 'reset_parameters'):
            mod.reset_parameters(generator)
        elif next(mod.parameters(recurse=False), None) is not None:
            raise ValueError(f'{_path(name) or "the model"} '
                             f'({type(mod).__name__}) has no '
                             f'reset_parameters')
    return model


def copy_weights(src, dst, verbose=False):
    """
    Copy weights between models by name and shape (ref `copy_weights`,
    `model.py:276-295`): every parameter and buffer of `dst` that `src`
    has with the same shape takes src's value; the rest keep dst's.
    Returns dst.
    """
    src_state = src.state_dict()
    with torch.no_grad():
        for name, t in dst.state_dict().items():
            if name in src_state and src_state[name].shape == t.shape:
                t.copy_(src_state[name])
                if verbose:
                    print('copied', name)
            elif verbose and name in src_state:
                print('shape mismatch, kept dst:', name)
    return dst


def robust_multi_gpu(train_step, verbose=True, device=None, **kwargs):
    """
    The train step for the ranks of this run (ref `robust_multi_gpu`,
    `model.py:298-321`, which wrapped a keras model for several GPUs).
    In a process group of more than one rank (`torchrun`, or processes
    that called `init_process_group`): `parallel.make_sharded_train_step`
    over a 'data' mesh of every rank, with the mesh as `.mesh` (JAX
    `model.py:207-214`); feed it `parallel.shard_batch(batch, wrapped.mesh,
    space_axis=None)`. `device` is the ranks' device (the card unless the
    caller passes 'cpu'); kwargs pass through to `make_sharded_train_step`.
    With one process: the step unchanged (JAX `model.py:197-205`), or a
    raise if several cards are visible, since one process drives one card.
    """
    from neurite_tpu_torch import parallel
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        mesh = parallel.create_mesh(data=world, device=device)
        if verbose:
            print(f'robust_multi_gpu: data-parallel over {world} ranks')
        wrapped = parallel.make_sharded_train_step(train_step, mesh,
                                                   **kwargs)
        wrapped.mesh = mesh
        return wrapped
    n = torch.cuda.device_count()
    if n > 1:
        raise NotImplementedError(
            f'robust_multi_gpu: {n} cards visible to one process; the port '
            f'runs one process a card: start one rank a card with torchrun '
            f'(torchrun --nproc-per-node={n} script.py, which calls '
            f'init_process_group("nccl")) and call robust_multi_gpu in each')
    if verbose:
        print('robust_multi_gpu: one device visible — returning the step '
              'unchanged')
    try:
        train_step.mesh = None
    except AttributeError:
        pass
    return train_step


def diagram(model, sample_input, **forward_kwargs):
    """
    A text summary of the model (ref `diagram`, `model.py:324-329`): one
    line per submodule that a forward pass on `sample_input` runs, in
    order, with its class, output shape and parameter count, and the
    total.
    """
    rows = []

    def hook(name):
        def record(mod, args, out):
            shape = (tuple(out.shape) if torch.is_tensor(out) else
                     type(out).__name__)
            rows.append((name, type(mod).__name__, shape,
                         sum(p.numel() for p in mod.parameters())))
        return record

    handles = [mod.register_forward_hook(hook(_path(name) or '(model)'))
               for name, mod in model.named_modules()]
    try:
        with torch.no_grad():
            model(sample_input, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    lines = [f'{"path":40s} {"module":22s} {"output":28s} {"params":>10s}']
    lines += [f'{n:40s} {c:22s} {str(s):28s} {p:10d}' for n, c, s, p in rows]
    lines.append(f'total parameters: {param_count(model)}')
    return '\n'.join(lines)


def param_count(model_or_tree):
    """The number of scalar parameters of a module, or of the leaves of a
    nested dict of arrays (a flax-layout tree)."""
    if isinstance(model_or_tree, torch.nn.Module):
        return sum(p.numel() for p in model_or_tree.parameters())
    return sum(param_count(v) if isinstance(v, dict)
               else int(np.prod(np.shape(v)))
               for v in model_or_tree.values())
