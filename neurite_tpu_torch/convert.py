"""
Move parameters between flax trees and the port's modules.

The port's modules carry the flax scope names as attribute paths
(`enc.conv_downarm_0_0.weight` <-> params['enc']['conv_downarm_0_0']
['kernel']), so a conversion is a walk over names plus a layout change per
leaf type:

    Conv           kernel [*k, I, O]      <-> weight [O, I, *k]
    PointwiseConv  kernel [1,..,1, I, O]  <-> weight [I, O]
    modules with `flax_same_layout` (BatchNorm, Dense, Local*,
    LocallyConnected*, the hyper-dense maps, ...)
                   every parameter as it is, by its name
    modules with `flax_buffers`    the buffers it names for a collection:
                   BatchNorm's mean, var (batch_stats), the stream layers'
                   mean, count (, cov) (stream_stats)

Trees are nested dicts of numpy arrays (any mapping of array-likes loads).
A bfloat16 leaf loads into a bfloat16 parameter, and a bfloat16 parameter
comes out as a float32 array holding the same values.
"""

from collections.abc import Mapping

import numpy as np
import torch

from neurite_tpu_torch.models.unet import Conv, PointwiseConv


def _same(a):
    return a


def _entries(module, collection):
    """(flax path, tensor, to_flax, from_flax) for every leaf of
    `collection` ('params', 'batch_stats' or 'stream_stats') under
    `module`."""
    for name, mod in module.named_modules():
        path = tuple(name.split('.')) if name else ()
        buffers = getattr(mod, 'flax_buffers', {})
        if collection in buffers:
            for leaf in buffers[collection]:
                yield path + (leaf,), getattr(mod, leaf), _same, _same
            continue
        if collection == 'params' and isinstance(mod, Conv):
            nd = len(mod.kernel_size)
            to_f = (lambda a, nd=nd:
                    np.transpose(a, (*range(2, nd + 2), 1, 0)))
            from_f = (lambda a, nd=nd:
                      np.transpose(a, (nd + 1, nd, *range(nd))))
            yield path + ('kernel',), mod.weight, to_f, from_f
        elif collection == 'params' and isinstance(mod, PointwiseConv):
            w = mod.weight
            yield (path + ('kernel',), w,
                   lambda a, ks=mod.kernel_size: a.reshape(*ks, *a.shape),
                   lambda a, s=tuple(w.shape): a.reshape(s))
        elif collection == 'params' and getattr(mod, 'flax_same_layout',
                                                 False):
            for leaf, p in mod.named_parameters(recurse=False):
                yield path + (leaf,), p, _same, _same
            continue
        else:
            continue
        if mod.bias is not None:
            yield path + ('bias',), mod.bias, _same, _same


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def load_flax_params(module, params, batch_stats=None, stream_stats=None):
    """Copy a flax `params` tree (and optionally `batch_stats` and
    `stream_stats`) into `module` in place; every leaf must match by name
    and shape. Returns the module."""
    for collection, tree in (('params', params), ('batch_stats', batch_stats),
                             ('stream_stats', stream_stats)):
        if tree is None:
            continue
        flat = _flatten(tree)
        seen = set()
        for path, t, _, from_flax in _entries(module, collection):
            key = '/'.join(path)
            if path not in flat:
                raise KeyError(f'{collection}: no entry {key}')
            a = np.asarray(flat[path])
            if a.dtype.name == 'bfloat16':  # numpy's bfloat16 extension
                a = a.astype(np.float32)
            a = np.array(from_flax(a), order='C')
            if a.shape != tuple(t.shape):
                raise ValueError(f'{collection}/{key}: shape {a.shape} does '
                                 f'not fit {tuple(t.shape)}')
            with torch.no_grad():
                t.copy_(torch.from_numpy(a))
            seen.add(path)
        extra = sorted('/'.join(p) for p in set(flat) - seen)
        if extra:
            raise KeyError(f'{collection}: entries the module lacks: {extra}')
    return module


def to_flax_params(module, collection='params', grad=False):
    """The module's `collection` ('params', 'batch_stats' or
    'stream_stats') as a flax-layout tree of numpy arrays; with grad=True,
    the parameters' gradients."""
    tree = {}
    for path, t, to_flax, _ in _entries(module, collection):
        src = t.grad if grad else t
        if src is None:
            raise ValueError(f'{"/".join(path)} has no gradient')
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        # a copy: a CPU tensor's .numpy() shares its storage
        src = src.detach().cpu()
        if src.dtype == torch.bfloat16:
            src = src.float()
        node[path[-1]] = np.array(to_flax(src.numpy()), order='C', copy=True)
    return tree
