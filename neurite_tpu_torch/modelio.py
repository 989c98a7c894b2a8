"""
Model IO: builder-config capture and save/load of a model with its config.

Counterpart of `neurite_tpu/modelio.py` (reference `neurite/tf/modelio.py`),
in its format: a directory with `config.json` ({'config': builder args,
'builder' and 'metadata'}) and `params.npz`, every variable keyed by its
flax path ('params/enc/conv_downarm_0_0/kernel', 'batch_stats/...',
'stream_stats/...') in flax's layout (`neurite_tpu_torch.convert`). A
directory the JAX package saved loads into the port's module (its
'neurite_tpu.' builder resolves to the port's builder of the same name),
and the JAX package's `load_variables` reads what the port saved.

The JAX package pickles optax state into `train_state.pkl`, which cannot
be read without JAX. The port writes its own optimizer state instead:
`train_state.pt`, a `torch.save` of the TrainState's optimizer state, step
and extras (as `training.save_checkpoint`), read back by
`load_train_state`.
"""

import functools
import importlib
import inspect
import json
import os

import numpy as np
import torch

from neurite_tpu_torch import convert

# run-time arguments of a builder, not part of a model's config: the device
# it is built on and the generator its initial weights came from
_RUNTIME_ARGS = ('device', 'generator')
_COLLECTIONS = ('params', 'batch_stats', 'stream_stats')
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


class ModelConfig:
    """Holder for captured builder args (ref `modelio.py:47-56`)."""

    def __init__(self, params):
        self.params = dict(params)
        self.params.setdefault('metadata', {})


def store_config_args(func):
    """
    Decorator for model builder functions and `__init__` methods: captures
    every argument into the result's (or the instance's) `.config`, a
    ModelConfig, so the model can be rebuilt from a saved directory alone
    (ref `modelio.py:8-44`).
    """
    argspec = inspect.getfullargspec(func)
    is_method = bool(argspec.args) and argspec.args[0] == 'self'
    arg_names = argspec.args[1:] if is_method else argspec.args

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        retval = func(*args, **kwargs)
        call_args = args[1:] if is_method else args
        params = {}
        if argspec.defaults:
            params.update(zip(reversed(arg_names), reversed(argspec.defaults)))
        params.update(zip(arg_names, call_args))
        params.update(kwargs)
        config = ModelConfig(params)
        config.params['builder'] = f'{func.__module__}.{func.__qualname__}'
        target = args[0] if is_method else retval
        if target is not None:
            target.config = config
        return retval

    return wrapper


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, range)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.dtype):
        return str(obj)
    if callable(obj):
        return f'<callable:{getattr(obj, "__name__", "fn")}>'
    return obj


def _dtype(v):
    """A config's dtype entry as a torch dtype: 'torch.bfloat16' (the
    port's), '<callable:bfloat16>' or 'bfloat16' (the JAX package's)."""
    if not isinstance(v, str):
        return v
    name = v.split('.')[-1].removeprefix('<callable:').removesuffix('>')
    if name not in _DTYPES:
        raise ValueError(f'unknown dtype {v!r} in the config')
    return _DTYPES[name]


def _variables(module):
    """The module's variables as flax collections of numpy arrays
    ({'params': ..., 'batch_stats': ..., 'stream_stats': ...}; empty
    collections left out)."""
    out = {}
    for col in _COLLECTIONS:
        tree = convert.to_flax_params(module, col)
        if tree:
            out[col] = tree
    return out


def _flatten(tree, prefix=''):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f'{prefix}{k}/'))
        else:
            flat[f'{prefix}{k}'] = np.asarray(v)
    return flat


def save_model(path, module, config=None, metadata=None, step=None,
               train_state=None, extra=None):
    """
    Save a model directory: config.json + params.npz (+ train_state.pt
    when `train_state` or `extra` is given). The config is `config` (a dict
    of builder args) or else the module's `.config` from a
    @store_config_args builder; its device and generator are left out.
    """
    if config is not None:
        params_cfg = dict(config)
    elif hasattr(module, 'config'):
        params_cfg = dict(module.config.params)
    else:
        raise ValueError('module has no captured config; build it with a '
                         '@store_config_args builder or pass config=')
    for k in _RUNTIME_ARGS:
        params_cfg.pop(k, None)
    params_cfg['metadata'] = dict(params_cfg.get('metadata') or {})
    if metadata:
        params_cfg['metadata'].update(metadata)
    if step is not None:
        params_cfg['metadata']['step'] = int(step)

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump({'config': _jsonable(params_cfg)}, f, indent=2)
    np.savez(os.path.join(path, 'params.npz'), **_flatten(_variables(module)))
    if train_state is not None or extra is not None:
        torch.save({'optimizer': None if train_state is None
                    else train_state.optimizer.state_dict(),
                    'step': None if train_state is None
                    else int(train_state.step),
                    'extra': extra}, os.path.join(path, 'train_state.pt'))


def load_config(path):
    """Load the stored builder config dict (ref `modelio.py:126-143`)."""
    with open(os.path.join(path, 'config.json')) as f:
        config = json.load(f)['config']
    # old-school enc_nf/dec_nf constructor params (ref :136-142)
    if config.get('enc_nf') and config.get('dec_nf'):
        config['nb_unet_features'] = [config.pop('enc_nf'),
                                      config.pop('dec_nf')]
    return config


def load_variables(path):
    """The saved variable collections as a nested dict of numpy arrays."""
    tree = {}
    with np.load(os.path.join(path, 'params.npz')) as flat:
        for key in flat.files:
            *parts, leaf = key.split('/')
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def load_train_state(path):
    """The optimizer state, step and extras that save_model wrote
    ({'optimizer': state_dict, 'step', 'extra'}), or None if it wrote
    none. Load the optimizer's with `optimizer.load_state_dict`."""
    p = os.path.join(path, 'train_state.pt')
    if os.path.exists(p):
        # the file holds `extra`, any picklable value save_model was given
        return torch.load(p, map_location='cpu', weights_only=False)
    if os.path.exists(os.path.join(path, 'train_state.pkl')):
        raise ValueError(f'{path} holds optax state pickled by the JAX '
                         f'package (train_state.pkl), which needs JAX to read')
    return None


def _load_into(module, variables):
    """Copy a variables tree (`load_variables`) into `module` in place."""
    return convert.load_flax_params(
        module, variables.get('params', {}), variables.get('batch_stats'),
        variables.get('stream_stats'))


_BUILDERS = {}


def register_builder(name=None):
    """Register a builder so load_model can reconstruct modules by name."""

    def deco(fn):
        _BUILDERS[name or fn.__name__] = fn
        return fn

    return deco


def _builder(name):
    if name in _BUILDERS:
        return _BUILDERS[name]
    if name.startswith('neurite_tpu.'):   # saved by the JAX package
        name = 'neurite_tpu_torch.' + name[len('neurite_tpu.'):]
    mod_name, fn_name = name.rsplit('.', 1)
    return getattr(importlib.import_module(mod_name), fn_name)


def load_model(path, builder=None, device=None, **overrides):
    """
    Rebuild a module from a saved directory (ref `modelio.py:112-123`):
    build it from the stored config (`builder` overrides the stored
    builder's name, extra kwargs the stored entries) on `device` (the
    card by default), then load its variables. Returns the module.
    """
    config = load_config(path)
    config.pop('metadata', None)
    builder_name = config.pop('builder', None)
    config.update(overrides)
    if 'dtype' in config:
        config['dtype'] = _dtype(config['dtype'])
    if builder is None:
        if builder_name is None:
            raise ValueError('no builder recorded; pass builder=')
        builder = _builder(builder_name)
    module = builder(**config, device=device)
    return _load_into(module, load_variables(path))


class LoadableModel(torch.nn.Module):
    """
    A module that saves and loads itself with its constructor's config (ref
    `neurite/tf/modelio.py:78-166`):

        class MyModel(nt.modelio.LoadableModel):
            @nt.modelio.store_config_args
            def __init__(self, nb_features=8, device=None):
                super().__init__()
                self.net = nt.models.unet(nb_features=nb_features, ...,
                                          device=device)

            def forward(self, x):
                return self.net(x)

        MyModel(16).save('/ckpt'); m = MyModel.load('/ckpt', device='cpu')
    """

    def __init__(self, metadata=None):
        super().__init__()
        if not hasattr(self, 'config'):   # constructed without the decorator
            self.config = ModelConfig({})
        self.metadata = metadata or {}

    def get_config(self):
        return dict(self.config.params)

    def save(self, path):
        cfg = dict(self.config.params)
        cfg['builder'] = f'{type(self).__module__}.{type(self).__name__}'
        save_model(path, self, cfg, metadata=self.metadata)

    @classmethod
    def load(cls, path, device=None, **overrides):
        config = load_config(path)
        metadata = config.pop('metadata', None)
        config.pop('builder', None)
        config.update(overrides)
        if 'device' in inspect.signature(cls.__init__).parameters:
            config['device'] = device
        obj = cls(**config)
        obj.metadata = metadata or {}
        return _load_into(obj, load_variables(path))
