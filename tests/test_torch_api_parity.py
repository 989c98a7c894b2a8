"""
Public-API parity of the PyTorch port: every name of the reference API
(`REFERENCE_API`, pinned in `tests/test_api_parity.py`) is present on
`neurite_tpu_torch`, as are the JAX package's `ops` aliases; and every
public function and class of both packages takes the same parameters, but
for the differences listed in `SIGNATURE_DIFFERENCES` and the torch idioms
of `PORT_ONLY`, each with its reason.
"""
import inspect

import pytest

pytest.importorskip('torch')

from test_api_parity import REFERENCE_API  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu.io.native  # noqa: E402,F401
import neurite_tpu_torch as nt  # noqa: E402
import neurite_tpu_torch.io.native  # noqa: E402,F401

# the JAX package's `ops` exports of its TPU engines, which the port keeps
# as aliases of its exact ops (ROADMAP "Not ported, on purpose")
OPS_ALIASES = ['interpn_cube', 'interpn_rows', 'interpn_shear_onehot',
               'block_spread_ok', 'shear_bound', 'shear_window_disp',
               'conv_im2col', 'conv_z2d']

# public names beyond REFERENCE_API whose signatures are compared too
MORE_PUBLIC = {
    'ops': OPS_ALIASES + ['dice_sums', 'mi_histograms', 'separable_blur3d',
                          'interpn_onehot', 'interpn_window',
                          'resize_separable', 'interp_matrix'],
    'training': ['create_train_state', 'make_train_step', 'make_eval_step',
                 'fit', 'profile_trace', 'annotate_step',
                 'make_checked_train_step', 'save_checkpoint',
                 'restore_checkpoint'],
    'io': ['Volume', 'load_nii', 'save_nii', 'load_mgh', 'save_mgh',
           'load_volfile', 'save_volfile', 'patch_gen', 'patch_starts',
           'grid_size', 'quilt', 'quilt_device'],
    'io.native': ['one_hot', 'nan_aggregate_axis0', 'relabel', 'available'],
    'generators': ['VolumeDataset', 'prefetch_to_device'],
    'data': ['synthetic_shapes', 'Dataset'],
    'py.data': ['DataSplit', 'split_dataset', 'load_dataset'],
    # the mesh and halo ops; their parameters are JAX's, and the meshes'
    # device ('device', PORT_ONLY) is the one torch-only parameter: the
    # process group, and so the backend, is the caller's
    'parallel': ['create_mesh', 'batch_sharding', 'replicated', 'shard_batch',
                 'make_sharded_train_step', 'shard_batch_multihost',
                 'state_shardings_for', 'halo_exchange', 'sharded_conv',
                 'sharded_separable_blur', 'sharded_dice_sums', 'sharded_lc',
                 'sharded_bounded_warp'],
}
PUBLIC = {m: sorted(set(REFERENCE_API.get(m, []) + MORE_PUBLIC.get(m, [])))
          for m in sorted(set(REFERENCE_API) | set(MORE_PUBLIC))}

# parameters the port adds, by name, wherever they appear: the torch idioms
PORT_ONLY = {
    'device': 'modules and tensors are made on an explicit device (the '
              'card unless the caller passes one)',
    'generator': 'random draws come from an explicit torch.Generator, '
                 'where flax takes PRNG keys at init and apply',
    'input_shape': 'a torch module is sized when it is built; flax infers '
                   'its shapes from the first input',
    'in_features': 'the same: sized when built',
    'hyper_features': 'the same: sized when built',
    'skip_channels': 'the same: sized when built',
    'impl': 'chooses the hand-written kernel or its plain version',
    'pool_impl': 'chooses the pooling kernel or its plain version',
    'use_kernel': 'chooses the Dice kernel or its plain version',
    'guard': 'one alias takes every JAX warp engine\'s knobs (no effect)',
    'engine': 'the same: no effect',
    'version': 'the same: no effect',
    'max_disp': 'the same: no effect',
    'seed': '`fit` takes an integer seed beside JAX\'s `rng`',
}

# JAX parameters the port does not take: (module, name) -> (parameters,
# reason)
FLAX_STATE = 'the port\'s modules hold their parameters; flax passes ' \
             'variables and PRNG keys explicitly'
SIGNATURE_DIFFERENCES = {
    ('layers', 'SpatiallySparse_Dense'): (
        ['kernel_initializer', 'bias_initializer'],
        'flax initialiser callables; the port draws JAX\'s N(0, 0.05^2) '
        'from its generator'),
    ('modelio', 'LoadableModel'): (['module', 'variables'], FLAX_STATE),
    ('training', 'create_train_state'): (
        ['rng', 'sample_input', 'training_kwargs'],
        'flax initialises the model here; a port model is built '
        'initialised'),
    ('utils.model', 'mod_submodel'): (['variables', 'rngs'], FLAX_STATE),
    ('utils.model', 'reset_weights'): (['rng', 'sample_input'],
                                       FLAX_STATE),
    ('utils.model', 'copy_weights'): (
        ['src_variables', 'dst_variables'],
        'copies between two modules (`src`, `dst`), not variable trees'),
    ('utils.vae', 'extract_z_dec'): (['variables', 'sample_rng'],
                                     FLAX_STATE),
    ('utils.vae', 'sweep_dec_given_x'): (['variables', 'sample_rng'],
                                         FLAX_STATE),
    ('utils.vae', 'pca_init_dense'): (['variables', 'sample_rng'],
                                      FLAX_STATE),
    ('utils.vae', 'latent_stats'): (['variables', 'sample_rng'],
                                    FLAX_STATE),
}
# port-only parameters outside PORT_ONLY, by name
PORT_EXTRA = {
    ('utils.model', 'copy_weights'): ['src', 'dst'],
}


def _module(pkg, name):
    obj = pkg
    for part in name.split('.'):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _params(obj):
    """Parameter names of a function, or of a class's constructor (a flax
    module's fields; a torch class's `**kwargs` reach its bases')."""
    if inspect.isclass(obj):
        fields = getattr(obj, '__dataclass_fields__', {})
        if 'parent' in fields:
            return [n for n in fields if n not in ('parent', 'name')]
        names = []
        for cls in obj.__mro__:
            if '__init__' not in vars(cls):
                continue
            sig = inspect.signature(cls.__init__)
            names += [n for n, p in sig.parameters.items()
                      if n != 'self' and n not in names
                      and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
            if not any(p.kind == p.VAR_KEYWORD
                       for p in sig.parameters.values()):
                break
        return names
    sig = inspect.signature(obj)
    return [n for n, p in sig.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


@pytest.mark.parametrize('module', sorted(REFERENCE_API))
def test_reference_names_present_or_listed(module):
    obj = _module(nt, module)
    missing = [n for n in REFERENCE_API[module]
               if obj is None or not hasattr(obj, n)]
    assert not missing, f'{module} missing: {missing}'


@pytest.mark.parametrize('name', OPS_ALIASES)
def test_ops_aliases_present(name):
    assert callable(getattr(nt.ops, name))
    assert callable(getattr(ne.ops, name))


@pytest.mark.parametrize('module,name', [(m, n) for m, names in PUBLIC.items()
                                         for n in names])
def test_signatures(module, name):
    pj = _params(getattr(_module(ne, module), name))
    pt = _params(getattr(_module(nt, module), name))
    missing = [p for p in pj if p not in pt]
    extra = [p for p in pt if p not in pj and p not in PORT_ONLY]
    want_missing, reason = SIGNATURE_DIFFERENCES.get((module, name), ([], ''))
    assert missing == want_missing, f'{module}.{name}: {missing} ({reason})'
    assert extra == PORT_EXTRA.get((module, name), []), \
        f'{module}.{name} adds {extra}'
    # the parameters both take come in the same order
    common = [p for p in pt if p in pj]
    assert common == [p for p in pj if p in pt], f'{module}.{name} order'


def test_listed_differences_are_real():
    for (module, name), (params, reason) in SIGNATURE_DIFFERENCES.items():
        assert name in PUBLIC[module] and params and reason
        pt = _params(getattr(_module(nt, module), name))
        assert not set(params) & set(pt)


def test_parallel_axis_names():
    assert (nt.parallel.DATA_AXIS, nt.parallel.SPACE_AXIS) == \
        (ne.parallel.DATA_AXIS, ne.parallel.SPACE_AXIS) == ('data', 'space')


def test_counts():
    """168 reference names, none missing (63 before the serve path's
    modules, 16 before the host data modules); the eight ops aliases."""
    assert sum(len(v) for v in REFERENCE_API.values()) == 168
    missing = [(m, n) for m, names in REFERENCE_API.items() for n in names
               if not hasattr(_module(nt, m) or object(), n)]
    assert missing == []
    assert len(OPS_ALIASES) == 8
