"""
The PyTorch port's classifiers (`models.classify`: `design_dnn` with every
final layer and both downsampling routes, `EncoderNet`, `DenseLayerNet`
with its sown regularization) against the JAX package's, with flax's
initial parameters and BatchNorm statistics moved by
`convert.load_flax_params`, and one Adam step against optax.

Tolerances: float32 outputs and BatchNorm statistics within 1e-5 of
their largest magnitude;
gradients rtol 1e-4 with atol 1e-5 of each tensor's largest entry (sums
over the volume in another order); Adam fed the port's gradients within
rtol 1e-6 (float32 rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert, training  # noqa: E402

torch.set_num_threads(1)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _pair(jm, tm, x):
    """flax init -> the port; returns (variables, jitted apply(train)).
    The sown 'losses' of the init call are dropped, so an apply sows one."""
    variables = {k: v for k, v in jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)).items()
                 if k != 'losses'}
    convert.load_flax_params(tm, variables['params'],
                             variables.get('batch_stats'))
    mutable = [k for k in variables if k != 'params'] + ['losses']
    japply = jax.jit(lambda v, a, t: jm.apply(v, a, training=t,
                                              mutable=mutable),
                     static_argnums=2)
    return variables, japply


def _check_forward(jm, tm, x, train):
    variables, japply = _pair(jm, tm, x)
    jout, state = japply(variables, jnp.asarray(x), train)
    tm.train(train)
    out = tm(torch.from_numpy(x))
    _close(out, jout)
    if 'batch_stats' in state:
        got = convert.to_flax_params(tm, 'batch_stats')
        for p, v in _leaves(state['batch_stats']).items():
            _close(_leaves(got)[p], v)
    return out, state


DNN = dict(nb_features=4, nb_levels=2, conv_size=3, nb_labels=3,
           feat_mult=2)


@pytest.mark.parametrize('final_layer,strided,shape,train', [
    ('dense-sigmoid', True, (15, 16, 14, 1), False),   # SAME strides, ceil
    ('dense-tanh', True, (16, 16, 16, 2), False),
    ('dense-softmax', True, (16, 16, 16, 1), False),
    ('dense-softmax', False, (16, 16, 16, 1), False),   # max-pool route
    ('myglobalmaxpooling', True, (16, 16, 16, 1), True),  # BatchNorm
    ('myglobalmaxpooling', False, (16, 16, 16, 1), False),
    ('globalmaxpooling', True, (16, 16, 16, 1), False),
    ('dense-softmax', False, (16, 12, 1), False),        # 2-D
])
def test_design_dnn_vs_jax(final_layer, strided, shape, train):
    kw = dict(DNN, input_shape=shape, final_layer=final_layer,
              use_strided_convolution_maxpool=strided)
    jm = ne.models.design_dnn(**kw)
    tm = nt.models.design_dnn(**kw, device='cpu')
    out, _ = _check_forward(jm, tm, _normal(0, (2, *shape)), train)
    want = {'dense-sigmoid': (2, 1), 'dense-tanh': (2, 1),
            'dense-softmax': (2, 3), 'myglobalmaxpooling': (2, 1, 1),
            'globalmaxpooling': (2, 2)}[final_layer]
    assert tuple(out.shape) == want


def test_design_dnn_valid_padding_and_bad_head():
    kw = dict(DNN, input_shape=(16, 16, 16, 1), padding='valid',
              final_layer='dense-sigmoid')
    _check_forward(ne.models.design_dnn(**kw),
                   nt.models.design_dnn(**kw, device='cpu'),
                   _normal(1, (1, 16, 16, 16, 1)), False)
    with pytest.raises(ValueError, match='final_layer'):
        nt.models.design_dnn(**dict(kw, final_layer='dense'), device='cpu')


ENC = dict(nb_features=4, input_shape=(16, 16, 16, 1), nb_levels=3,
           conv_size=3, feat_mult=2, dense_size=8, nb_labels=3)


@pytest.mark.parametrize('kw,train', [
    (dict(), False),
    (dict(nb_labels=0, rescale=.5), False),              # regression
    (dict(batch_norm=-1, use_residuals=True), True),
    (dict(nb_features=[4, [6, 8]], nb_levels=None, dropout=.3,
          input_shape=(12, 16, 1)), False),              # 2-D, eval dropout
])
def test_encoder_net_vs_jax(kw, train):
    kw = dict(ENC, **kw)
    jm = ne.models.EncoderNet(**kw)
    tm = nt.models.EncoderNet(**kw, device='cpu')
    out, _ = _check_forward(jm, tm, _normal(2, (2, *kw['input_shape'])),
                            train)
    assert out.shape[-1] == max(kw['nb_labels'], 1)


@pytest.mark.parametrize('batch_norm', [None, True])
def test_dense_layer_net_vs_jax(batch_norm):
    kw = dict(inshape=(4, 5), layer_sizes=[6, 5], nb_labels=3,
              batch_norm=batch_norm)
    jm = ne.models.DenseLayerNet(**kw)
    tm = nt.models.DenseLayerNet(**kw, device='cpu')
    _, state = _check_forward(jm, tm, _normal(3, (4, 4, 5)),
                              batch_norm is not None)
    _close(tm.regularization, state['losses']['regularization'][0], 1e-6)


def _adam_vs_optax(jm, tm, x, y, loss_of):
    """One Adam step (1e-3) of loss_of(y, pred, reg) in both packages from
    flax's initial weights: loss, gradients, updated parameters."""
    variables, _ = _pair(jm, tm, x)
    params = variables['params']

    @jax.jit
    def value_and_grad(p):
        def f(q):
            pred, st = jm.apply({**variables, 'params': q}, x, training=True,
                                mutable=['batch_stats', 'losses'])
            reg = st.get('losses', {}).get('regularization', (0.,))[0]
            return loss_of(y, pred, reg, jnp)
        return jax.value_and_grad(f)(p)

    lj, gj = value_and_grad(params)
    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(
        lambda yt, p: loss_of(yt, p, getattr(tm, 'regularization', None)
                              or 0., torch))
    state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)),
                    torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m['loss']), float(lj), rtol=1e-5)
    gt = convert.to_flax_params(tm, grad=True)
    gjl = _leaves(gj)
    assert _leaves(gt).keys() == gjl.keys()
    for p, g in _leaves(gt).items():
        scale = np.abs(gjl[p]).max()
        np.testing.assert_allclose(g, gjl[p], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg='/'.join(p))
    tx = optax.adam(1e-3)

    @jax.jit
    def adam_step(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    want = _leaves(adam_step(gt, params))
    for p, v in _leaves(convert.to_flax_params(tm)).items():
        np.testing.assert_allclose(v, want[p], rtol=1e-6, atol=1e-8,
                                   err_msg='/'.join(p))


def _cce(y, p, reg, xp):
    return -xp.mean(xp.sum(y * xp.log(p), -1)) + reg


def test_encoder_net_adam_step_vs_optax():
    """The max-pool route of ConvEnc (3 pools), a Dense head, CCE."""
    jm = ne.models.EncoderNet(**ENC)
    tm = nt.models.EncoderNet(**ENC, device='cpu')
    x = _normal(4, (2, 16, 16, 16, 1))
    y = np.eye(3, dtype=np.float32)[[0, 2]]
    _adam_vs_optax(jm, tm, x, y, _cce)


def test_dense_layer_net_adam_step_with_regularization():
    """The sown l1/l2 penalty added to the loss; BatchNorm in training."""
    kw = dict(inshape=(4, 5), layer_sizes=[6, 5], nb_labels=3,
              batch_norm=True)
    jm = ne.models.DenseLayerNet(**kw)
    tm = nt.models.DenseLayerNet(**kw, device='cpu')
    x = _normal(5, (4, 4, 5))
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    _adam_vs_optax(jm, tm, x, y, _cce)
