"""
The PyTorch port's hypernetwork layers (`layers.hyper`) and streaming
statistics (`layers.stream`) against the JAX package's, on the same numpy
inputs, with flax's initial weights and statistics moved by `convert`.

Tolerances: float32, 1e-5 of the largest magnitude for outputs and
gradients (sums in another order); the streaming mean and covariance
within 1e-6 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neurite_tpu.layers import hyper as jhyper  # noqa: E402
from neurite_tpu.layers import stream as jstream  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402

torch.set_num_threads(1)


def _normal(seed, shape, scale=1.):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _grads_vs_jax(tfwd, jfwd, arrays, out_seed=99):
    """Forward and the gradient of <out, w> for every input, port vs JAX."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = tfwd(*ts)
    w = _normal(out_seed, tuple(y.shape))
    (y * torch.from_numpy(w)).sum().backward()

    def run(args, ct):   # one jitted program: op by op, every op compiles
        jy, vjp = jax.vjp(jfwd, *args)
        return jy, vjp(ct)

    jy, jgs = jax.jit(run)([jnp.asarray(a) for a in arrays], jnp.asarray(w))
    _close(y, jy)
    for t, jg in zip(ts, jgs):
        _close(t.grad, jg)


###############################################################################
# hyper
###############################################################################

# rank, kernel, strides, padding, dilation, bias, activation
CONV_CASES = [
    (3, 3, 1, 'same', 1, True, None),
    (3, 2, 2, 'same', 1, True, 'relu'),      # even kernel, stride 2
    (3, (3, 2, 1), (2, 1, 2), 'same', 1, False, None),
    (3, 3, 1, 'valid', 2, True, 'elu'),      # dilation
    (3, 4, 2, 'same', 2, True, None),        # even kernel, dilation, stride
    (2, 3, 2, 'same', 1, True, 'tanh'),
    (2, 2, 1, 'valid', 1, True, None),
]


@pytest.mark.parametrize('case', CONV_CASES, ids=str)
def test_hyper_conv_vs_jax(case):
    rank, ks, strides, padding, dil, use_bias, act = case
    kt = (ks,) * rank if isinstance(ks, int) else ks
    b, c, f = 2, 2, 3
    spatial = (9, 8, 7)[:rank]
    x = _normal(0, (b, *spatial, c))
    k = _normal(1, (b, *kt, c, f), .3)
    bias = _normal(2, (b, f))
    kw = dict(filters=f, kernel_size=ks, strides=strides, padding=padding,
              dilation_rate=dil, activation=act, use_bias=use_bias)
    cls, jcls = ((nt.layers.HyperConv3D, jhyper.HyperConv3D) if rank == 3
                 else (nt.layers.HyperConv2D, jhyper.HyperConv2D))
    tm, jm = cls(**kw), jcls(**kw)
    arrays = [x, k, bias] if use_bias else [x, k]
    _grads_vs_jax(lambda *a: tm(list(a)),
                  jax.jit(lambda *a: jm.apply({}, list(a))), arrays)


def test_hyper_conv_causal_raises():
    with pytest.raises(ValueError, match='Causal'):
        nt.layers.HyperConv(3, 3, padding='causal')


@pytest.mark.parametrize('use_bias', [True, False])
def test_hyper_conv_from_dense_vs_jax(use_bias):
    kw = dict(filters=3, kernel_size=(3, 2, 3), strides=2, padding='same',
              activation='relu', use_bias=use_bias,
              hyperkernel_activation='tanh')
    x, h = _normal(3, (2, 8, 7, 6, 2)), _normal(4, (2, 5))
    jm = jhyper.HyperConv3DFromDense(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              [jnp.asarray(x), jnp.asarray(h)])['params']
    tm = nt.layers.HyperConv3DFromDense(2, 5, device='cpu', **kw)
    convert.load_flax_params(tm, params)
    _grads_vs_jax(lambda a, b: tm([a, b]),
                  jax.jit(lambda a, b: jm.apply({'params': params}, [a, b])),
                  [x, h])
    # flax's tree comes back out; the port's own draws take flax's
    # shapes and lecun-normal scale
    back = convert.to_flax_params(tm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            params))
    tp = convert.to_flax_params(
        nt.layers.HyperConv3DFromDense(2, 5, device='cpu', **kw))
    for name, leaf in (('hyperkernel', 'kernel'), ('hyperkernel', 'bias')):
        assert tp[name][leaf].shape == params[name][leaf].shape
    assert abs(tp['hyperkernel']['kernel'].std() - 1 / np.sqrt(5)) < .1


@pytest.mark.parametrize('use_bias', [True, False])
def test_hyper_dense_vs_jax(use_bias):
    x = _normal(5, (3, 4, 6))
    k = _normal(6, (3, 6, 5))
    b = _normal(7, (3, 5))
    tm = nt.layers.HyperDense(5, activation='sigmoid', use_bias=use_bias)
    jm = jhyper.HyperDense(units=5, activation='sigmoid', use_bias=use_bias)
    arrays = [x, k, b] if use_bias else [x, k]
    _grads_vs_jax(lambda *a: tm(list(a)),
                  jax.jit(lambda *a: jm.apply({}, list(a))), arrays)

    kw = dict(units=4, use_bias=use_bias, hyperbias_activation='elu')
    h = _normal(8, (3, 7))
    jm = jhyper.HyperDenseFromDense(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              [jnp.asarray(x), jnp.asarray(h)])['params']
    tm = nt.layers.HyperDenseFromDense(6, 7, device='cpu', **kw)
    convert.load_flax_params(tm, params)
    _grads_vs_jax(lambda a, c: tm([a, c]),
                  jax.jit(lambda a, c: jm.apply({'params': params}, [a, c])),
                  [x, h])


###############################################################################
# stream
###############################################################################

BATCHES = (2, 3, 1, 4, 2)     # cap 6: reached at the third batch


@pytest.mark.parametrize('name', ['MeanStream', 'CovStream'])
def test_stream_vs_jax_over_batches(name):
    """Five updates (training=True), each output and the stored statistics
    against flax's 'stream_stats'; inference scales by min(1, count/cap),
    before the cap (after one batch) and after it."""
    shape = (3, 2)
    jm = getattr(jstream, name)(cap=6)
    tm = getattr(nt.layers, name)(shape, cap=6, device='cpu')
    xs = [_normal(10 + i, (b, *shape)) for i, b in enumerate(BATCHES)]
    state = jax.jit(lambda k, a: jm.init(k, a, training=True))(
        jax.random.PRNGKey(0), jnp.asarray(xs[0]))['stream_stats']
    convert.load_flax_params(tm, {}, stream_stats=state)
    japply = jax.jit(lambda s, x, t: jm.apply(
        {'stream_stats': s}, x, training=t, mutable=['stream_stats']),
        static_argnums=2)
    for i, x in enumerate(xs):
        if i == 1:   # before the cap: scaled by count / cap = 2 / 6
            out = tm(torch.from_numpy(x))
            jout, _ = japply(state, jnp.asarray(x), False)
            _close(out, jout, 1e-6)
        out = tm(torch.from_numpy(x), training=True)
        jout, upd = japply(state, jnp.asarray(x), True)
        state = upd['stream_stats']
        _close(out, jout, 1e-6)
        got = convert.to_flax_params(tm, 'stream_stats')
        assert got.keys() == state.keys()
        for k in got:
            _close(got[k], state[k], 1e-6)
    x = _normal(20, (2, *shape))
    _close(tm(torch.from_numpy(x)), japply(state, jnp.asarray(x), False)[0],
           1e-6)
    assert float(tm.count[0]) == sum(BATCHES)


@pytest.mark.parametrize('name', ['MeanStream', 'CovStream'])
def test_stream_gradient_and_axis_name(name):
    """An update's output is differentiable in x, as flax's; cap 2 below
    the batch of 3 (alpha = 3 / 2, the reference's formula)."""
    x = _normal(21, (3, 4))
    jm = getattr(jstream, name)(cap=2)
    state = jax.jit(lambda k, a: jm.init(k, a, training=True))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    tm = getattr(nt.layers, name)((4,), cap=2, device='cpu')
    _grads_vs_jax(lambda a: tm(a, training=True),
                  lambda a: jm.apply(state, a, training=True,
                                     mutable=['stream_stats'])[0], [x])
    # on the one-process 1 x 1 mesh the sums over 'data' are the identity
    # (the gloo ranks: tests/test_torch_parallel.py)
    nt.parallel.create_mesh(device='cpu')
    for cls in (nt.layers.MeanStream, nt.layers.CovStream):
        plain, dp = cls((4,), cap=2, device='cpu'), cls(
            (4,), cap=2, axis_name='data', device='cpu')
        for _ in range(2):
            assert torch.equal(plain(torch.from_numpy(x), training=True),
                               dp(torch.from_numpy(x), training=True))
        for (n, a), (_, b) in zip(plain.named_buffers(), dp.named_buffers()):
            assert torch.equal(a, b), n
