"""
The PyTorch port's UNet with `space_to_depth` and with `remat`, against the
flax UNet of the JAX package and against itself, at 16^3 with 2-3 levels.

Parameters go across by `convert`; the flax model runs its own remat
(`nn.remat` over ConvEnc and ConvDec). Dropout masks come from JAX keys in
one package and torch generators in the other, so the comparisons with flax
run without dropout, and remat=True is held against the port's own
remat=False with dropout and BatchNorm: the same loss, gradients, running
statistics and generator state, bit for bit.
Tolerances, float32: predictions rtol 1e-5 / atol 1e-6 and losses rtol
1e-5 (the convs sum in another order), gradients within 1e-4 and atol 1e-5
of each tensor's largest magnitude, as `tests/test_torch_training.py`.
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

BASE = dict(nb_features=4, conv_size=3, nb_labels=3, feat_mult=2,
            nb_conv_per_level=2)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _batch(seed, ishape, nb_labels=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, *ishape)).astype(np.float32)
    y = np.eye(nb_labels, dtype=np.float32)[
        rng.integers(0, nb_labels, size=(1, *ishape[:-1]))]
    return x, y


def _grads_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for p, g in got.items():
        scale = np.abs(want[p]).max()
        np.testing.assert_allclose(g, want[p], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg='/'.join(p))


# name -> (constructor, overrides, input shape, batch_norm training)
S2D = {
    'unet_3d': ('unet', dict(nb_levels=3), (16, 16, 16, 1), False),
    'unet_2d_sigmoid': ('unet', dict(nb_levels=2,
                                     final_pred_activation='sigmoid'),
                        (16, 16, 2), False),
    'dilation_net_bn': ('dilation_net', dict(nb_levels=2, batch_norm=-1),
                        (16, 16, 16, 1), True),
}


@pytest.mark.parametrize('name', sorted(S2D))
def test_space_to_depth_matches_flax(name):
    """The forward, then one SoftDice Adam step (1e-3)."""
    ctor, kw, ishape, bn = S2D[name]
    args = {**BASE, **kw, 'input_shape': ishape, 'space_to_depth': 2}
    jm = getattr(ne.models, ctor)(**args)
    tm = getattr(nt.models, ctor)(device='cpu', **args,
                                  generator=torch.Generator().manual_seed(7))
    assert tm.enc.conv_downarm_0_0.weight.shape[1] == ishape[-1] * 2 ** (
        len(ishape) - 1)
    x, y = _batch(0, ishape)
    params = convert.to_flax_params(tm)
    stats = convert.to_flax_params(tm, 'batch_stats')
    variables = {'params': params, **({'batch_stats': stats} if bn else {})}
    assert _leaves(params).keys() == _leaves(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x))['params']).keys()

    yj = jax.jit(jm.apply)(variables, jnp.asarray(x))
    yt = tm(torch.from_numpy(x), training=False)
    assert tuple(yt.shape) == (1, *ishape[:-1], 3)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-6)

    jloss = ne.losses.SoftDice().loss

    def loss_fn(p):
        out = jm.apply({**variables, 'params': p}, x, training=True,
                       mutable=['batch_stats'] if bn else False)
        return jloss(y, out[0] if bn else out)

    lj, gj = jax.jit(jax.value_and_grad(loss_fn))(params)
    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(m['loss']), float(lj), rtol=1e-5)
    gt = convert.to_flax_params(tm, grad=True)
    _grads_close(gt, gj)
    # Adam from the port's own gradients (as tests/test_torch_training.py)
    tx = optax.adam(1e-3)

    @jax.jit
    def adam_step(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    want = _leaves(adam_step(gt, params))
    for p, v in _leaves(convert.to_flax_params(tm)).items():
        np.testing.assert_allclose(v, want[p], rtol=1e-6, atol=1e-8,
                                   err_msg='/'.join(p))


@pytest.mark.parametrize('nb_levels', [2, 3])
def test_remat_matches_flax_remat(nb_levels):
    """remat=True with BatchNorm in training against flax remat=True: the
    loss, every gradient and the BatchNorm running statistics."""
    args = {**BASE, 'nb_levels': nb_levels, 'batch_norm': -1,
            'input_shape': (16, 16, 16, 1), 'remat': True}
    jm = ne.models.unet(**args)
    tm = nt.models.unet(device='cpu', **args,
                        generator=torch.Generator().manual_seed(2))
    x, y = _batch(1, (16, 16, 16, 1))
    params = convert.to_flax_params(tm)
    stats = convert.to_flax_params(tm, 'batch_stats')
    jloss = ne.losses.SoftDice().loss

    def loss_fn(p):
        out, upd = jm.apply({'params': p, 'batch_stats': stats}, x,
                            training=True, mutable=['batch_stats'])
        return jloss(y, out), upd['batch_stats']

    (lj, sj), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    step = training.make_train_step(nt.losses.SoftDice().loss)
    state = training.create_train_state(tm, training.adam(1e-3))
    state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(m['loss']), float(lj), rtol=1e-5)
    _grads_close(convert.to_flax_params(tm, grad=True), gj)
    st = _leaves(convert.to_flax_params(tm, 'batch_stats'))
    for p, v in _leaves(sj).items():
        # batch mean/var over up to 4096 voxels in another order
        np.testing.assert_allclose(st[p], v, rtol=1e-5, atol=1e-7,
                                   err_msg='/'.join(p))


@pytest.mark.parametrize('s2d', [1, 2])
def test_remat_equals_no_remat_with_dropout_and_batch_norm(s2d):
    """The port's remat=True against its remat=False from the same weights
    and generator: the recomputation draws the same dropout masks without
    advancing the generator again, and updates the running statistics
    once."""
    runs = {}
    x, y = _batch(2, (16, 16, 16, 1))
    for remat in (False, True):
        tm = nt.models.unet(device='cpu', **BASE, nb_levels=3,
                            input_shape=(16, 16, 16, 1), conv_dropout=.3,
                            batch_norm=-1, remat=remat, space_to_depth=s2d,
                            generator=torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(11)
        state = training.create_train_state(tm, training.adam(1e-3))
        step = training.make_train_step(nt.losses.SoftDice().loss)
        losses = []
        for _ in range(2):
            state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)),
                            gen)
            losses.append(m['loss'])
        runs[remat] = (torch.stack(losses),
                       {n: p.grad.clone() for n, p in tm.named_parameters()},
                       {n: b.clone() for n, b in tm.named_buffers()},
                       {n: p.detach().clone()
                        for n, p in tm.named_parameters()},
                       gen.get_state(), tm)
    (la, ga, ba, pa, sa, ma), (lb, gb, bb, pb, sb, mb) = runs[False], \
        runs[True]
    assert torch.equal(la, lb)
    for a, b in ((ga, gb), (ba, bb), (pa, pb)):
        assert a.keys() == b.keys()
        for n in a:
            assert torch.equal(a[n], b[n]), n
    assert torch.equal(sa, sb)
    # eval and no-grad calls run the plain forward
    with torch.no_grad():
        assert torch.equal(ma(torch.from_numpy(x), training=False),
                           mb(torch.from_numpy(x), training=False))
    # the dropout draws something: another generator, another loss
    state = training.create_train_state(mb, training.adam(1e-3))
    _, m = training.make_train_step(nt.losses.SoftDice().loss)(
        state, (torch.from_numpy(x), torch.from_numpy(y)),
        torch.Generator().manual_seed(12))
    assert float(m['loss']) != float(lb[-1])
