"""
The PyTorch port's training step (`neurite_tpu_torch.training`) against the
JAX package's: from identical weights, one step's loss and every parameter
gradient must match `jax.value_and_grad`, and one Adam update must match
optax's; `fit` must lower the loss.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert, training  # noqa: E402

torch.set_num_threads(1)

CFG = dict(nb_features=4, input_shape=(16, 16, 16, 1), nb_levels=3,
           conv_size=3, nb_labels=3, feat_mult=2, nb_conv_per_level=2)


def _batch(seed, vol=16, nb_labels=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, vol, vol, vol, 1)).astype(np.float32)
    y = np.eye(nb_labels, dtype=np.float32)[
        rng.integers(0, nb_labels, size=(1, vol, vol, vol))]
    return x, y


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_train_step_matches_jax_grads_and_adam():
    tm = nt.models.unet(**CFG, generator=torch.Generator().manual_seed(0))
    params = convert.to_flax_params(tm)
    jm = ne.models.unet(**CFG)
    x, y = _batch(1)
    jloss = ne.losses.SoftDice().loss

    @jax.jit
    def value_and_grad(p):
        return jax.value_and_grad(
            lambda q: jloss(y, jm.apply({'params': q}, x, training=True)))(p)

    lj, gj = value_and_grad(params)

    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    state, metrics = step(state, (torch.from_numpy(x), torch.from_numpy(y)),
                          torch.Generator().manual_seed(0))
    loss = metrics['loss']
    assert isinstance(loss, torch.Tensor) and loss.ndim == 0
    assert state.step == 1
    # rtol 1e-5: same f32 math, convs and sums in another order
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)

    gt = convert.to_flax_params(tm, grad=True)
    gjl = _leaves(gj)
    assert _leaves(gt).keys() == gjl.keys()
    for p, g in _leaves(gt).items():
        # rtol 1e-4 and atol 1e-5 of the tensor's largest gradient: each
        # entry sums over 16^3 voxels in another order, and entries near
        # zero carry the absolute error of their larger neighbours
        scale = np.abs(gjl[p]).max()
        np.testing.assert_allclose(g, gjl[p], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg='/'.join(p))

    # Adam: hand optax the port's own gradients, so that entries with |g|
    # near eps (where Adam's first step, ~lr*sign(g), is unstable) compare
    # like with like; the updates then agree to float32 rounding
    tx = optax.adam(1e-3)
    upd, _ = tx.update(gt, tx.init(params), params)
    want = _leaves(optax.apply_updates(params, upd))
    for p, v in _leaves(convert.to_flax_params(tm)).items():
        np.testing.assert_allclose(v, want[p], rtol=1e-6, atol=1e-8,
                                   err_msg='/'.join(p))


def test_fit_lowers_loss_and_runs_hooks():
    tm = nt.models.unet(**{**CFG, 'input_shape': (8, 8, 8, 1)},
                        generator=torch.Generator().manual_seed(1))
    state = training.create_train_state(tm, training.adam(3e-3))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    # labels that the image determines (intensity bands), so a few steps
    # on the one batch must raise the Dice
    x, _ = _batch(2, vol=8)
    y = np.eye(3, dtype=np.float32)[(x[..., 0] > -.5).astype(int)
                                    + (x[..., 0] > .5)]
    batch = (torch.from_numpy(x), torch.from_numpy(y))

    class Hooks:
        calls = []

        def on_train_begin(self, state):
            self.calls.append('begin')

        def on_batch_end(self, i, state, logs):
            self.calls.append(i)

        def on_train_end(self, state):
            self.calls.append('end')

    hooks = Hooks()
    state, history = training.fit(state, step, iter([batch] * 3), 3,
                                  callbacks=[hooks])
    assert hooks.calls == ['begin', 0, 1, 2, 'end']
    losses = [h['loss'] for h in history]
    assert state.step == 3 and all(np.isfinite(losses))
    assert losses[0] > losses[1] > losses[2]

    evaluate = training.make_eval_step(
        {'dice': nt.metrics.SoftDice().mean_dice})
    out = evaluate(state, {'x': batch[0], 'y': batch[1]})
    assert 0. < float(out['dice']) <= 1.
    assert not tm.training


def test_step_generator_and_dropout_are_reproducible():
    g1 = training.step_generator(0, 5, 'cpu')
    g2 = training.step_generator(0, 5, 'cpu')
    g3 = training.step_generator(0, 6, 'cpu')
    a, b, c = (torch.rand(4, generator=g) for g in (g1, g2, g3))
    assert torch.equal(a, b) and not torch.equal(a, c)

    x, y = _batch(3, vol=8)
    losses = []
    for _ in range(2):
        tm = nt.models.unet(**{**CFG, 'input_shape': (8, 8, 8, 1)},
                            conv_dropout=.3,
                            generator=torch.Generator().manual_seed(2))
        state = training.create_train_state(tm, training.adam(1e-3))
        step = training.make_train_step(nt.losses.SoftDice().loss)
        _, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)),
                    training.step_generator(7, 0, 'cpu'))
        losses.append(float(m['loss']))
    assert losses[0] == losses[1]
