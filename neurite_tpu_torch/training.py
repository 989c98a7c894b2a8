"""
Training loop support: train state, train/eval steps, and a `fit` loop
with hooks.

Counterpart of `neurite_tpu/training.py:23-158`. The JAX step is a pure
function of an immutable state; here the state holds the model and its
optimizer, and a step updates both in place (parameters, Adam moments and
BatchNorm running statistics) and returns the same state object.
"""

import time

import numpy as np
import torch


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam counterpart: a factory params -> torch.optim.Adam. Its
    update is optax's m_hat / (sqrt(v_hat) + eps), up to rounding."""
    def make(params):
        return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                                eps=eps)
    return make


class TrainState:
    """Step counter + model (parameters and buffers) + optimizer."""

    def __init__(self, model, optimizer, step=0):
        self.model = model
        self.optimizer = optimizer
        self.step = step


def create_train_state(model, tx):
    """Wrap an initialised model and an optimizer made by `tx(params)`
    (e.g. `adam(1e-3)`) in a TrainState."""
    return TrainState(model, tx(model.parameters()))


def _split(batch):
    return batch if isinstance(batch, (tuple, list)) else (batch['x'], batch['y'])


def make_train_step(loss_fn):
    """
    Build a train step: step(state, batch, generator) -> (state,
    {'loss': 0-d tensor}).

    loss_fn(y_true, y_pred) -> scalar loss, where y_pred is the model output
    for batch['x'] (or batch[0]). `generator` draws dropout masks. The loss
    stays on the device (no host sync); the step's gradients stay in the
    parameters' `.grad` until the next step.
    """

    def step(state, batch, generator=None):
        x, y = _split(batch)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(y, model(x, training=True, generator=generator))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {'loss': loss.detach()}

    return step


def make_eval_step(metric_fns):
    """Build an eval step computing a dict of metrics, without gradients."""

    def step(state, batch):
        x, y = _split(batch)
        model = state.model
        model.eval()
        with torch.no_grad():
            out = model(x, training=False)
            return {name: fn(y, out) for name, fn in metric_fns.items()}

    return step


def step_generator(seed, step, device):
    """The generator of global step `step`: seeded from (seed, step), so a
    resumed run draws what the uninterrupted run drew."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def fit(state, train_step, data_iter, nb_steps, seed=0, callbacks=(),
        log_every=0, start_step=0):
    """
    Host-side fit loop: pulls batches, invokes the step, and runs callback
    hooks (counterpart of the JAX `fit`).

    Callbacks implement any of: on_train_begin(state), on_batch_end(step,
    state, logs), on_train_end(state). Hook exceptions propagate.

    The step of global index start_step + i draws its randomness from
    `step_generator(seed, start_step + i, device)`.
    """
    device = next(state.model.parameters()).device
    for cb in callbacks:
        if hasattr(cb, 'on_train_begin'):
            cb.on_train_begin(state)

    history = []
    t0 = time.time()
    for i in range(nb_steps):
        batch = next(data_iter)
        state, metrics = train_step(
            state, batch, step_generator(seed, start_step + i, device))

        if callbacks or log_every:
            logs = {k: float(v) for k, v in metrics.items()}
            logs['time'] = time.time() - t0
            history.append(logs)
            for cb in callbacks:
                if hasattr(cb, 'on_batch_end'):
                    cb.on_batch_end(i, state=state, logs=logs)
            if log_every and (i % log_every == 0):
                print(f'step {i}: ' + ', '.join(
                    f'{k}={v:.5g}' for k, v in logs.items()))

    for cb in callbacks:
        if hasattr(cb, 'on_train_end'):
            cb.on_train_end(state)

    return state, history
