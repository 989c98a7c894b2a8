"""
Training loop support: train state, train/eval steps, a `fit` loop with
hooks, a checked step, checkpoints and profiler traces.

Counterpart of `neurite_tpu/training.py`. The JAX step is a pure
function of an immutable state; here the state holds the model and its
optimizer, and a step updates both in place (parameters, Adam moments and
BatchNorm running statistics) and returns the same state object.
"""

import os
import time

import numpy as np
import torch

from neurite_tpu_torch import checkify, trace
from neurite_tpu_torch.ops import adam as ops_adam


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam counterpart: a factory params -> `ops.adam.Adam`, which
    computes `torch.optim.Adam`'s update (optax's m_hat / (sqrt(v_hat) +
    eps), up to rounding) and keeps its state, in one pass of the kernel
    K11 for CUDA parameters. CUDA parameters must be float32 or bfloat16:
    K11 raises on any other dtype, where `torch.optim.Adam` takes it."""
    def make(params):
        return ops_adam.Adam(params, lr=learning_rate, betas=(b1, b2),
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


def make_train_step(loss_fn, has_aux_vars=False, rng_names=('dropout',),
                    axis_name=None):
    """
    Build a train step: step(state, batch, generator) -> (state,
    {'loss': 0-d tensor}).

    loss_fn(y_true, y_pred) -> scalar loss, where y_pred is the model output
    for batch['x'] (or batch[0]). `generator` draws dropout masks. The loss
    stays on the device (no host sync); the step's gradients stay in the
    parameters' `.grad` until the next step.

    has_aux_vars and rng_names keep JAX's signature and change nothing: a
    module's buffers (BatchNorm statistics) update in place whatever
    has_aux_vars says, and one generator serves every random stream.

    With `axis_name` (a dim of the mesh this process made,
    `parallel.create_mesh`), each rank runs the step on its own batch, and
    the gradients and the loss are averaged over that dim's group before
    the optimizer steps (JAX's `lax.pmean`; `training.py:85-87` there).

    Under spatial sharding (`parallel.make_sharded_train_step` on a
    'space' dim above 1) x and y are this rank's blocks; y_true and y_pred
    are gathered whole before `loss_fn` (`parallel.spatial`), so any loss
    sees the whole volume, as it does in JAX's GSPMD step.

    While a profiler records, the step opens the span 'neurite/train/step'
    (its args: `state.step`) around 'train/forward', 'train/loss',
    'train/backward', 'train/grad_mean' (with `axis_name`) and
    'train/optimizer' (`trace.span`).
    """
    del has_aux_vars, rng_names
    from neurite_tpu_torch.parallel import spatial as sharding

    def step(state, batch, generator=None):
        with trace.span('train/step', state.step):
            x, y = _split(batch)
            model = state.model
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            with trace.span('train/forward'):
                pred = model(x, training=True, generator=generator)
            with trace.span('train/loss'):
                if sharding.active() is not None:
                    y, pred = sharding.gather_loss_inputs(y, pred)
                loss = loss_fn(y, pred)
            with trace.span('train/backward'):
                loss.backward()
            if axis_name is not None:
                from neurite_tpu_torch.parallel import mesh
                with trace.span('train/grad_mean'):
                    ax = mesh._axis_group(axis_name)
                    mesh._mean_grads(model.parameters(), ax)
                    loss = mesh._mean_metrics({'loss': loss}, ax)['loss']
            with trace.span('train/optimizer'):
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


def fit(state, train_step, data_iter, nb_steps, rng=None, callbacks=(),
        log_every=0, jit=True, start_step=0, seed=0):
    """
    Host-side fit loop: pulls batches, invokes the step, and runs callback
    hooks (counterpart of the JAX `fit`).

    Callbacks implement any of: on_train_begin(state), on_batch_end(step,
    state, logs), on_train_end(state). Hook exceptions propagate.

    The step of global index start_step + i draws its randomness from
    `step_generator(seed, start_step + i, device)`. The parameters keep
    JAX's order: `rng`, JAX's key, is an integer seed here and, when given,
    takes the place of `seed`; `jit` has no torch meaning (the step runs
    eagerly either way).

    Whenever `callbacks` or `log_every` are set, the logs read each
    metric with `float(v)`: a host sync each step, which waits for the
    step to finish on the device. With neither, the loop reads nothing
    back and the host runs ahead.

    While a profiler records, `annotate_step(start_step + i)` marks each
    step's call, 'neurite/fit/next_batch' spans `next(data_iter)` (the wait
    for the feed) and 'neurite/fit/callbacks' the logs and the callbacks.
    """
    del jit
    if rng is not None:
        seed = int(rng)
    device = next(state.model.parameters()).device
    for cb in callbacks:
        if hasattr(cb, 'on_train_begin'):
            cb.on_train_begin(state)

    history = []
    t0 = time.time()
    for i in range(nb_steps):
        n = start_step + i
        with trace.span('fit/next_batch', n):
            batch = next(data_iter)
        with annotate_step(n):
            state, metrics = train_step(state, batch,
                                        step_generator(seed, n, device))

        if callbacks or log_every:
            with trace.span('fit/callbacks', n):
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


def profile_trace(logdir):
    """
    A `torch.profiler.profile` context over the host and, where there is
    one, the card, that writes a TensorBoard trace (`*.pt.trace.json`) to
    `logdir` when it closes (JAX `training.py:161-168`,
    `jax.profiler.trace`).
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(logdir))


def annotate_step(step_num):
    """A `torch.profiler.record_function` span named after the step, to mark
    steps inside a trace (JAX's `StepTraceAnnotation('train', step_num)`);
    like every span of the port (`trace.span`), the shared no-op while no
    profiler records."""
    if not trace.recording():
        return trace.OFF
    return torch.profiler.record_function(f'train/{step_num}')


def _all_finite(tensors):
    """A boolean vector, one flag a tensor: True where it holds no NaN and
    no infinity. From each tensor's largest magnitude in float32, which a
    NaN or an infinity makes non-finite and finite values never overflow
    (one fused reduction for the list where the device allows; an empty
    tensor, which has no largest magnitude, counts as one zero)."""
    norms = torch._foreach_norm([t if t.numel() else t.new_zeros(1)
                                 for t in tensors], float('inf'),
                                dtype=torch.float32)
    return torch.isfinite(torch.stack(norms))


def make_checked_train_step(loss_fn):
    """
    A train step that also returns the outcome of its checks (JAX
    `training.py:176-197`, checkify): step(state, batch, generator) ->
    (err, (state, metrics)); `err.throw()` raises `checkify.CheckError` when
    a check failed, and `err.get()` gives its message.

    The checks, in this order (the first failure is reported): the range
    checks of losses built with check_input_limits='checkify' (their
    messages as JAX's, `'{name}: value outside range [{lo}, {hi}]'`), then a
    non-finite loss, a non-finite gradient, and a non-finite parameter
    after the update. JAX's float_checks flag the first NaN that any
    operation of the step makes; these flag a non-finite loss, gradient or
    parameter only, a coarser net.

    The step is `make_train_step`'s, run inside `checkify.collect()`;
    nothing in it is read back to the host: the checks are device tensors
    folded into `err.code`, and reading `err` is the one host read. The
    state is updated as `make_train_step` updates it, failed check or not
    (the gradients stay in `.grad`, so they are checked after the update).
    The checks run in the span 'neurite/train/check', after the step's own.
    """
    base = make_train_step(loss_fn)

    def step(state, batch, generator=None):
        with checkify.collect() as recorded:
            state, metrics = base(state, batch, generator)
        with trace.span('train/check', state.step - 1):
            loss = metrics['loss']
            recorded.append((torch.isfinite(loss),
                             'non-finite value in the loss'))
            named = [(n, p) for n, p in state.model.named_parameters()
                     if p.grad is not None]
            if named:
                names, params = zip(*named)
                recorded += zip(_all_finite([p.grad for p in params]).unbind(),
                                [f'non-finite gradient of {n}' for n in names])
                recorded += zip(
                    _all_finite([p.detach() for p in params]).unbind(),
                    [f'non-finite value in {n} after the update'
                     for n in names])
            return checkify.error(recorded, loss.device), (state, metrics)

    return step


def save_checkpoint(path, state, extra=None):
    """
    Save a full training checkpoint to the directory `path` (made if
    needed): the model's parameters and buffers (BatchNorm statistics), the
    optimizer's state (Adam's moments and step counts), `state.step` and
    `extra` (any picklable value, such as a data position), so that
    `restore_checkpoint` resumes exactly (JAX `training.py:200-222`).
    """
    os.makedirs(path, exist_ok=True)
    torch.save({'model': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict(),
                'step': int(state.step), 'extra': extra},
               os.path.join(path, 'state.pt'))


def restore_checkpoint(path, state):
    """
    Load a checkpoint that `save_checkpoint` wrote into `state` (the same
    model and optimizer, on any device) in place. Returns (state, extra).
    """
    # the file holds `extra`, any picklable value save_checkpoint was given
    ckpt = torch.load(os.path.join(path, 'state.pt'), map_location='cpu',
                      weights_only=False)
    state.model.load_state_dict(ckpt['model'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.step = ckpt['step']
    return state, ckpt['extra']
