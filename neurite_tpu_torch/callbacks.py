"""
Training-loop hooks (callbacks).

Counterpart of `neurite_tpu/callbacks.py` (reference
`neurite/tf/callbacks.py`, cites per class), for the port's
`training.fit`: a hook receives the step index, the TrainState (model,
optimizer, step) and the logs dict. Predictions run the model in eval mode
without gradients and put it back in its former mode.
"""

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from neurite_tpu_torch import backend, modelio, training


def _due(at_batch_end, batch):
    return bool(at_batch_end) and (batch + 1) % at_batch_end == 0


def _predict(state, x, apply_fn=None):
    """apply_fn(state, x), or the state's model on x (moved to its device)
    in eval mode without gradients."""
    if apply_fn is not None:
        return apply_fn(state, x)
    model = state.model
    x = torch.as_tensor(x, device=next(model.parameters()).device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(x, training=False)
    finally:
        model.train(was_training)


class ModelWeightCheck:
    """
    Raise on NaN or infinite parameters; optionally log the largest weight
    change since the last check as 'max_diff'. Parity: reference
    `callbacks.py:39-90`. One fused finiteness reduction over the
    parameters, read once.
    """

    def __init__(self, weight_diff=False, at_batch_end=1, at_epoch_end=True):
        self.at_batch_end = at_batch_end
        self.weight_diff = weight_diff
        self.wts = None

    def on_batch_end(self, batch, state=None, logs=None):
        if _due(self.at_batch_end, batch):
            self._check(state, logs)

    def on_train_end(self, state):
        self._check(state, None)

    def _check(self, state, logs):
        params = [p.detach() for p in state.model.parameters()]
        if not bool(training._all_finite(params).all()):
            raise FloatingPointError('Found nan/infinite weights in model')
        if self.weight_diff:
            wts = [backend.to_numpy(w) for w in params]
            diff = -np.inf
            if self.wts is not None:
                for w, pw in zip(wts, self.wts):
                    diff = np.maximum(diff, np.max(np.abs(w - pw)))
            self.wts = wts
            if logs is not None:
                logs['max_diff'] = diff


class CheckLossTrend:
    """
    Sliding-window loss-spike detector: warn beyond nb_std_err standard
    errors, raise when the loss exceeds the window mean by 100 times its
    magnitude. Parity: reference `callbacks.py:93-147`.
    """

    def __init__(self, at_batch_end=1, nb_std_err=2, loss_window=10):
        self.at_batch_end = at_batch_end
        self.nb_std_err = nb_std_err
        self.loss_window = loss_window
        self.losses = []

    def on_batch_end(self, batch, state=None, logs=None):
        if not _due(self.at_batch_end, batch):
            return
        loss = logs['loss']
        if len(self.losses) < self.loss_window:
            self.losses = [*self.losses, loss]
            return
        losses_mean = np.mean(self.losses)
        losses_std = np.std(self.losses)
        if loss > losses_mean + self.nb_std_err * losses_std:
            print(f'Found loss {loss}, which is much higher than '
                  f'{losses_mean} + {losses_std}', file=sys.stderr)
        # the reference's `loss - mean > mean * 100` (`callbacks.py:141-144`)
        # misfires for negative losses (soft Dice): compare magnitudes
        if (loss - losses_mean) > (abs(losses_mean) * 100):
            raise ValueError(f'Found loss {loss}, which is much higher '
                             f'than {losses_mean} * 100')
        self.losses = [*self.losses[1:], loss]


class TimeHistory:
    """Record per-step wall times (ref `callbacks.py:610-628`)."""

    def on_train_begin(self, state):
        self.times = []
        self._t0 = time.time()

    def on_batch_end(self, batch, state=None, logs=None):
        t = time.time()
        self.times.append(t - self._t0)
        self._t0 = t


class LRLog:
    """Put the current learning rate into the logs as 'lr': schedule(step)
    when a schedule is given, else the optimizer's first parameter group's
    (ref `callbacks.py:631-641`)."""

    def __init__(self, schedule=None):
        self.schedule = schedule

    def on_batch_end(self, batch, state=None, logs=None):
        if logs is None:
            return
        if self.schedule is not None:
            logs['lr'] = float(self.schedule(int(state.step)))
        else:
            logs['lr'] = float(state.optimizer.param_groups[0]['lr'])


class ModelCheckpoint:
    """
    Periodic saves, optionally of the best monitored value only. Parity:
    reference `callbacks.py:349-481`, saving through `modelio.save_model`
    (config, variables, and the optimizer state and step, so a run resumes
    from it). `filepath` is formatted with the step and the scalar logs.
    """

    def __init__(self, filepath, monitor='loss', save_best_only=False,
                 mode='min', at_batch_end=None, verbose=False, config=None):
        self.filepath = filepath
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.at_batch_end = at_batch_end
        self.verbose = verbose
        self.config = config or {}
        self.best = np.inf if mode == 'min' else -np.inf
        self.mode = mode

    def _better(self, value):
        return value < self.best if self.mode == 'min' else value > self.best

    def _save(self, path, state):
        modelio.save_model(path, state.model, self.config, step=state.step,
                           train_state=state)
        if self.verbose:
            print(f'saved checkpoint to {path}')

    def on_batch_end(self, batch, state=None, logs=None):
        if not _due(self.at_batch_end, batch):
            return
        logs = logs or {}
        value = logs.get(self.monitor)
        if self.save_best_only and value is not None:
            if not self._better(value):
                return
            self.best = value
        self._save(self.filepath.format(
            step=int(state.step),
            **{k: v for k, v in logs.items() if np.isscalar(v)}), state)

    def on_train_end(self, state):
        if self.at_batch_end is None:
            self._save(self.filepath.format(step=int(state.step)), state)


class PredictMetrics:
    """
    Run metric functions over samples of a validation iterator of
    (x, y_true): write one CSV per metric (`filepath` formatted with the
    step and the metric's name), or with no filepath put
    '<metric>_label_<id>' into the logs. Parity: reference
    `callbacks.py:250-346`. `apply_fn(state, x)` replaces the model's own
    eval-mode prediction.
    """

    def __init__(self, filepath, metrics, data_generator, nb_samples,
                 nb_labels, apply_fn=None, label_ids=None, vol_params=None,
                 at_batch_end=None, period=1, verbose=False):
        self.filepath = filepath
        self.metrics = metrics
        self.data_generator = data_generator
        self.nb_samples = nb_samples
        self.nb_labels = nb_labels
        self.apply_fn = apply_fn
        self.label_ids = label_ids or list(range(nb_labels))
        self.vol_params = vol_params
        self.at_batch_end = at_batch_end
        self.period = period
        self.verbose = verbose

    def on_batch_end(self, batch, state=None, logs=None):
        if _due(self.at_batch_end, batch):
            self._run(state, int(state.step), logs)

    def on_train_end(self, state):
        if self.at_batch_end is None:
            self._run(state, int(state.step), None)

    def _run(self, state, step, logs):
        met = np.zeros((self.nb_samples, self.nb_labels, len(self.metrics)))
        for i in range(self.nb_samples):
            x, y_true = next(self.data_generator)
            y_pred = _predict(state, x, self.apply_fn)
            y_true = torch.as_tensor(y_true, device=y_pred.device)
            for idx, metric in enumerate(self.metrics):
                val = backend.to_numpy(metric(y_true, y_pred))
                met[i, :, idx] = np.mean(val.reshape(-1, self.nb_labels), 0) \
                    if val.size >= self.nb_labels else val
        if self.filepath is not None:
            for idx, metric in enumerate(self.metrics):
                filen = self.filepath.format(
                    step=step, metric=getattr(metric, '__name__', f'm{idx}'))
                np.savetxt(filen, met[:, :, idx], fmt='%f', delimiter=',')
        elif logs is not None:
            meanmet = np.nanmean(met, axis=0)
            for midx, metric in enumerate(self.metrics):
                name = getattr(metric, '__name__', f'm{midx}')
                for idx in range(self.nb_labels):
                    logs[f'{name}_label_{self.label_ids[idx]}'] = \
                        meanmet[idx, midx]


class PlotTestSlices:
    """
    Save a figure of the input's and the argmax prediction's middle slices
    of the first item of a generator batch every `at_batch_end` steps
    (`savefilepath` formatted with the step). Parity: reference
    `callbacks.py:150-247`, drawn with `neurite_tpu_torch.plot.slices`
    (matplotlib, Agg backend, imported here only).
    """

    def __init__(self, savefilepath, generator, vol_size, at_batch_end=None,
                 apply_fn=None, verbose=False):
        self.savefilepath = savefilepath
        self.generator = generator
        self.vol_size = vol_size
        self.at_batch_end = at_batch_end
        self.apply_fn = apply_fn
        self.verbose = verbose

    def on_batch_end(self, batch, state=None, logs=None):
        if not _due(self.at_batch_end, batch):
            return
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from neurite_tpu_torch.py import plot

        x, _ = next(self.generator)
        pred = backend.to_numpy(_predict(state, x, self.apply_fn))
        x = backend.to_numpy(x)
        # middle slices of the first item: input, argmax prediction
        item_x, item_p = x[0, ..., 0], np.argmax(pred[0], -1)
        if item_x.ndim == 3:
            mid = item_x.shape[-1] // 2
            item_x, item_p = item_x[..., mid], item_p[..., mid]
        fig, _ = plot.slices([item_x, item_p], show=False)
        fig.savefig(self.savefilepath.format(step=int(state.step)))
        plt.close(fig)


class ModelCheckpointParallel(ModelCheckpoint):
    """
    Reference `ModelCheckpointParallel` (`callbacks.py:484-607`) unwrapped
    keras multi-GPU replicas before saving. Under data parallelism
    (`parallel.make_sharded_train_step`) every rank holds the same
    replicated state, so only rank 0 of the process group writes, once, as
    JAX's single controller does; without a process group this is
    `ModelCheckpoint`.
    """

    def _save(self, path, state):
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        super()._save(path, state)
