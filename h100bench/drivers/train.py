"""
Training traffic: steps back to back (a closed loop) through the
program's `training.make_train_step`, on rows from the traffic's
source (`sources/<source>.py`).

Set-up builds one train state from the harness's weights, drives it
through its first three steps on rows 0, 1, 2 (reading the losses, the
first gradient from Adam's state and, after the third, each leaf's
change), runs `warmup_steps` more, and hands the same state to the
window. The window runs steps until `seconds` have passed on the host's
clock and closes on a `torch.cuda.synchronize()`: the rate, reported
under the traffic's `rate_metric`, is the steps over the window's wall
time. After the window the program's state is freed and the plain
reference follows the same three steps.
"""

import importlib
import time

import torch

from h100bench import compare, trace

READ_STEPS = 3


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.lr = float(cell.family.cfg['adam_lr'])
        self.warmup = int(t['warmup_steps'])
        self.trace_steps = int(t['trace_steps'])
        self.rate_metric = t['rate_metric']
        self.attempted = 0

    def setup(self):
        cell, nt = self.cell, self.cell.nt
        fam = cell.family
        self.source = source(cell)
        model = fam.program(nt, fam.weights(cell.weight_seed))
        self.state = nt.training.create_train_state(model,
                                                    nt.training.adam(self.lr))
        self.step = nt.training.make_train_step(fam.program_loss(nt))
        self.feed = self.source.feed()
        cell.mark('inputs, model and feed')
        self.reading = self.first_steps()
        cell.mark('steps 1-3 read')
        for _ in range(self.warmup):
            self.one()
        cell.sync()
        cell.mark(f'{self.warmup} warm-up steps')

    def one(self):
        self.state, m = self.step(self.state, next(self.feed))
        return m

    def first_steps(self):
        """Steps 1-3 through the window's own call and feed: the losses,
        the first gradient's norms and the change over the three."""
        model = self.state.model
        named = dict(model.named_parameters())
        p0 = {k: p.detach().clone() for k, p in named.items()}
        losses, grad = [], None
        for i in range(READ_STEPS):
            losses.append(float(self.one()['loss']))
            if i == 0:
                b1 = self.state.optimizer.defaults['betas'][0]
                st = self.state.optimizer.state
                grad = {k: compare.norm(st[p]['exp_avg'] / (1 - b1))
                        for k, p in named.items() if p in st}
        update = {k: compare.norm(p.detach() - p0[k])
                  for k, p in named.items()}
        strip = len(self.cell.family.prefix)
        return {'losses': losses,
                'grad': {k[strip:]: v for k, v in grad.items()},
                'update': {k[strip:]: v for k, v in update.items()}}

    # --- windows ------------------------------------------------------------

    def window(self, seconds):
        n = 0
        t0 = time.perf_counter()
        while True:
            self.one()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.cell.sync()
        wall = time.perf_counter() - t0
        self.attempted += n
        return {self.rate_metric: n / wall, 'step_s': wall / n}

    def issue_ms(self, n):
        """Host ms to issue a step into an empty queue, with no profiler: a
        synchronise, then the step's call to its return; the mean of `n`
        steps."""
        total = 0.
        for _ in range(n):
            self.cell.sync()
            t = time.perf_counter()
            self.one()
            total += time.perf_counter() - t
        self.cell.sync()
        self.attempted += n
        return 1e3 * total / n

    def traced_window(self):
        """The traffic's `trace_steps` steps under the profiler, with the
        family's forward hooks on, after as many steps timed for their
        issue cost; (trace, steps, {'issue_ms'})."""
        issue = self.issue_ms(self.trace_steps)
        out = {}
        hooks = self.cell.family.span_hooks(self.state.model)
        with trace.profiled(out):
            with trace.span('window'):
                for _ in range(self.trace_steps):
                    with trace.span('feed'):
                        batch = next(self.feed)
                    with trace.span('step'):
                        self.state, _ = self.step(self.state, batch)
                self.cell.sync()
        for h in hooks:
            h.remove()
        self.attempted += self.trace_steps
        return out['trace'], self.trace_steps, {'issue_ms': issue}

    # --- the check ----------------------------------------------------------

    def free(self):
        self.source.close()
        del self.state, self.step, self.feed

    def reference(self, precision='f32'):
        """The reference's reading of the same three steps."""
        rows = [self.source.reference_row(k) for k in range(READ_STEPS)]
        return reference_steps(self.cell.family,
                               self.cell.family.weights(self.cell.weight_seed),
                               rows, self.lr, precision)

    def numbers(self, ref):
        return compare.train_numbers(self.reading, ref)


def source(cell):
    """The traffic's row source, `sources/<source>.py`."""
    return importlib.import_module(
        f"h100bench.sources.{cell.traffic['source']}").Source(cell)


def reference_steps(fam, weights, rows, lr, precision='f32'):
    """{'losses', 'grad', 'update'} of plain Adam steps on `rows` from
    `weights`, with TF32 off."""
    from h100bench.reference.adam import Adam
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        p0 = {k: v.detach().clone() for k, v in params.items()}
        opt = Adam(params, lr)
        losses, grad = [], None
        for i, (x, y) in enumerate(rows):
            loss = fam.reference_loss(y, fam.reference_forward(params, x,
                                                               precision))
            g = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
            if i == 0:
                grad = {k: compare.norm(v) for k, v in g.items()}
            opt.step(g)
            losses.append(float(loss.detach()))
        update = {k: compare.norm(params[k].detach() - p0[k]) for k in params}
        return {'losses': losses, 'grad': grad, 'update': update}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
            = flags
