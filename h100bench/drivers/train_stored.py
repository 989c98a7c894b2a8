"""
Training traffic for a configuration that stores some parameters in
bfloat16: `drivers/train.py`'s closed loop, set-up, windows and readings as
they are, with the plain reference's steps changed and one number more.

The reference's arithmetic stays float32, with TF32 off, and Adam's
moments stay float32. But after each reference update every parameter that
the configuration stores in bfloat16 (those the family's weights hold in
bfloat16: config #3's LocallyConnected3D kernel and bias) is rounded to
bfloat16, as the program's parameter is.

Why: in Adam's first steps each weight moves by about the learning rate.
A bfloat16 weight whose half-ulp exceeds that step does not move at all:
at config #3's lr 1e-4, every |w| >= 2^-5, about three quarters of its
head, whose kernel has SD 1/sqrt(108). A reference that kept the head in
float32 would move every weight, so the program's head update would read
about half of the reference's. A limit loose enough to pass that could
not tell the program from one that drops the head's update.

The numbers compared are `compare.train_numbers`'s and one more,
head_grad_diff: over the stored leaves, the largest norm of the program's
first gradient (Adam's m / (1 - b1) after step 1) less the reference's,
over the reference's norm. The norms alone cannot tell a float8 trunk from
a bfloat16 one here: each norm sums a leaf's rounding away (config #3 at
160^3 on an H100: 24 sound seeds read grad_gap up to 0.0136, float8
controls from 0.0178), while the difference keeps it (head_grad_diff
0.0058-0.0103 against 0.079-0.137). `numbers` gives all four from two
readings, the program's or a control's.
"""

import torch

from h100bench import compare
from h100bench.drivers import train


class Driver(train.Driver):
    def first_steps(self):
        """`train.Driver.first_steps`, and the stored leaves' first gradient
        kept on the host (the window's memory stays the program's own)."""
        step, named = self.step, dict(self.state.model.named_parameters())
        strip = len(self.cell.family.prefix)
        kept = {}

        def first(state, batch):
            state, m = step(state, batch)
            self.step = step
            b1 = state.optimizer.defaults['betas'][0]
            st = state.optimizer.state
            for k, p in named.items():
                if p.dtype == torch.bfloat16:
                    kept[k[strip:]] = (st[p]['exp_avg'] / (1 - b1)).cpu()
            return state, m
        self.step = first
        return dict(super().first_steps(), first_grad=kept)

    def numbers(self, ref):
        return numbers(self.reading, ref)

    def reference(self, precision='f32'):
        """The reference's reading of the same three steps, the stored
        parameters rounded after each."""
        fam = self.cell.family
        rows = [self.source.reference_row(k) for k in range(train.READ_STEPS)]
        return reference_steps(fam, fam.weights(self.cell.weight_seed), rows,
                               self.lr, precision)


def reference_steps(fam, weights, rows, lr, precision='f32'):
    """{'losses', 'grad', 'update'} of plain float32 Adam steps on `rows`
    from `weights`, with TF32 off, 'params', the parameters after the
    last step (float32), and 'first_grad', the first gradient of the
    parameters whose weights are bfloat16; after each update those are
    rounded to bfloat16."""
    from h100bench.reference.adam import Adam
    stored = [k for k, v in weights.items() if v.dtype == torch.bfloat16]
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = {k: v.detach().float().requires_grad_(True)
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
                first = {k: g[k].detach().clone() for k in stored}
            opt.step(g)
            with torch.no_grad():
                for k in stored:
                    params[k].copy_(params[k].to(torch.bfloat16))
            losses.append(float(loss.detach()))
        update = {k: compare.norm(params[k].detach() - p0[k]) for k in params}
        return {'losses': losses, 'grad': grad, 'update': update,
                'params': {k: v.detach() for k, v in params.items()},
                'first_grad': first}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
            = flags


def numbers(prog, ref):
    """`compare.train_numbers` and head_grad_diff of two readings that
    carry 'first_grad'."""
    out = compare.train_numbers(prog, ref)
    out['head_grad_diff'] = max(
        compare.norm(prog['first_grad'][k].to(v.device, torch.float32) - v)
        / compare.norm(v) for k, v in ref['first_grad'].items())
    return out
