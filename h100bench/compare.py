"""
The comparison that decides `correct`: the numbers read from the
program's timed path against the plain reference's, each beside its
limit (`h100bench/limits/<workload>.json`).

Training: the program's first three steps against the reference's three
steps from the same weights and rows. Three numbers:
- loss_gap: the largest |loss - reference loss| / |reference loss| of the
  three steps;
- grad_gap: over the leaves, the largest gap between the norm of the
  program's first gradient (from Adam's first moment after one step,
  m / (1 - b1)) and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
- update_gap: the same for the norm of each leaf's change over the three
  steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both (their Adam steps are round-off).

Serving: prob_gap, the largest |program - reference| of the served
probabilities over a sample of the served volumes.
"""

import math
import statistics

import torch

KEEP_BELOW_MEDIAN = 1e-3


def norm(t):
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def leaf_gap(prog, ref, keep):
    med = statistics.median(ref[k] for k in keep)
    gaps = [abs(prog.get(k, 0.) - ref[k]) / max(ref[k], med) for k in keep]
    return max(gaps)


def train_numbers(prog, ref):
    """{name: value} from two readings {'losses': [3], 'grad': {leaf:
    norm}, 'update': {leaf: norm}}."""
    med = statistics.median(ref['grad'].values())
    keep = [k for k, v in ref['grad'].items() if v >= KEEP_BELOW_MEDIAN * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog['losses'], ref['losses']))
    return {'loss_gap': loss_gap,
            'grad_gap': leaf_gap(prog['grad'], ref['grad'], keep),
            'update_gap': leaf_gap(prog['update'], ref['update'], keep)}


def verdict(numbers, limits):
    """(correct, {name: {'value', 'limit'}}): every number that has a
    limit finite and at most it; a limit without a number fails. A number
    without a limit is read, not compared (loss_gap: no control or fault
    reads three times its sound readings; see PERF.md)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float('nan'))
        out[name] = {'value': v, 'limit': limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, out
