"""The lc-head-train cell's own pieces: the K7-K9 yardsticks and the
configuration's counts at 160^3, the plain reference and its driver free of
the program and of JAX, and the comparison that decides `correct` at 16^3
on the CPU against the cell's own limits: a sound run passes; the float8
control and a step that leaves the head's kernel unchanged fail."""

import math
import os
import subprocess
import sys
import time

import pytest

from h100bench import compare, harness

CELL = 'lc-head-train'
SMALL = {'config': {'shape': [16, 16, 16]}}


def _family():
    from h100bench.models import lc_head
    bench = harness.benchmark()
    conf = next(c for c in bench['configs'] if c['name'] == 'lc-head')
    return lc_head.Family(harness.load_json(os.path.join(harness.ROOT,
                                                         conf['file'])),
                          'cpu')


@pytest.mark.parametrize('op,ms', [('lc_fwd', 0.2755), ('lc_dk', 0.2788),
                                   ('lc_dx', 0.2755)])
def test_yardsticks_are_chip_smoke_s_bounds(op, ms):
    """At 160^3 in bfloat16 each of K7, K8 and K9 moves about 0.92 GB:
    `chip_smoke.py`'s bound_ms of the head, to its four decimals."""
    fam = _family()
    call, = fam.step_ops()[op]
    mod = harness.load_module(os.path.join(harness.HERE, 'ops', op,
                                           'bound.py'), f'op_{op}')
    nbytes, flops = mod.bound(call)
    peaks = harness.load_json(os.path.join(harness.HERE, 'peaks.json'))
    assert round(1e3 * nbytes / peaks['hbm_bytes_per_s'], 4) == ms
    assert 1e3 * flops / peaks['f32_flop_per_s'] < ms / 10   # bytes bind


def test_configuration_counts():
    fam = _family()
    shapes = fam.param_shapes()
    n = sum(math.prod(s) for s, _ in shapes.values())
    assert n == 446507532
    assert shapes['lc.kernel'][0] == (1, 108, 160 ** 3)
    v = [160 ** 3 // 8 ** lvl for lvl in range(3)]
    trunk = (2 * 27 * (1 * 8 * v[0] + 8 * 16 * v[1] + 16 * 32 * v[2])
             + 2 * 27 * ((16 + 32) * 16 * v[1] + (8 + 16) * 8 * v[0])
             + 2 * 8 * 4 * v[0])
    assert fam.forward_flops() == trunk + 2 * 108 * v[0]
    ops = fam.step_ops()
    assert [c['shape'] for c in ops['pool_fwd']] == [[1, 160, 160, 160, 8],
                                                     [1, 80, 80, 80, 16]]
    assert ops['pool_fwd'][0]['itemsize'] == 2


LOADS = r'''
import sys
sys.path.insert(0, {root!r})
import h100bench.reference.lc, h100bench.drivers.train_stored
from h100bench import harness
print(','.join(harness.forbidden_modules()) or 'none')
print(any(m.split('.')[0] == 'neurite_tpu_torch' for m in sys.modules))
'''


def test_reference_and_driver_load_neither_the_port_nor_jax(tmp_path):
    out = subprocess.run([sys.executable, '-c',
                          LOADS.format(root=harness.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ['none', 'False']


def test_sound_run_is_correct():
    r = harness.run(CELL, 2 ** 31 + 21, 0.3, 0, 'cpu', time.time(),
                    overrides=SMALL, log=lambda s: None)
    assert r['correct'], r['compared']


def test_fp8_control_is_not_correct():
    """The reference with float8 e4m3 operands in the program's place
    fails head_grad_diff's limit (the norms' gaps need not: see
    `drivers/train_stored.py`)."""
    from h100bench.drivers import train, train_stored
    cell = harness.Cell(CELL, 2 ** 31 + 22, False, 'cpu', overrides=SMALL)
    drv = cell.driver()
    drv.source = train.source(cell)
    numbers = train_stored.numbers(drv.reference('fp8'), drv.reference())
    ok, compared = compare.verdict(numbers, cell.limits)
    assert not ok, compared
    diff = compared['head_grad_diff']
    assert diff['value'] > diff['limit'], compared


def test_head_left_unchanged_is_not_correct(monkeypatch):
    """A step whose head kernel keeps its weights (Adam's state and the
    rest of the model as they are): its update reads 0 against the
    reference's, a gap of 1."""
    import torch
    import neurite_tpu_torch as nt
    real = nt.training.make_train_step

    def frozen_head(loss_fn, **kw):
        step = real(loss_fn, **kw)

        def run(state, batch, generator=None):
            k0 = state.model.lc.kernel.detach().clone()
            state, m = step(state, batch, generator)
            with torch.no_grad():
                state.model.lc.kernel.copy_(k0)
            return state, m
        return run
    monkeypatch.setattr(nt.training, 'make_train_step', frozen_head)
    r = harness.run(CELL, 2 ** 31 + 23, 0.3, 0, 'cpu', time.time(),
                    overrides=SMALL, log=lambda s: None)
    assert not r['correct']
    assert r['compared']['update_gap']['value'] == pytest.approx(1.0)


def test_traced_run_reads_the_cells_metrics():
    """A traced run at 16^3 on the CPU reports the cell's seven metrics and
    no others: those the CPU can read (the spans are found, with no device
    events under them; the rooflines and the memory peak need the card),
    and its check passes."""
    r = harness.run(CELL, 2 ** 31 + 14, 0.3, 1, 'cpu', time.time(),
                    overrides=SMALL, log=lambda s: None)
    names = {m['name'] for m in harness.benchmark()['per_layer']
             if CELL in m.get('workloads', [])}
    assert len(names) == 7
    assert {'lchead.lc_ms', 'lchead.optimizer_ms',
            'lchead.device_idle'} <= set(r['metrics']) <= names
    assert r['correct'], r['compared']
