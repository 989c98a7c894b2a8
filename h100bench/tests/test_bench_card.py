"""On the card: one short run of each cell through the benchmark's
command, its result line well formed and correct. Skips without a
card."""

import json
import os
import subprocess
import sys

import pytest

from h100bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize('workload', [w['name'] for w in
                                      harness.benchmark()['workloads']])
def test_cell_runs_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, 'run.py'), '--workload',
         workload, '--seed', str(2 ** 31 + 99), '--seconds', '3',
         '--trace', '0'], capture_output=True, text=True, timeout=900,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r['correct'] and r['device']['platform'] == 'gpu'
    assert list(r)[-1] == 'compared'
