"""A traced run of each cell on the CPU: it measures the timed window,
then the traced one, reports the cell's per-layer metrics and no others
(the model's share of the peak always, since it reads the timed window),
and its check still passes."""

import time

import pytest

from h100bench import harness

CELLS = [w['name'] for w in harness.benchmark()['workloads']]


@pytest.mark.parametrize('workload', CELLS)
def test_traced_run_reads_the_cells_metrics(workload, small):
    r = harness.run(workload, 2 ** 31 + 14, 0.3, 1, 'cpu', time.time(),
                    overrides=small[workload], log=lambda s: None)
    names = {m['name'] for m in harness.benchmark()['per_layer']
             if workload in m['workloads']}
    assert set(r['metrics']) <= names
    mfu = [n for n in names if n.endswith('.mfu')]
    assert len(mfu) == 1 and r['metrics'][mfu[0]]['value'] > 0
    assert r['device']['window_s'] > 0 and 'breakdown' in r
    assert r['correct'], r['compared']
