"""A traffic mix, a cell and a per-layer metric added as new files and
entries only: a dummy mix loaded from a temporary directory runs through
the unchanged harness, and the new metric reaches the result."""

import json
import time

from h100bench import harness

METRIC = '''
def read(r):
    ms, n = r.trace.span_ms('step')
    return n
'''


def test_new_mix_cell_and_metric_from_files(tmp_path, small):
    (tmp_path / 'traffic').mkdir()
    (tmp_path / 'limits').mkdir()
    (tmp_path / 'layer_metrics').mkdir()
    (tmp_path / 'traffic' / 'dummy-mix.json').write_text(json.dumps(
        {'kind': 'train', 'source': 'memory', 'pairs': 3,
         'warmup_steps': 1, 'trace_steps': 2,
         'rate_metric': 'train_vol_per_s'}))
    (tmp_path / 'limits' / 'dummy-cell.json').write_text(json.dumps(
        {'loss_gap': 0.1, 'grad_gap': 0.1, 'update_gap': 0.2}))
    (tmp_path / 'layer_metrics' / 'dummy.steps.py').write_text(METRIC)
    bench = harness.benchmark()
    bench['workloads'].append({'name': 'dummy-cell', 'config':
                               'unet-flagship', 'traffic': 'dummy-mix',
                               'chips': 1, 'why': 'a test'})
    bench['per_layer'].append({'name': 'dummy.steps', 'unit': 'steps',
                               'better': 'higher', 'source':
                               'program_span', 'layer': 'test',
                               'moves': 'train_vol_per_s',
                               'workloads': ['dummy-cell']})
    for m in bench['end_to_end']:
        if m['name'] == 'train_vol_per_s':
            m['workloads'].append('dummy-cell')
    r = harness.run('dummy-cell', 5, 0.3, 1, 'cpu', time.time(),
                    overrides=small['flagship-train-mem'], bench=bench,
                    files=str(tmp_path), log=lambda s: None)
    assert r['metrics']['dummy.steps']['value'] == 2
    assert 'train.host_ms' not in r['metrics']   # it lists its cells
    assert r['correct']
