"""
One run of one cell: everything found by name from `BENCHMARK.json` and
the files beside this one.

- the cell: an entry of `workloads` (a configuration and a traffic mix);
- the configuration: the JSON file its entry names; its 'family' names a
  module `models/<family>.py`;
- the traffic mix: `traffic/<traffic>.json`; its 'kind' names a driver
  `drivers/<kind>.py`;
- the limits of the numbers compared: `limits/<workload>.json`;
- a training mix's rows: `sources/<source>.py`;
- a per-layer metric: `layer_metrics/<name>.py`, whose `read(r)` returns
  the number or None (shared readings: `readers.py`);
- a hand-written kernel's yardstick: `ops/<op>/bound.py` (bytes and
  operations of one call) and `ops/<op>/*.json` (the kernel names of each
  implementation);
- the chip's peaks: `peaks.json`.

A later configuration, mix, metric or kernel is new files and entries.
"""

import glob
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'neurite_tpu', 'neurite')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root=ROOT):
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX package or the JAX
    package of this repository."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """A workload's configuration, traffic and metrics, and its run's
    seed, device and tracing flag."""

    def __init__(self, workload, seed, trace, device, bench=None,
                 overrides=None, files=None):
        from h100bench.seeds import sub_seed
        bench = bench or benchmark()
        self.bench = bench
        self.files = files or HERE     # traffic/, limits/, layer_metrics/
        self.entry = next((w for w in bench['workloads']
                           if w['name'] == workload), None)
        if self.entry is None:
            raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
        self.workload = workload
        conf = next(c for c in bench['configs']
                    if c['name'] == self.entry['config'])
        overrides = overrides or {}
        self.config = dict(load_json(os.path.join(ROOT, conf['file'])),
                           **overrides.get('config', {}))
        self.traffic = dict(load_json(os.path.join(
            self.files, 'traffic', f"{self.entry['traffic']}.json")),
            **overrides.get('traffic', {}))
        self.limits = dict(load_json(os.path.join(
            self.files, 'limits', f'{workload}.json')),
            **overrides.get('limits', {}))
        self.marks = []
        self.seed, self.trace = int(seed), bool(trace)
        self.weight_seed = sub_seed(seed, 0)
        import torch
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        fam = importlib.import_module(
            f"h100bench.models.{self.config['family']}")
        self.family = fam.Family(self.config, self.device)
        self.peaks = load_json(os.path.join(HERE, 'peaks.json'))
        import neurite_tpu_torch
        self.nt = neurite_tpu_torch

    def mark(self, what):
        """Note the time a stage of set-up ended (logged with the run)."""
        self.marks.append((what, time.time()))

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def metrics(self, kind):
        """The names of this cell's end-to-end or per-layer metrics: those
        that list it, or that list no cells and move an end-to-end metric
        this cell reports."""
        e2e = [m for m in self.bench['end_to_end']
               if self.workload in m.get('workloads', [self.workload])]
        if kind == 'end_to_end':
            return e2e
        names = {m['name'] for m in e2e}
        return [m for m in self.bench['per_layer']
                if (self.workload in m['workloads'] if 'workloads' in m
                    else m['moves'] in names)]

    def driver(self):
        mod = importlib.import_module(
            f"h100bench.drivers.{self.traffic['kind']}")
        return mod.Driver(self)


class Reading:
    """What a per-layer metric reads: the numbers read without the
    profiler (`untraced`: the timed window's end-to-end metrics and
    'step_s' or 'service_s', and the driver's own, such as 'issue_ms'),
    the trace of the traced window and its iterations, the cell, the ops'
    yardsticks and the memory peak over both windows."""

    def __init__(self, cell, untraced, trace, iterations, mem_peak):
        self.cell, self.untraced = cell, untraced
        self.trace, self.iterations = trace, iterations
        self.mem_peak = mem_peak
        self.peaks = cell.peaks
        self.notes = []

    def bound_ms(self, nbytes, flops):
        """(least ms, 'bytes' or 'operations'): the larger of bytes over
        the memory rate and float32 operations over the non-tensor-core
        peak."""
        t_b = 1e3 * nbytes / self.peaks['hbm_bytes_per_s']
        t_o = 1e3 * flops / self.peaks['f32_flop_per_s']
        return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')

    def ops(self):
        """{op: (bound module, [kernel-name patterns])} of every op that
        has a yardstick."""
        out = {}
        for d in sorted(glob.glob(os.path.join(HERE, 'ops', '*', ''))):
            op = os.path.basename(os.path.dirname(d))
            pats = []
            for f in sorted(glob.glob(os.path.join(d, '*.json'))):
                pats += load_json(f)['kernels']
            out[op] = (load_module(os.path.join(d, 'bound.py'),
                                   f'h100bench.ops.{op}'), pats)
        return out

    def note(self, text):
        self.notes.append(text)


def read_layer_metrics(cell, reading):
    out = {}
    for m in cell.metrics('per_layer'):
        mod = load_module(os.path.join(cell.files, 'layer_metrics',
                                       f"{m['name']}.py"),
                          'h100bench.layer_metrics.' + re.sub(
                              r'\W', '_', m['name']))
        v = mod.read(reading)
        if v is not None:
            out[m['name']] = {'value': float(v), 'unit': m['unit']}
    return out


def run(workload, seed, seconds, trace, device, started, overrides=None,
        log=print, bench=None, files=None):
    """One run; returns the result object (without the forbidden-module
    check, which the caller makes in its own process). A traced run
    measures the window as an untraced run does, then the traced window,
    and reports the per-layer metrics."""
    import torch
    from h100bench import compare
    cell = Cell(workload, seed, trace, device, bench, overrides, files)
    cell.mark('imports and cell')
    drv = cell.driver()
    drv.setup()
    setup_s = time.time() - started
    prev = started
    for what, t in cell.marks:
        log(f'set-up: {what} {t - prev:.3f} s')
        prev = t
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    device_info = {'platform': 'gpu' if cell.cuda else 'cpu',
                   'kind': (torch.cuda.get_device_name(cell.device)
                            if cell.cuda else 'cpu'),
                   'count': 1}
    breakdown = None
    e2e = drv.window(seconds)
    if trace:
        launches = importlib.import_module(
            'neurite_tpu_torch.ops._build').launches
        launches.clear()
        tr, iterations, untraced = drv.traced_window()
    mem = torch.cuda.max_memory_allocated(cell.device) if cell.cuda else 0
    if trace:
        reading = Reading(cell, {**e2e, **untraced}, tr, iterations, mem)
        metrics = read_layer_metrics(cell, reading)
        for n in reading.notes:
            log(n)
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = tr.breakdown()
        log('kernel launches in the traced window: '
            + json.dumps(dict(launches)))
        log('device events matched to no launch: %d, %.4f ms'
            % tr.unmatched())
    else:
        wanted = {m['name']: m['unit'] for m in cell.metrics('end_to_end')}
        metrics = {k: {'value': v, 'unit': wanted[k]} for k, v in e2e.items()
                   if k in wanted}
        metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
    device_info['memory_peak_bytes'] = int(mem)
    drv.free()
    if cell.cuda:
        torch.cuda.empty_cache()
    numbers = drv.numbers(drv.reference())
    correct, compared = compare.verdict(numbers, cell.limits)
    result = {'correct': bool(correct), 'attempted': int(drv.attempted),
              'failed': 0, 'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['compared'] = compared
    for k, v in metrics.items():
        if not math.isfinite(v['value']):
            result['correct'] = False
    return result
