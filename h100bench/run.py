"""
Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the result's metrics are the cell's end-to-end metrics,
measured over a window of --seconds; with --trace 1 its per-layer
metrics, read from the same window and from a profiled window of the
traffic's `trace_*` iterations after it. Every run checks what its timed path produced against the
plain reference and prints each number compared beside its limit, last
on standard error and last in the result.

The run needs the CUDA devices its cell asks for and exits with 2
otherwise; it exits with 3, printing no result, if a JAX package or the
JAX package of this repository was loaded.
"""

import os
import sys
import time


def process_start():
    """The wall-clock time this process started (Linux /proc), or now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_env():
    """Build and kernel caches at fixed paths inside the checkout; no
    library the program uses loads flax."""
    build = os.path.join(ROOT, 'build')
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(build, 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(build, 'triton'))
    os.environ['USE_FLAX'] = '0'


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env()
    sys.path.insert(0, ROOT)
    import json
    import torch
    # load from one process with few threads: no idle pool competes with
    # the thread that launches the work
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from h100bench import harness
    chips = next((w['chips'] for w in harness.benchmark()['workloads']
                  if w['name'] == a.workload), None)
    if chips is None:
        print(f'no workload {a.workload!r} in BENCHMARK.json', file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{a.workload} needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ': no result', file=sys.stderr)
        return 2

    def log(text):
        print(text, file=sys.stderr, flush=True)

    result = harness.run(a.workload, a.seed, a.seconds, a.trace, 'cuda',
                         STARTED, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f'loaded in this process: {", ".join(bad)}: no result',
              file=sys.stderr)
        return 3
    for name, c in result['compared'].items():
        log(f'compared {name}: {c["value"]!r} (limit {c["limit"]!r})')
    log(f'correct: {result["correct"]}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
