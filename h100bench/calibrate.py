"""
The readings that a cell's correctness limits are set from, on the card:

    python3 h100bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

For each seed of --seeds, the program's own reading of the numbers that
decide `correct` (a training cell: its set-up, whose first three steps
are the ones compared; a serving cell: a 3 s window at the cell's own
rate, from which the requests compared are drawn) against the plain
float32 reference. For each seed of --control-seeds, the control: the
reference computed in the precision below the configuration's (float8
e4m3 operands for bfloat16, bfloat16 for float32), in the program's
place, against the float32 reference. One JSON line per reading, to
standard output and --out.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL = {'bfloat16': 'fp8', 'float32': 'bf16'}


def readings(workload, seed, control, device):
    import torch
    from h100bench import harness
    cell = harness.Cell(workload, seed, False, device)
    drv = cell.driver()
    t0 = time.perf_counter()
    if control:
        if cell.traffic['kind'] == 'serve':
            drv.vols = drv.volumes()
            drv.kept = {i: None for i in range(drv.n_check)}
        else:
            from h100bench.drivers.train import source
            drv.source = source(cell)
        prec = CONTROL[cell.family.cfg['dtype']]
        low = drv.reference(prec)
        ref = drv.reference('f32')
        if cell.traffic['kind'] == 'serve':
            gaps = [float((low[i] - ref[i]).abs().max()) for i in ref]
            numbers = {'prob_gap': max(gaps)}
        else:
            from h100bench import compare
            numbers = compare.train_numbers(low, ref)
        kind = f'control {prec}'
    else:
        drv.setup()
        if cell.traffic['kind'] == 'serve':
            drv.window(3.0)
        drv.free()
        numbers = drv.numbers(drv.reference())
        kind = 'program'
    if cell.cuda:
        torch.cuda.empty_cache()
    return {'workload': workload, 'seed': seed, 'kind': kind,
            'numbers': numbers, 'seconds': time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--out')
    p.add_argument('--device', default='cuda')
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    out = open(a.out, 'a') if a.out else None
    try:
        for control, seeds in ((False, a.seeds), (True, a.control_seeds)):
            for s in [int(v) for v in seeds.split(',') if v]:
                r = readings(a.workload, s, control, a.device)
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + '\n')
                    out.flush()
    finally:
        if out:
            out.close()


if __name__ == '__main__':
    main()
