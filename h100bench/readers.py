"""
Readings that per-layer metrics of more than one cell share. A metric's
own file, `layer_metrics/<name>.py`, names one of these as its `read`.
"""

import re


def host_ms(r):
    """Host ms from calling the train step to its return, with no
    synchronise inside: the cost of issuing a step, timed without the
    profiler (which slows the host) with the device's queue empty at each
    call, so the call never waits for the device."""
    return r.untraced.get('issue_ms')


def train_mfu(r):
    """Model FLOPs a step (three times the forward's: 2 k^3 C_in C_out per
    output voxel of each conv, 2 C_in C_out per voxel of each 1x1;
    synthesis and recomputation not counted) over the timed window's
    wall time a step, as a share of the chip's peak at the convs' type
    (bfloat16, or TF32 for float32), in %."""
    fam = r.cell.family
    flops = 3 * fam.forward_flops()
    peak = r.peaks[f'{fam.peak_key()}_flop_per_s']
    r.note(f'mfu: {flops:.6g} FLOP a step, {r.untraced["step_s"]:.6g} s a '
           f'step, peak {peak:.4g} FLOP/s ({fam.peak_key()})')
    return 100 * flops / r.untraced['step_s'] / peak


def train_device_idle(r):
    """The device's idle share of a step, in %: 1 - its busy time a step
    in the traced window (the union of the device events' intervals)
    over the timed window's wall time a step. The profiler slows the
    host, not the device, so the traced window's own idle share would
    read the profiler."""
    return 100 * (1 - r.trace.busy_s / r.iterations / r.untraced['step_s'])


def kernels_roofline(r):
    """The hand-written kernels' share of their roofline, in %: the sum of
    each op's least time (bytes read once and written once over the
    memory rate, operations over the float32 peak; `ops/<op>/bound.py`)
    over its calls in a step times the steps, over the sum of the device
    time of the op's kernels (`ops/<op>/*.json`), both over the ops whose
    kernels the trace shows."""
    calls = r.cell.family.step_ops()
    bound = device = 0.
    covered = []
    for op, (mod, pats) in r.ops().items():
        if op not in calls or not pats:
            continue
        rx = re.compile(r'\b(' + '|'.join(pats) + r')\b')
        ms = r.trace.device_ms(lambda n: bool(rx.search(n)))
        if ms <= 0:
            continue
        b = sum(r.bound_ms(*mod.bound(c))[0] for c in calls[op])
        bound += b * r.iterations
        device += ms
        covered.append(f'{op} {b * r.iterations:.4f}/{ms:.4f} ms')
    r.note('kernels_roofline covers: ' + ('; '.join(covered) or 'none'))
    return 100 * bound / device if device else None


def peak_mem_gib(r):
    """`torch.cuda.max_memory_allocated()` over the timed and the traced
    window (after `reset_peak_memory_stats()`), in GiB."""
    return r.mem_peak / 2 ** 30 if r.mem_peak else None
