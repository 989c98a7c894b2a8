"""
One hand-written kernel's share of its roofline, read from the traced
window: the least time of the op's calls in a step (`ops/<op>/bound.py`:
bytes read once and written once over the memory rate, operations over the
float32 peak) times the steps, over the device time of the op's kernels
(`ops/<op>/*.json`), in %. A per-layer metric's file,
`layer_metrics/<name>.py`, calls `read` with its op.
"""

import re


def read(r, op):
    """The share of `op`, or None where the family's step makes no call of
    it or the trace shows none of its kernels."""
    calls = r.cell.family.step_ops().get(op)
    mod, pats = r.ops().get(op, (None, []))
    if not calls or not pats:
        return None
    rx = re.compile(r'\b(' + '|'.join(pats) + r')\b')
    ms = r.trace.device_ms(lambda n: bool(rx.search(n)))
    if ms <= 0:
        return None
    bound = sum(r.bound_ms(*mod.bound(c))[0] for c in calls) * r.iterations
    r.note(f'{op}_roofline: bound {bound:.4f} ms over {ms:.4f} device ms '
           f'({r.iterations} steps)')
    return 100 * bound / ms
