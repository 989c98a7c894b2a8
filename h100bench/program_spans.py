"""
Readings of the program's own spans: the `record_function` ranges named
'neurite/<layer>/<phase>' that the port opens while the profiler records
(`neurite_tpu_torch/trace.py`), found among the traced window's host
events (`Trace.host`). A per-layer metric's file,
`layer_metrics/<name>.py`, names one of these.

A device event belongs to a span when the host call that launched it lies
inside the span, as `Trace.device_ms_under` attributes it: so the
backward's launches from autograd's own thread count under
'neurite/train/backward', which holds the host thread that waits for
them. An event matched to no launch counts by its own start. Every
reading returns None when the trace holds none of its spans.
"""

import bisect

PREFIX = 'neurite/'
# host calls that wait for the device
SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
         'cudaEventSynchronize')


class Spans:
    """The union of the intervals of some of the program's spans."""

    def __init__(self, trace, names):
        want = {PREFIX + n for n in names}
        merged = []
        for s, e in sorted((s, e) for n, s, e in trace.host if n in want):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.intervals = merged
        self.starts = [s for s, _ in merged]

    def __bool__(self):
        return bool(self.intervals)

    def __contains__(self, ts):
        if ts is None:
            return False
        i = bisect.bisect_right(self.starts, ts) - 1
        return i >= 0 and ts <= self.intervals[i][1]


def _launch(event):
    _, start, _, launch = event
    return start if launch is None else launch


def device_ms(r, *names):
    """Device ms an iteration of the events launched inside the spans
    `names`, or None."""
    inside = Spans(r.trace, names)
    if not inside:
        return None
    total = sum(e[2] - e[1] for e in r.trace.device if _launch(e) in inside)
    return total / 1e3 / r.iterations


def _enclosing_op(host, ts):
    """(start, end) of the innermost 'aten::' host event around `ts`."""
    best = None
    for n, s, e in host:
        if n.startswith('aten::') and s <= ts <= e and (
                best is None or e - s < best[1] - best[0]):
            best = (s, e)
    return best


def host_syncs(r, name='train/step'):
    """Synchronising calls an iteration inside the spans `name`: each host
    call in `SYNCS`, and each copy between the device and pageable host
    memory (which the host waits for) unless a call in `SYNCS` lies in
    the same aten op, which then counts once; or None."""
    inside = Spans(r.trace, [name])
    if not inside:
        return None
    syncs = [s for n, s, _ in r.trace.host if n in SYNCS and s in inside]
    copies = {_launch(e) for e in r.trace.device
              if 'Pageable' in e[0] and _launch(e) in inside}
    n = len(syncs)
    for ts in copies:
        op = _enclosing_op(r.trace.host, ts)
        if op is None or not any(op[0] <= s <= op[1] for s in syncs):
            n += 1
    return n / r.iterations
