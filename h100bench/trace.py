"""
The traced window: `torch.profiler` over the host and the card, read back
from its Chrome trace, and the harness's own spans.

Spans are `torch.profiler.record_function` ranges named 'h100bench/...'
that the harness opens around its calls into each layer (and, through
forward hooks, around calls inside the program's modules). A device
event (kernel, copy, memset) belongs to a span when the host call that
launched it (matched by the trace's correlation id) lies inside the span.
"""

import bisect
import collections
import contextlib
import json
import os
import tempfile

import numpy as np
import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
PREFIX = 'h100bench/'


def span(name):
    """A span of the harness, as a context manager."""
    return torch.profiler.record_function(PREFIX + name)


class HookSpan:
    """A span opened by one forward hook and closed by another."""

    def __init__(self, name):
        self.name = name
        self.open = None

    def enter(self, *_):
        self.open = span(self.name)
        self.open.__enter__()

    def exit(self, *_):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


@contextlib.contextmanager
def profiled(out):
    """Profile the body over the host and the card; `out` (a dict) gets
    'trace', the parsed `Trace`, when the body ends."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.remove(path)
    out['trace'] = Trace(events)


class Trace:
    """The complete ('X') events of a trace, in microseconds."""

    def __init__(self, events):
        self.device, self.host, self.spans = [], [], collections.defaultdict(
            list)
        launch = {}
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat', '')
            ts, dur = float(e['ts']), float(e.get('dur', 0.))
            if cat in DEVICE_CATS:
                self.device.append((e['name'], ts, ts + dur,
                                    e.get('args', {}).get('correlation')))
            elif cat in HOST_CATS:
                self.host.append((e['name'], ts, ts + dur))
                if cat in ('cuda_runtime', 'cuda_driver'):
                    corr = e.get('args', {}).get('correlation')
                    if corr is not None:
                        launch[corr] = ts
                if cat == 'user_annotation' and e['name'].startswith(PREFIX):
                    self.spans[e['name'][len(PREFIX):]].append((ts, ts + dur))
        for v in self.spans.values():
            v.sort()
        # (name, start, end, host time of the launch or None)
        self.device = [(n, s, t, launch.get(c)) for n, s, t, c in self.device]
        self.device.sort(key=lambda d: d[1])
        w = self.spans.get('window')
        self.window = w[0] if w else (
            min(d[1] for d in self.device), max(d[2] for d in self.device))

    # --- the window -----------------------------------------------------

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        """The union of the device events' intervals inside the window."""
        lo, hi = self.window
        merged = []
        for _, s, t, _ in self.device:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self):
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def busy_within(self, name):
        """(busy s, length s) of the device inside the spans `name`."""
        busy = self.busy_intervals()
        starts = [b[0] for b in busy]
        on = length = 0.
        for lo, hi in self.spans.get(name, []):
            length += hi - lo
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(busy) and busy[i][0] < hi:
                on += max(0., min(hi, busy[i][1]) - max(lo, busy[i][0]))
                i += 1
        return on / 1e6, length / 1e6

    # --- spans --------------------------------------------------------------

    def span_ms(self, name):
        """(total ms, count) of a harness span."""
        v = self.spans.get(name, [])
        return sum(t - s for s, t in v) / 1e3, len(v)

    def _inside(self, name, ts):
        v = self.spans.get(name)
        if not v or ts is None:
            return False
        i = bisect.bisect_right(v, (ts, float('inf'))) - 1
        return i >= 0 and v[i][0] <= ts <= v[i][1]

    def device_ms_under(self, name, outside=None):
        """Device ms of the events launched inside span `name` (and not
        inside span `outside`)."""
        total = 0.
        for _, s, t, ts in self.device:
            if self._inside(name, ts) and not (outside
                                               and self._inside(outside, ts)):
                total += t - s
        return total / 1e3

    def unmatched(self):
        """(count, ms) of the device events matched to no launch."""
        ev = [t - s for _, s, t, ts in self.device if ts is None]
        return len(ev), sum(ev) / 1e3

    def device_ms(self, match):
        """Device ms of the events whose name `match(name)` accepts."""
        return sum(t - s for n, s, t, _ in self.device if match(n)) / 1e3

    # --- the breakdown --------------------------------------------------------

    def breakdown(self, top=10):
        """{'device_ops': [[name, s]], 'idle_gaps': [[name, s]]}: the device
        events that took most time, summed by name; the idle gaps between
        them inside the window, summed by what the host was running at
        each gap's middle (its innermost host event)."""
        by = collections.Counter()
        for n, s, t, _ in self.device:
            by[n] += (t - s) / 1e6
        ops = [[n[:200], v] for n, v in by.most_common(top)]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for b in busy for x in b] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        gaps = gaps[:400]
        if self.host and gaps:
            names = [h[0] for h in self.host]
            starts = np.array([h[1] for h in self.host])
            ends = np.array([h[2] for h in self.host])
            lengths = ends - starts
        idle = collections.Counter()
        for s, t in gaps:
            mid = (s + t) / 2
            name = 'no host event'
            if self.host:
                cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
                if cover.size:
                    name = names[int(cover[np.argmin(lengths[cover])])]
            idle[name[:200]] += (t - s) / 1e6
        return {'device_ops': ops,
                'idle_gaps': [[n, v] for n, v in idle.most_common(top)]}
