"""
Spans inside the port: `torch.profiler.record_function` ranges named
'neurite/<layer>/<phase>', opened at the boundaries of the layers a
profile is read by (the train step's phases, `fit`'s loop, the synthesis,
the UNet's glue around its convs, the serve path's patches, the
LocallyConnected forward and its K8/K9 backward).

A span records only while a `torch.profiler` session records: otherwise
`span` returns one shared no-op context, at the cost of one flag read, so
the program runs as it would without them. The ranges land in the
profiler's own trace, on the clock of its device events; there is no
other sink and no switch but the profiler. Durations come from the
profiler's events: nothing here reads a clock or synchronises.

The port's one counter of kernel launches is `ops._build.launches`.
"""

import contextlib

import torch

PREFIX = 'neurite/'

# the one flag a span reads; true while a profiler records
recording = torch._C._autograd._profiler_enabled

# what every span returns while no profiler records
OFF = contextlib.nullcontext()


def span(name, args=None):
    """A `record_function` range 'neurite/<name>' while a profiler records
    (`args`, such as a step or patch index, handed to it as a string);
    otherwise the shared no-op `OFF`."""
    if not recording():
        return OFF
    return torch.profiler.record_function(
        PREFIX + name, None if args is None else str(args))
