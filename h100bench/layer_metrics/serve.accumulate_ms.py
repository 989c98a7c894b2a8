"""Device ms a volume of the events launched inside the program's spans
'neurite/seg/accumulate' (each patch's prediction and count added into
the volume's accumulators) and 'neurite/seg/mean' (the overlap mean)."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'seg/accumulate', 'seg/mean')
