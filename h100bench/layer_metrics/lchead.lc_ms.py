"""Device ms a step of the events launched inside the program's spans
'neurite/lc/forward', 'neurite/lc/dk' and 'neurite/lc/dx': config #3's
LocallyConnected3D head, its kernels K7, K8 and K9 with the casts and the
bias add around them (the backward's spans open on autograd's thread)."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'lc/forward', 'lc/dk', 'lc/dx')
