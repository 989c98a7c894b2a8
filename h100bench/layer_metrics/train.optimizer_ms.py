"""Device ms a step of the events launched inside the program's span
'neurite/train/optimizer': Adam's update of the flagship's parameters
(`torch.optim.Adam`, its foreach kernels)."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'train/optimizer')
