"""Device ms a step of the events launched inside the program's span
'neurite/train/optimizer': Adam's update of config #3's 446M parameters
(`torch.optim.Adam`, its foreach kernels)."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'train/optimizer')
