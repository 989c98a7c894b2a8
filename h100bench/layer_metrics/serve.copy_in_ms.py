"""Device ms a volume of the events launched inside the program's span
'neurite/seg/copy_in': the request's host volume copied to the card by
`predict_volume_device` (from pageable memory)."""

from h100bench.program_spans import device_ms


def read(r):
    return device_ms(r, 'seg/copy_in')
