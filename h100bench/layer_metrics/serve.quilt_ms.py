"""Device ms a volume of everything but the model's calls: the device
time of all events in the traced window (which holds only requests) less
that of the events launched inside the model's calls (the 'apply' span,
forward hooks on the model). That is the volume's copy to the card, the
patch slicing, the accumulation, the count and the mean; a copy whose
device events match no launch is counted too."""


def read(r):
    if not r.trace.spans.get('apply'):
        return None
    total = r.trace.device_ms(lambda name: True)
    if total <= 0:
        return None
    return (total - r.trace.device_ms_under('apply')) / r.iterations
