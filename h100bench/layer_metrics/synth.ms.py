"""Device ms a step of the events launched while the synthesis runs: the
'synth' span, from the SynthStrip module's call to its UNet's (forward
pre-hooks)."""


def read(r):
    if not r.trace.spans.get('synth'):
        return None
    return r.trace.device_ms_under('synth') / r.iterations
