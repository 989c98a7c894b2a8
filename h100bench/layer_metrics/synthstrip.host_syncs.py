"""`program_spans.host_syncs`: the synchronising calls a step inside the
program's span 'neurite/train/step' of the SynthStrip step (synthesis,
UNet, loss, backward and Adam)."""

from h100bench.program_spans import host_syncs as read  # noqa: F401
