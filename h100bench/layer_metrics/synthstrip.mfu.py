"""`readers.train_mfu`: the SynthStrip step's model FLOPs over the timed
window's time a step, as a share of the chip's peak, in %."""

from h100bench.readers import train_mfu as read  # noqa: F401
