"""`readers.train_device_idle`: the device's idle share of config #3's
step, in %."""

from h100bench.readers import train_device_idle as read  # noqa: F401
