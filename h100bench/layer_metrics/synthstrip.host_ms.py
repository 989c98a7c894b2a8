"""`readers.host_ms`: host ms to issue the SynthStrip step."""

from h100bench.readers import host_ms as read  # noqa: F401
