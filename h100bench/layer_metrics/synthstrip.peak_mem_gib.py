"""`readers.peak_mem_gib`: the memory peak while the SynthStrip step runs,
in GiB."""

from h100bench.readers import peak_mem_gib as read  # noqa: F401
