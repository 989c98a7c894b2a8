"""`readers.kernels_roofline`: the hand-written kernels of the flagship's
step against their roofline, in %."""

from h100bench.readers import kernels_roofline as read  # noqa: F401
