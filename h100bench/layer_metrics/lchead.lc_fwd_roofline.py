"""`op_roofline.read`: K7, the forward of config #3's LC head,
against its roofline (`ops/lc_fwd/`), in %."""

from h100bench import op_roofline


def read(r):
    return op_roofline.read(r, 'lc_fwd')
