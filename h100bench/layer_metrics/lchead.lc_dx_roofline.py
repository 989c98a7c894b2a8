"""`op_roofline.read`: K9, the input cotangent of config #3's LC head,
against its roofline (`ops/lc_dx/`), in %."""

from h100bench import op_roofline


def read(r):
    return op_roofline.read(r, 'lc_dx')
