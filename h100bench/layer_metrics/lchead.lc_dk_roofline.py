"""`op_roofline.read`: K8, the kernel cotangent of config #3's LC head,
against its roofline (`ops/lc_dk/`), in %."""

from h100bench import op_roofline


def read(r):
    return op_roofline.read(r, 'lc_dk')
