"""K6, a separable SAME blur of x [N, *spatial] (float32), its three axis
passes: x read and the result written once, the taps read; a
multiply-add for each tap that falls inside the axis (taps in the zero
padding need no work). call: {'shape', 'widths'}."""
import math

import numpy as np


def pass_flops(shape, axis, width):
    n, *sp = shape
    r, i = width // 2, np.arange(sp[axis])
    taps = int((np.minimum(i + r, sp[axis] - 1) - np.maximum(i - r, 0)
                + 1).sum())
    return 2 * n * (math.prod(sp) // sp[axis]) * taps


def bound(call):
    shape, widths = call['shape'], call['widths']
    nbytes = 2 * math.prod(shape) * 4 + len(widths) * max(widths) * 4
    return nbytes, float(sum(pass_flops(shape, a, w)
                             for a, w in enumerate(widths)))
