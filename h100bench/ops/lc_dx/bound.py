"""K9, the locally-connected 3-D input cotangent: the live weights and the
cotangent g (float32) read once, dx written once in x's type; a
multiply-add per live weight and batch item. call: as lc_fwd's."""
import math

from h100bench.reference.lc import live_weights


def bound(call):
    b, *sp, c = call['shape']
    o = call['filters']
    live = live_weights(sp, call['kernel_size'], o, c)
    dx = math.prod(call['shape']) * call['x_itemsize']
    g = b * math.prod(sp) * o * 4
    return live * call['k_itemsize'] + g + dx, 2. * live * b
