"""K8, the locally-connected 3-D kernel cotangent: the cotangent g
(float32, the output's shape) and x read once, every weight of dk written
once (those on the padding too); a multiply-add per live weight and batch
item, less the first add. call: as lc_fwd's."""
import math

from h100bench.reference.lc import live_weights


def bound(call):
    b, *sp, c = call['shape']
    o = call['filters']
    live = live_weights(sp, call['kernel_size'], o, c)
    taps = math.prod(call['kernel_size'])
    dk = o * taps * c * math.prod(sp) * call['k_itemsize']
    x = math.prod(call['shape']) * call['x_itemsize']
    g = b * math.prod(sp) * o * 4
    return dk + g + x, float(live * (2 * b - 1))
