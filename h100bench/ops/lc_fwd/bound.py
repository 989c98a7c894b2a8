"""K7, the locally-connected 3-D forward (SAME, stride 1, weights
[O, prod(k) * C, V]): the weights whose taps reach an input inside the
volume read once (the others multiply the zero padding), x read once, y
written once in float32; a multiply-add per live weight and batch item.
call: {'shape': x's [B, D, H, W, C], 'filters', 'kernel_size',
'x_itemsize', 'k_itemsize'}."""
import math

from h100bench.reference.lc import live_weights


def bound(call):
    b, *sp, c = call['shape']
    o = call['filters']
    live = live_weights(sp, call['kernel_size'], o, c)
    x = math.prod(call['shape']) * call['x_itemsize']
    y = b * math.prod(sp) * o * 4
    return live * call['k_itemsize'] + x + y, 2. * live * b
