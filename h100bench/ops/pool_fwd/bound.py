"""K1, the 2x max pool forward: the input read once, the output (an
eighth of it) written once. call: {'shape': input shape, 'itemsize'}."""
import math


def bound(call):
    n = math.prod(call['shape'])
    return (n + n // 8) * call['itemsize'], 0.
