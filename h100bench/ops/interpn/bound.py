"""K4, interpolation at points: the volume, the points and the output read
or written once, float32. call: {'vol', 'loc', 'out'} shapes."""
import math


def bound(call):
    return sum(math.prod(call[k]) for k in ('vol', 'loc', 'out')) * 4, 0.
