"""K11, one fused Adam step of one tensor: its parameter, gradient and two
moments read once, the parameter and moments written once, all in the
parameter's type (7 x numel x itemsize bytes); about a dozen float32
operations an element, far under the bytes' time.
call: {'numel', 'itemsize'}."""


def bound(call):
    n = call['numel']
    return 7 * n * call['itemsize'], 12. * n
