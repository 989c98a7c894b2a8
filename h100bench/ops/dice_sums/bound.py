"""K3, the soft Dice sums: y_true and y_pred [B, N, L] read once in float32,
three [B, L] sums written; a multiply-add per sum and element."""
import math


def bound(call):
    b, _, labels = call['shape']
    n = math.prod(call['shape'])
    return (2 * n + 3 * b * labels) * 4, 6. * n
