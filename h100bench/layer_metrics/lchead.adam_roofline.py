"""K11, the fused Adam step over config #3's parameters, against its
roofline, in %: the least time of a step's Adam bytes (`ops/adam/bound.py`
for each leaf of the family's `param_shapes`: the head's kernel and bias in
their stored type, the trunk's leaves in float32) times the traced steps,
over the device time of K11's kernels (`ops/adam/cuda.json`). None where
the trace shows no K11 launch, as for a program whose Adam is
torch.optim.Adam's."""

import math
import re

from h100bench.models.lc_head import PARAM_DTYPES


def read(r):
    mod, pats = r.ops().get('adam', (None, []))
    if not pats:
        return None
    rx = re.compile(r'\b(' + '|'.join(pats) + r')\b')
    ms = r.trace.device_ms(lambda n: bool(rx.search(n)))
    if ms <= 0:
        return None
    fam = r.cell.family
    head = PARAM_DTYPES[fam.head['param_dtype']].itemsize
    bound = sum(r.bound_ms(*mod.bound({
        'numel': math.prod(shape),
        'itemsize': head if name.startswith('lc.') else 4}))[0]
        for name, (shape, _) in fam.param_shapes().items())
    bound *= r.iterations
    r.note(f'adam_roofline: bound {bound:.4f} ms over {ms:.4f} device ms '
           f'({r.iterations} steps)')
    return 100 * bound / ms
