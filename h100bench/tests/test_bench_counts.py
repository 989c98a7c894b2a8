"""The work counts against hand sums at the published shapes: the
models' FLOPs and parameter counts, the kernels' bytes and operations."""

import json
import math
import os

import pytest

from h100bench import harness
from h100bench.reference import unet as ref_unet

CONFIGS = os.path.join(harness.HERE, 'configs')


def _cfg(name):
    with open(os.path.join(CONFIGS, f'{name}.json')) as f:
        return json.load(f)


def _params(cfg):
    return sum(math.prod(s) for s, _ in ref_unet.param_shapes(cfg).values())


def test_flagship_counts():
    c = _cfg('unet-flagship')
    v = [128 ** 3 // 8 ** lvl for lvl in range(4)]
    enc = (2 * 27 * (1 * 16 + 16 * 16) * v[0] + 2 * 27 * (16 * 32 + 32 * 32)
           * v[1] + 2 * 27 * (32 * 64 + 64 * 64) * v[2]
           + 2 * 27 * (64 * 128 + 128 * 128) * v[3])
    dec = (2 * 27 * ((64 + 128) * 64 + 64 * 64) * v[2]
           + 2 * 27 * ((32 + 64) * 32 + 32 * 32) * v[1]
           + 2 * 27 * ((16 + 32) * 16 + 16 * 16) * v[0])
    head = 2 * 16 * 4 * v[0]
    assert ref_unet.conv_flops(c, c['shape']) == enc + dec + head
    assert enc + dec + head == 272059334656
    assert _params(c) == 1459636


def test_synthstrip_counts():
    u = _cfg('synthstrip')['unet']
    f = [16, 32, 64, 64, 64, 64, 64]
    v = [128 ** 3 // 8 ** lvl for lvl in range(7)]
    enc = sum(2 * 27 * ((1 if l == 0 else f[l - 1]) * f[l] + f[l] * f[l])
              * v[l] for l in range(7))
    dec = sum(2 * 27 * ((f[l] + f[l + 1]) * f[l] + f[l] * f[l]) * v[l]
              for l in range(6))
    assert ref_unet.conv_flops(u, (128,) * 3) == enc + dec + 2 * 16 * v[0]
    assert _params(u) == 2566145


@pytest.mark.parametrize('op,call,nbytes,flops', [
    ('pool_fwd', {'shape': [1, 128, 128, 128, 16], 'itemsize': 2},
     (2 ** 25 + 2 ** 22) * 2, 0.),
    ('pool_bwd', {'shape': [1, 128, 128, 128, 16], 'itemsize': 2},
     (2 ** 26 + 2 ** 22) * 2, 0.),
    ('dice_sums', {'shape': [1, 128 ** 3, 4]},
     (2 * 4 * 128 ** 3 + 12) * 4, 6. * 4 * 128 ** 3),
    ('interpn', {'vol': [1, 64, 64, 64, 3], 'loc': [1, 64, 64, 64, 3],
                 'out': [1, 64, 64, 64, 3]}, 9 * 64 ** 3 * 4, 0.),
    # 7 taps on a 128-voxel axis: 128 * 7 - 2 * (3 + 2 + 1) in-range taps
    ('blur', {'shape': [1, 128, 128, 128], 'widths': [7, 7, 7]},
     2 * 128 ** 3 * 4 + 3 * 7 * 4, 3 * 2 * 128 ** 2 * (128 * 7 - 12.)),
])
def test_kernel_yardsticks(op, call, nbytes, flops):
    mod = harness.load_module(os.path.join(harness.HERE, 'ops', op,
                                           'bound.py'), f'op_{op}')
    assert mod.bound(call) == (nbytes, flops)


def test_flagship_step_ops():
    from h100bench.models import unet
    fam = unet.Family(_cfg('unet-flagship'), 'cpu')
    ops = fam.step_ops()
    assert [c['shape'] for c in ops['pool_fwd']] == [
        [1, 128, 128, 128, 16], [1, 64, 64, 64, 32], [1, 32, 32, 32, 64]]
    assert ops['dice_sums'] == [{'shape': [1, 128 ** 3, 4]}]
