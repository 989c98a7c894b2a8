"""
Config #3 on the port's normal path (`nt.models.unet_lc`: the UNet trunk
feeding a LocallyConnected3D head) against the benchmark's plain reference
(`h100bench/reference/lc.py`, `reference/unet.py`, the 'lc_head' family
and `drivers/train_stored.py`) at 16^3 on the CPU; and the LC layer's spans.
Torch only.
"""

import json
import os
import sys

import pytest
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import training
from neurite_tpu_torch.ops import lc_cuda, lc_tap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from h100bench.drivers import train_stored  # noqa: E402
from h100bench.models import lc_head  # noqa: E402

SEED = 2 ** 31 + 5
LR = 1e-4


def _family(dtype, head_dtype, size=16):
    path = os.path.join(ROOT, 'h100bench', 'configs', 'lc-head.json')
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(shape=[size] * 3, dtype=dtype)
    cfg['head'] = dict(cfg['head'], param_dtype=head_dtype)
    return lc_head.Family(cfg, 'cpu')


def _rows(fam, n, seed=7):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn((1, *fam.shape, 1), generator=gen),
             torch.randn((1, *fam.shape, 1), generator=gen))
            for _ in range(n)]


def _close(got, want, rel):
    """max |got - want| within `rel` of max |want|."""
    err = float((got.float() - want.float()).abs().max())
    return err <= rel * float(want.float().abs().max()), err


def test_names_and_shapes_are_the_family_s():
    fam = _family('bfloat16', 'bfloat16')
    model = nt.models.unet_lc(input_shape=(16, 16, 16, 1), device='cpu')
    got = {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()}
    want = {k: (s, torch.bfloat16 if k.startswith('lc.') else torch.float32)
            for k, (s, _) in fam.param_shapes().items()}
    assert got == want
    assert isinstance(model, nt.models.UNetLC)
    assert model.spatial_rule == 'local'
    assert sum(p.numel() for p in model.UNet_0.parameters()) == 43532


def test_f32_forward_loss_and_grads_match_the_reference():
    """At 16^3 in float32 (trunk compute and head storage), from seeded
    weights: the forward, the MSE and every gradient within 1e-5 of the
    reference's largest magnitude (float32 sums in another order)."""
    fam = _family('float32', 'float32')
    weights = fam.weights(SEED)
    model = fam.program(nt, weights)
    (x, y), = _rows(fam, 1)
    pred = model(x, training=True)
    loss = fam.program_loss(nt)(y, pred)
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    rpred = fam.reference_forward(params, x)
    rloss = fam.reference_loss(y, rpred)
    rgrad = dict(zip(params, torch.autograd.grad(rloss,
                                                 list(params.values()))))
    ok, err = _close(pred.detach(), rpred.detach(), 1e-5)
    assert ok, err
    lp, lr_ = float(loss.detach()), float(rloss.detach())
    assert abs(lp - lr_) <= 1e-5 * abs(lr_)
    named = dict(model.named_parameters())
    assert set(named) == set(rgrad)
    for k, g in rgrad.items():
        ok, err = _close(named[k].grad, g, 1e-5)
        assert ok, (k, err)


def test_three_adam_steps_with_a_bf16_head_match_the_stored_reference():
    """Three steps of `training.adam` with the head stored in bfloat16
    (trunk compute float32) against `train_stored.reference_steps`, whose
    moments are float32 and whose head is rounded to bfloat16 after each
    update. The losses agree to 1e-5; the trunk's parameters to 1e-6 of
    their largest magnitude (Adam from gradients that agree to about 1e-6,
    its near-eps steps aside). In the head the program's moments are
    bfloat16, so a weight whose step lies near a rounding boundary may land
    one ulp away, and one near 0 (ulps far under lr) by part of a step: at
    most 5 % of a head leaf's weights differ (0.4 % of the kernel's and
    3.7 % of the bias's here), each by at most one bfloat16 ulp of the
    larger or half the learning rate (0.31 lr here), and the share left
    unchanged agrees to 1 %."""
    fam = _family('float32', 'bfloat16')
    weights = fam.weights(SEED)
    rows = _rows(fam, 3)
    model = fam.program(nt, weights)
    state = training.create_train_state(model, training.adam(LR))
    step = training.make_train_step(fam.program_loss(nt))
    losses = []
    for batch in rows:
        state, m = step(state, batch)
        losses.append(float(m['loss']))
    ref = train_stored.reference_steps(fam, weights, rows, LR)
    for a, b in zip(losses, ref['losses']):
        assert abs(a - b) <= 1e-5 * abs(b), (losses, ref['losses'])
    named = dict(model.named_parameters())
    for k, want in ref['params'].items():
        got = named[k].detach()
        if not k.startswith('lc.'):
            ok, err = _close(got, want, 1e-6)
            assert ok, (k, err)
            continue
        assert got.dtype == torch.bfloat16
        assert torch.equal(want, want.to(torch.bfloat16).float())
        got = got.float()
        assert float((got != want).float().mean()) <= 0.05, k
        larger = torch.maximum(got.abs(), want.abs())
        ulp = torch.exp2(torch.floor(torch.log2(larger)) - 7)
        assert bool(((got - want).abs()
                     <= torch.clamp(ulp, min=LR / 2)).all()), k
        w0 = weights[k].float()
        frozen = [float((p == w0).float().mean()) for p in (got, want)]
        assert abs(frozen[0] - frozen[1]) <= 0.01, (k, frozen)
    # lr 1e-4 leaves a bfloat16 weight of |w| >= 2^-5 where it is
    frozen = float((named['lc.kernel'].detach() == weights['lc.kernel'])
                   .float().mean())
    assert 0.5 < frozen < 0.9


def test_one_step_opens_each_lc_span_once(monkeypatch):
    """Under torch.profiler, through LCTransposed's plain forms on the CPU,
    one training step opens one 'neurite/lc/forward', one 'neurite/lc/dk'
    and one 'neurite/lc/dx'."""
    def through_lc_transposed(x, kernel, kernel_size, padding):
        return lc_cuda.LCTransposed.apply(x, kernel, tuple(kernel_size),
                                          padding, False)
    monkeypatch.setattr(lc_tap, 'lc_transposed', through_lc_transposed)
    model = nt.models.unet_lc(input_shape=(8, 8, 8, 1), device='cpu')
    state = training.create_train_state(model, training.adam(LR))
    step = training.make_train_step(nt.metrics.l2)
    batch = (torch.randn(1, 8, 8, 8, 1), torch.randn(1, 8, 8, 8, 1))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch)
    names = [e.name for e in prof.events()]
    for span in ('lc/forward', 'lc/dk', 'lc/dx'):
        assert names.count('neurite/' + span) == 1, span
    assert model.lc.kernel.grad is not None


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lc_output_is_the_plain_form_s(dtype):
    """Off the profiler the head's output is the plain form's plus the
    bias, bit for bit, on either compute type."""
    fam = _family(dtype, 'bfloat16', size=8)
    model = fam.program(nt, fam.weights(SEED))
    (x, _), = _rows(fam, 1)
    h = model.UNet_0(x)
    got = model.lc(h)
    k = model.lc.kernel.to(h.dtype)
    want = lc_tap.lc_transposed(h, k, (3, 3, 3), 'same').to(h.dtype)
    assert torch.equal(got, want + model.lc.bias)
