"""The plain reference against the program at 16^3 on the CPU, float32:
the UNet's forward and one Adam step, the losses, the synthesis from one
set of draws, and the patch mean."""

import pytest
import torch

import neurite_tpu_torch as nt
from h100bench.models import synthstrip, unet as unet_family
from h100bench.reference import adam, losses, quilt, synth

FLAG = {'shape': [16, 16, 16], 'in_channels': 1, 'nb_features': 16,
        'nb_levels': 4, 'feat_mult': 2, 'nb_conv_per_level': 2,
        'conv_size': 3, 'nb_labels': 4, 'final_activation': 'softmax',
        'dtype': 'float32', 'loss': 'soft_dice', 'adam_lr': 1e-3}


def _pair(seed, shape, labels):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, *shape, 1), generator=g)
    lab = torch.randint(0, labels, (1, *shape), generator=g)
    return x, torch.nn.functional.one_hot(lab, labels).float()


def test_unet_forward_and_step_match_the_program():
    fam = unet_family.Family(FLAG, 'cpu')
    w = fam.weights(3)
    model = fam.program(nt, w)
    x, y = _pair(0, FLAG['shape'], 4)
    with torch.no_grad():
        p_prog = model(x, training=False)
        p_ref = fam.reference_forward(w, x)
    assert torch.allclose(p_prog, p_ref, atol=1e-5)

    state = nt.training.create_train_state(model, nt.training.adam(1e-3))
    step = nt.training.make_train_step(fam.program_loss(nt))
    state, m = step(state, (x, y))
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    opt = adam.Adam(params, 1e-3)
    loss = losses.soft_dice(y, fam.reference_forward(params, x))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    opt.step(grads)
    assert float(m['loss']) == pytest.approx(float(loss), rel=1e-5)
    named = dict(model.named_parameters())
    for k, v in params.items():
        g = named[k].grad
        assert float((g - grads[k]).abs().max()) <= 1e-4 * float(
            grads[k].abs().max()), k
        # an element whose gradient is near Adam's eps (1e-8) moves by
        # lr * g / (|g| + eps), which float32 sums of another order change
        # by up to about 1 % of the step
        assert torch.allclose(named[k].detach(), v.detach(), atol=2e-5), k


def test_losses_match_the_program():
    x, y = _pair(1, (8, 8, 8), 4)
    p = torch.softmax(x.repeat(1, 1, 1, 1, 4) * torch.arange(4.), -1)
    prog = nt.losses.SoftDice(check_input_limits=False).loss(y, p)
    assert float(losses.soft_dice(y, p)) == pytest.approx(float(prog),
                                                          rel=1e-6)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(2)
    w = torch.randn(50, generator=g)
    ref = {'w': w.clone()}
    opt = adam.Adam(ref, 1e-3)
    p = torch.nn.Parameter(w.clone())
    topt = torch.optim.Adam([p], lr=1e-3)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        opt.step({'w': grad})
        p.grad = grad.clone()
        topt.step()
    assert torch.allclose(ref['w'], p.detach(), atol=1e-7)


def test_synthesis_matches_the_program():
    cfg = {'family': 'synthstrip', 'shape': [16, 16, 16], 'labels_in': 16,
           'brain_labels': list(range(1, 12)), 'dtype': 'float32',
           'unet': {"in_channels": 1, "nb_features": [4, 8], "nb_levels": 2,
                    "feat_mult": 1, "nb_conv_per_level": 2, "conv_size": 3,
                    "nb_labels": 1}, 'adam_lr': 1e-3}
    fam = synthstrip.Family(cfg, 'cpu')
    labels = fam.label_maps(4, 1)[0]
    draws = fam.draws(5)
    gen = nt.models.synth.LabelsToImageV1(
        in_label_list=range(16), out_label_list={k: 1 for k in range(1, 12)},
        one_hot=False, device='cpu')
    with torch.no_grad():
        out = gen.apply(labels, gen.perlin(draws, labels.shape))
        image, brain = synth.synthesize(labels, draws)
    assert torch.allclose(out['image'], image, atol=1e-5)
    assert torch.equal(out['map'].float(), brain)


def test_patch_mean_matches_the_program():
    fam = unet_family.Family(FLAG, 'cpu')
    w = fam.weights(6)
    model = fam.program(nt, w)
    vol = torch.randn((32, 32, 32, 1), generator=torch.Generator()
                      .manual_seed(7))
    prog = nt.utils.seg.predict_volume_device(model, vol, (16,) * 3,
                                              stride=8, device='cpu')
    with torch.no_grad():
        ref = quilt.predict(lambda p: fam.reference_forward(w, p), vol,
                            (16,) * 3, 8)
    assert torch.allclose(prog, ref, atol=1e-5)
    assert quilt.patch_starts(256, 128, 64) == [0, 64, 128]
