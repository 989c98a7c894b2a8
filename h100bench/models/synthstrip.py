"""
The 'synthstrip' family: FreeSurfer's SynthStrip (Hoopes et al.,
NeuroImage 2022) as the program builds it (`models.SynthStrip`): the
legacy label-to-image synthesis (`LabelsToImageV1`) feeding a UNet that
predicts the brain mask, trained with the sigmoid soft Dice.

The harness draws the synthesis' random tensors itself (`draws`) and the
program's module takes them through `forward(..., draws=)`; a thin
wrapper (`Drawn`) lets `training.make_train_step` hand them in as the
batch's input.
"""

import math

import numpy as np
import torch

from h100bench import trace
from h100bench.models import unet as unet_family
from h100bench.reference import losses, synth, unet as ref_unet


class Drawn(torch.nn.Module):
    """model(x) with x = (labels, draws): calls the program's SynthStrip
    module with the harness's draws."""

    def __init__(self, inner):
        super().__init__()
        self.m = inner

    def forward(self, x, training=None, generator=None):
        labels, draws = x
        return self.m(labels, training=training, generator=generator,
                      draws=draws)


class Family(unet_family.Family):
    prefix = 'm.unet.'

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.net_cfg = dict(cfg['unet'], loss='strip_dice',
                            final_activation='linear', shape=cfg['shape'],
                            dtype=cfg['dtype'])

    def program(self, nt, weights):
        c, u = self.cfg, self.cfg['unet']
        inner = nt.models.SynthStrip(
            inshape=self.shape, labels_in=range(c['labels_in']),
            labels_out={lab: 1 for lab in c['brain_labels']},
            nb_unet_features=u['nb_features'],
            nb_unet_conv_per_level=u['nb_conv_per_level'],
            device=self.device)
        model = Drawn(inner)
        unet_family.load(model, weights, self.prefix)
        return model

    def span_hooks(self, model, serve=False):
        """'synth': from the call of the SynthStrip module to the call of
        its UNet, the synthesis."""
        s = trace.HookSpan('synth')
        return [model.m.register_forward_pre_hook(s.enter),
                model.m.unet.register_forward_pre_hook(s.exit)]

    def program_loss(self, nt):
        # the program has no SynthStrip loss: users write this one
        # (neurite's examples/synthstrip_training.py), as the reference does
        return losses.strip_dice

    def reference_forward(self, weights, x, precision='f32'):
        """x = (labels, draws): the synthesis, then the UNet on the image;
        [pred, brain map] on the channel axis, as the program returns."""
        labels, draws = x
        with torch.no_grad():
            image, brain = synth.synthesize(
                labels, draws, labels_in=self.cfg['labels_in'],
                brain=self.cfg['brain_labels'])
        pred = ref_unet.forward(self.net_cfg, weights, image, precision)
        return torch.cat([pred, brain], -1)

    def reference_loss(self, y, pred):
        return losses.strip_dice(y, pred)

    def step_ops(self):
        pools = self.pool_calls(self.shape, 4)
        half = [s // 2 for s in self.shape]
        squaring = {'vol': [1, *half, 3], 'loc': [1, *half, 3],
                    'out': [1, *half, 3]}
        label_warp = {'vol': [1, *self.shape, 1], 'loc': [1, *self.shape, 3],
                      'out': [1, *self.shape, 1]}
        return {'pool_fwd': pools, 'pool_bwd': pools,
                'interpn': [squaring] * 5 + [label_warp],
                'blur': [{'shape': [1, *self.shape], 'widths': [7, 7, 7]}]}

    # --- inputs: label maps and draws ---------------------------------------

    def label_maps(self, seed, count):
        """`count` integer maps [1, *shape, 1] of labels_in labels in
        smooth regions: the argmax of labels_in smooth random fields."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        coarse = [max(s // 16, 2) for s in self.shape]
        out = []
        for _ in range(count):
            f = torch.randn((1, self.cfg['labels_in'], *coarse),
                            generator=gen, device=self.device)
            f = torch.nn.functional.interpolate(f, size=self.shape,
                                                mode='trilinear',
                                                align_corners=True)
            out.append(f.argmax(1)[..., None].to(torch.int64))
        return out

    def draws(self, seed):
        """One call's raw draws, keyed as `LabelsToImageV1.draw` keys them
        (defaults of the legacy generator: warp_res 16, warp_std 0.5,
        bias_res 40, bias_std 0.3, blur_std 1, gamma_std 0.25, means in
        [25, 225) and SDs in [5, 25) but label 0's in [0, 225) and [0, 25),
        background zeroed with chance 0.2)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        L = self.cfg['labels_in']
        shape = self.shape

        def uni(size, lo, hi):
            return lo + torch.rand(size, generator=gen, device=dev) * (hi - lo)

        def scales(out_shape, res, max_sd):
            res = res if isinstance(res, list) else [res]
            return [(uni((), 0., max_sd),
                     torch.randn((*[int(math.ceil(o / r))
                                    for o in out_shape[:-1]],
                                  out_shape[-1]), generator=gen, device=dev))
                    for r in res]

        half = [s // 2 for s in shape]
        lo_m = torch.tensor([0.] + [25.] * (L - 1), device=dev)
        lo_s = torch.tensor([0.] + [5.] * (L - 1), device=dev)
        eps = float(np.finfo(np.float32).eps)
        return {
            'warp': [scales((*half, 3), [8.], 0.5)],
            'mean': uni((1, 1, L), lo_m, 225.),
            'std': uni((1, 1, L), lo_s, 25.),
            'noise': torch.randn((1, *shape, 1), generator=gen, device=dev),
            'background': uni((1, 1, 1, 1, 1), 0., 1.),
            'blur': [uni((), eps, 1.) for _ in range(3)],
            'bias': [scales((*shape, 1), 40., 0.3)],
            'gamma': torch.randn((1, 1, 1, 1, 1), generator=gen, device=dev),
        }
