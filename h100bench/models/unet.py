"""
The 'unet' family: neurite's UNet segmenter as the program builds it
(`neurite_tpu_torch.models.unet`), trained with SoftDice and Adam or
served patch by patch.

What a family gives the harness: the program's model with weights the
harness drew (`program`), the program's loss (`program_loss`), the plain
reference's forward and loss (`reference_forward`, `reference_loss`),
the operations of one forward pass (`forward_flops`), and the calls of
the program's hand-written kernels in one training step (`step_ops`).
"""

import torch

from h100bench import trace
from h100bench.reference import losses, unet as ref_unet

DTYPES = {'bfloat16': torch.bfloat16, 'float32': None}


class Family:
    prefix = ''          # the program's parameter names: prefix + reference's

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.net_cfg = cfg        # the UNet's own settings
        self.device = torch.device(device)
        self.shape = tuple(cfg['shape'])

    # --- weights and models ---------------------------------------------

    def weights(self, seed):
        return ref_unet.make_weights(self.net_cfg, seed, self.device)

    def program(self, nt, weights):
        """The program's UNet at the configuration, carrying `weights`."""
        c = self.cfg
        model = nt.models.unet(
            nb_features=c['nb_features'], input_shape=(*self.shape,
                                                       c['in_channels']),
            nb_levels=c['nb_levels'], conv_size=c['conv_size'],
            nb_labels=c['nb_labels'], feat_mult=c['feat_mult'],
            nb_conv_per_level=c['nb_conv_per_level'],
            dtype=DTYPES[c['dtype']], device=self.device)
        load(model, weights, self.prefix)
        return model

    def span_hooks(self, model, serve=False):
        """Forward hooks that open and close spans on the program's
        modules in a traced run: serving, 'apply' around each call of the
        model."""
        if not serve:
            return []
        s = trace.HookSpan('apply')
        return [model.register_forward_pre_hook(s.enter),
                model.register_forward_hook(s.exit)]

    def program_loss(self, nt):
        return nt.losses.SoftDice(check_input_limits=False).loss

    # --- the plain reference ------------------------------------------------

    def reference_forward(self, weights, x, precision='f32'):
        return ref_unet.forward(self.net_cfg, weights, x, precision)

    def reference_loss(self, y, pred):
        return losses.LOSSES[self.cfg['loss']](y, pred)

    # --- work counts --------------------------------------------------------

    def forward_flops(self, shape=None):
        return ref_unet.conv_flops(self.net_cfg, shape or self.shape)

    def peak_key(self):
        """The chip peak the convs run at: bfloat16, or TF32 for float32
        convs under PyTorch's default `cudnn.allow_tf32 = True`."""
        return {'bfloat16': 'bf16', 'float32': 'tf32'}[self.cfg['dtype']]

    def pool_calls(self, shape, itemsize):
        """The 2x max pools of one forward pass: [(op, call)]."""
        out = []
        for level in range(ref_unet.nb_levels(self.net_cfg) - 1):
            f = ref_unet.level_feats(self.net_cfg, level)[-1]
            sp = [s // 2 ** level for s in shape]
            out.append({'shape': [1, *sp, f], 'itemsize': itemsize})
        return out

    def step_ops(self):
        """{op: [call, ...]} of the program's hand-written kernels in one
        training step at the configuration's shape."""
        item = 2 if self.cfg['dtype'] == 'bfloat16' else 4
        pools = self.pool_calls(self.shape, item)
        ops = {'pool_fwd': pools, 'pool_bwd': pools}
        if self.cfg['loss'] == 'soft_dice':
            n = 1
            for s in self.shape:
                n *= s
            ops['dice_sums'] = [{'shape': [1, n, self.cfg['nb_labels']]}]
        return ops


def load(model, weights, prefix=''):
    """Copy `weights` (reference names) into the program's parameters,
    which must be exactly these names and shapes."""
    params = dict(model.named_parameters())
    want = {prefix + k: v for k, v in weights.items()}
    if set(params) != set(want):
        raise RuntimeError(
            'parameter names differ: program only '
            f'{sorted(set(params) - set(want))[:4]}, reference only '
            f'{sorted(set(want) - set(params))[:4]}')
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(want[name].shape):
                raise RuntimeError(f'{name}: program {tuple(p.shape)}, '
                                   f'reference {tuple(want[name].shape)}')
            p.copy_(want[name])
