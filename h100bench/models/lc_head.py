"""
The 'lc_head' family: the repository's config #3 as the program builds it
(`neurite_tpu_torch.models.unet_lc`): neurite's UNet trunk, bfloat16
compute over float32 parameters, feeding a LocallyConnected3D head whose
parameters are stored in bfloat16; trained with the mean squared error and
Adam.

The parameters' names are the program's ('UNet_0.' before the trunk's,
'lc.kernel' and 'lc.bias'). The weights hold the head in its stored type,
bfloat16, which is how the reference steps (`drivers/train_stored.py`)
know to round it after each update.
"""

import math

import torch

from h100bench.models import unet as unet_family
from h100bench.reference import lc as ref_lc, unet as ref_unet

TRUNK = 'UNet_0.'
PARAM_DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


class Family(unet_family.Family):
    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.head = cfg['head']
        k = int(self.head['kernel_size'])
        self.kernel_size = (k, k, k)

    # --- weights and models ---------------------------------------------

    def param_shapes(self):
        """{name: (shape, fan_in)} of every parameter: the trunk's, then the
        head's kernel [O, prod(k) * C, V] (fan-in prod(k) * C times O, as
        flax's lecun_normal counts it in this layout) and bias
        [*shape, O]."""
        o, c = int(self.head['filters']), int(self.cfg['nb_labels'])
        tc = math.prod(self.kernel_size) * c
        shapes = ref_unet.param_shapes(self.cfg, TRUNK)
        shapes['lc.kernel'] = ((o, tc, math.prod(self.shape)), o * tc)
        shapes['lc.bias'] = ((*self.shape, o), None)
        return shapes

    def weights(self, seed):
        """{name: tensor} drawn on the device from one generator seeded by
        `seed`, in one call, as `reference.unet.make_weights` draws them
        (kernels normal with variance 1 / fan_in clipped at two SDs, biases
        SD 0.01); the head's kernel and bias then rounded once to their
        stored type."""
        shapes = self.param_shapes()
        total = sum(math.prod(s) for s, _ in shapes.values())
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        flat = torch.randn(total, generator=gen,
                           device=self.device).clamp_(-2., 2.)
        stored = PARAM_DTYPES[self.head['param_dtype']]
        out, at = {}, 0
        for name, (shape, fan_in) in shapes.items():
            n = math.prod(shape)
            sd = 0.01 if fan_in is None else math.sqrt(1. / fan_in)
            w = (flat[at:at + n] * sd).reshape(shape)
            out[name] = w.to(stored) if name.startswith('lc.') else w
            at += n
        return out

    def program(self, nt, weights):
        """The program's config #3 model, carrying `weights`."""
        c, h = self.cfg, self.head
        model = nt.models.unet_lc(
            input_shape=(*self.shape, c['in_channels']),
            nb_features=c['nb_features'], nb_levels=c['nb_levels'],
            conv_size=c['conv_size'], nb_labels=c['nb_labels'],
            feat_mult=c['feat_mult'],
            nb_conv_per_level=c['nb_conv_per_level'],
            final_pred_activation=c['final_activation'],
            dtype=unet_family.DTYPES[c['dtype']], filters=h['filters'],
            kernel_size=h['kernel_size'], padding=h['padding'],
            param_dtype=PARAM_DTYPES[h['param_dtype']], device=self.device)
        unet_family.load(model, weights)
        return model

    def program_loss(self, nt):
        """The port's own mean squared error over every element."""
        return nt.metrics.l2

    # --- the plain reference ------------------------------------------------

    def reference_forward(self, weights, x, precision='f32'):
        """The trunk's prediction, then the head, every product's operands
        rounded to `precision` ('f32', 'bf16' or the fp8 e4m3 control)."""
        h = ref_unet.forward(self.cfg, weights, x, precision, TRUNK)
        return ref_lc.forward(h, weights['lc.kernel'], weights['lc.bias'],
                              self.kernel_size, precision)

    def reference_loss(self, y, pred):
        return ref_lc.mse(y, pred)

    # --- work counts --------------------------------------------------------

    def forward_flops(self, shape=None):
        """The trunk's convs and 2 prod(k) C O a voxel for the head."""
        shape = shape or self.shape
        return ref_unet.conv_flops(self.cfg, shape) + 2 * math.prod(
            self.kernel_size) * self.cfg['nb_labels'] * self.head[
                'filters'] * math.prod(shape)

    def step_ops(self):
        """The pools of the trunk and one call each of K7, K8 and K9."""
        item = 2 if self.cfg['dtype'] == 'bfloat16' else 4
        pools = self.pool_calls(self.shape, item)
        lc = {'shape': [1, *self.shape, self.cfg['nb_labels']],
              'filters': self.head['filters'],
              'kernel_size': list(self.kernel_size), 'x_itemsize': item,
              'k_itemsize': PARAM_DTYPES[self.head['param_dtype']].itemsize}
        return {'pool_fwd': pools, 'pool_bwd': pools, 'lc_fwd': [lc],
                'lc_dk': [lc], 'lc_dx': [lc]}
