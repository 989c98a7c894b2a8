"""
The UNet trunk feeding a LocallyConnected3D head: the repository's config #3
("conv encoder-decoder with LocallyConnected3D head on 160^3 volumes",
`bench.py:335-372`, `benchmarks/lc_head.py`), whose head has a 3x3x3 kernel
of its own at every output voxel (neurite's `LocallyConnected3D`, reference
`neurite/tf/layers.py:811-1532`).

Attribute names follow the flax tree of the JAX package's model
(`ne.models.unet` drops its name, so flax calls the trunk UNet_0), so
`convert` and `parallel`'s `param_specs` for the head apply as they are.
"""

import torch
import torch.nn as nn

from neurite_tpu_torch.layers import local as local_layers
from neurite_tpu_torch.models.unet import unet

__all__ = ['UNetLC', 'unet_lc']


class UNetLC(nn.Module):
    """
    `UNet_0` (a `UNet`) then `lc` (a `LocallyConnected3D` on the trunk's
    prediction). It computes nothing of its own, so under spatial sharding
    it is a 'local' container (`parallel.spatial`).
    """

    spatial_rule = 'local'

    def __init__(self, trunk, head):
        super().__init__()
        self.UNet_0 = trunk
        self.lc = head

    def forward(self, x, training=None, generator=None):
        """x [B, *spatial, C] -> [B, *out, filters]; `generator` draws the
        trunk's dropout masks."""
        return self.lc(self.UNet_0(x, training=training, generator=generator))


def unet_lc(input_shape=(160, 160, 160, 1), nb_features=8, nb_levels=3,
            conv_size=3, nb_labels=4, feat_mult=2, nb_conv_per_level=1,
            final_pred_activation='linear', dtype=torch.bfloat16, filters=1,
            kernel_size=3, padding='same', param_dtype=torch.bfloat16,
            generator=None, device=None):
    """
    Build config #3: `models.unet` with the trunk's settings (compute type
    `dtype` over float32 parameters, the pool kernel K1/K2), then
    `LocallyConnected3D(filters, kernel_size, padding)` with parameters in
    `param_dtype` on its prediction. The defaults are bench.py's: at 160^3
    a 43,532-parameter trunk and a 446,464,000-parameter head, bfloat16.
    One `generator` (seed 0 when none is given) draws the trunk's
    parameters, then the head's.
    """
    generator = generator or torch.Generator().manual_seed(0)
    spatial = tuple(int(s) for s in input_shape[:-1])
    trunk = unet(nb_features=nb_features, input_shape=input_shape,
                 nb_levels=nb_levels, conv_size=conv_size,
                 nb_labels=nb_labels, feat_mult=feat_mult,
                 nb_conv_per_level=nb_conv_per_level,
                 final_pred_activation=final_pred_activation, dtype=dtype,
                 pool_impl='kernel', generator=generator, device=device)
    head = local_layers.LocallyConnected3D(
        filters=filters, kernel_size=kernel_size, padding=padding,
        input_shape=(*spatial, nb_labels), param_dtype=param_dtype,
        generator=generator, device=device)
    return UNetLC(trunk, head)
