"""
neurite_tpu_torch.models — models and their constructors (PyTorch); counterpart of
`neurite_tpu.models`.
"""
from neurite_tpu_torch.models.unet import (  # noqa: F401
    UNet, ConvEnc, ConvDec, AddPrior,
    unet, dilation_net, conv_enc, conv_dec, add_prior, get_activation,
)
