"""
neurite_tpu_torch.models — models and their constructors (PyTorch); counterpart of
`neurite_tpu.models`.
"""
from neurite_tpu_torch.models.unet import (  # noqa: F401
    UNet, ConvEnc, ConvDec, AddPrior,
    unet, dilation_net, conv_enc, conv_dec, add_prior, get_activation,
)
from neurite_tpu_torch.models.ae import (  # noqa: F401
    AE, SingleAE, ae, single_ae,
)
from neurite_tpu_torch.models.classify import (  # noqa: F401
    DesignDNN, EncoderNetModule, DenseLayerNetModule,
    design_dnn, EncoderNet, DenseLayerNet,
)
from neurite_tpu_torch.models.synth import (  # noqa: F401
    LabelsToImage, LabelsToImageV1, SynthStripModule,
    labels_to_image, labels_to_image_new, SynthStrip,
)
