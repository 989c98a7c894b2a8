"""
neurite_tpu_torch.layers — layers (counterpart of `neurite_tpu.layers`; so
far the basic layers of `basic.py` with the FFT and complex ones, the random
layers, the local layers of `local.py`, LocallyConnected among them, and
`SpatiallySparse_Dense`).
"""
from neurite_tpu_torch.layers import basic, local, random, sparse  # noqa: F401
from neurite_tpu_torch.layers.basic import (  # noqa: F401
    MSE, Negate, RescaleValues, Resize, SoftQuantize, Zoom,
    FFT, IFFT, FFTShift, IFFTShift, ComplexToChannels, ChannelsToComplex,
)
from neurite_tpu_torch.layers.local import (  # noqa: F401
    LocalBias, LocalCrossLinear, LocalCrossLinearTrf, LocalLinear, LocalParam,
    LocalParamLayer, LocalParamWithInput, LocallyConnected,
    LocallyConnected1D, LocallyConnected2D, LocallyConnected3D,
)
from neurite_tpu_torch.layers.random import (  # noqa: F401
    GaussianBlur, GaussianNoise, PerlinNoise, RandomClip, RandomCrop,
    SampleNormalLogVar, Subsample,
)
from neurite_tpu_torch.layers.sparse import SpatiallySparse_Dense  # noqa: F401
