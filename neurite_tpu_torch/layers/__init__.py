"""
neurite_tpu_torch.layers — layers (counterpart of `neurite_tpu.layers`; so
far the basic layers of `basic.py` with the FFT and complex ones, the random
layers, the local layers of `local.py`, LocallyConnected among them,
`SpatiallySparse_Dense`, the streaming-statistics and the hypernetwork
layers).
"""
from neurite_tpu_torch.layers import (  # noqa: F401
    basic, hyper, local, random, sparse, stream)
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
from neurite_tpu_torch.layers.stream import MeanStream, CovStream  # noqa: F401
from neurite_tpu_torch.layers.hyper import (  # noqa: F401
    HyperConv, HyperConv2D, HyperConv3D,
    HyperConvFromDense, HyperConv2DFromDense, HyperConv3DFromDense,
    HyperDense, HyperDenseFromDense,
)
