"""
neurite_tpu_torch.layers — layers (counterpart of `neurite_tpu.layers`; so
far the random augmentation layers of the synthesis path and the local
layers of `local.py`, LocallyConnected among them).
"""
from neurite_tpu_torch.layers import local, random  # noqa: F401
from neurite_tpu_torch.layers.local import (  # noqa: F401
    LocalBias, LocalCrossLinear, LocalCrossLinearTrf, LocalLinear, LocalParam,
    LocalParamLayer, LocalParamWithInput, LocallyConnected,
    LocallyConnected1D, LocallyConnected2D, LocallyConnected3D,
)
from neurite_tpu_torch.layers.random import (  # noqa: F401
    GaussianBlur, GaussianNoise, PerlinNoise, RandomCrop, Subsample,
)
