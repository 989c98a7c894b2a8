"""
neurite_tpu_torch.layers — layers (counterpart of `neurite_tpu.layers`; so
far the random augmentation layers of the synthesis path).
"""
from neurite_tpu_torch.layers import random  # noqa: F401
from neurite_tpu_torch.layers.random import (  # noqa: F401
    GaussianBlur, GaussianNoise, PerlinNoise, RandomCrop, Subsample,
)
