"""
neurite_tpu_torch.utils — tensor utilities (counterpart of
`neurite_tpu.utils`).
"""
from neurite_tpu_torch.utils import core  # noqa: F401
from neurite_tpu_torch.utils import augment  # noqa: F401
from neurite_tpu_torch.utils import spatial  # noqa: F401
from neurite_tpu_torch.utils import vae  # noqa: F401
from neurite_tpu_torch.utils.core import (  # noqa: F401
    batch_channel_flatten, flatten_axes, gaussian_kernel, interpn,
    logistic, minmax_norm, resize, separable_conv, soft_delta,
    soft_digitize, soft_quantize, zoom,
)
