"""
neurite_tpu_torch.utils — tensor utilities (counterpart of
`neurite_tpu.utils`): `core` and `spatial` are star-exported, so
`nt.utils.interpn` and `nt.utils.transform` resolve; `augment`, `seg`,
`vae` and `model` are submodules.
"""
from neurite_tpu_torch.utils import core  # noqa: F401
from neurite_tpu_torch.utils.core import *  # noqa: F401,F403
from neurite_tpu_torch.utils import augment  # noqa: F401
from neurite_tpu_torch.utils.augment import (  # noqa: F401
    draw_perlin, random_blur_rescale, draw_perlin_full, draw_crop_mask,
)
from neurite_tpu_torch.utils import spatial  # noqa: F401
from neurite_tpu_torch.utils.spatial import *  # noqa: F401,F403
from neurite_tpu_torch.utils import vae  # noqa: F401
from neurite_tpu_torch.utils import seg  # noqa: F401
from neurite_tpu_torch.utils import model  # noqa: F401
from neurite_tpu_torch.utils.model import (  # noqa: F401
    stack_models, mod_submodel, sub_apply, module_paths, reset_weights,
    copy_weights, diagram, param_count,
)
