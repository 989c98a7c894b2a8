"""neurite_tpu_torch.py — framework-free helpers (counterpart of
`neurite_tpu.py`)."""
from neurite_tpu_torch.py import utils  # noqa: F401
from neurite_tpu_torch.py import data  # noqa: F401
from neurite_tpu_torch.py import plot  # noqa: F401
