"""
parallel — the mesh, data parallelism and explicit spatial sharding on
torch.distributed (counterpart of `neurite_tpu.parallel`).
"""
from neurite_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, SPACE_AXIS, create_mesh, batch_sharding, replicated,
    shard_batch, make_sharded_train_step, shard_batch_multihost,
    state_shardings_for,
)
from neurite_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange, sharded_conv, sharded_separable_blur, sharded_dice_sums,
    sharded_lc, sharded_bounded_warp,
)
