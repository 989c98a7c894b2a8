"""
Example: data-parallel + spatially-sharded training over a mesh of ranks
(PyTorch port of `examples/multichip_training.py`).

One process a rank on torch.distributed: with an even number of ranks the
mesh is (ranks / 2) x 2, each rank holding its half of the volume along
the first spatial axis (`parallel.make_sharded_train_step` partitions the
whole model); one process runs the same code on a 1 x 1 mesh. One card a
rank under NCCL:

  torchrun --nproc-per-node=4 examples_torch/multichip_training.py

or on the CPU (gloo): `NEURITE_EXAMPLE_DEVICE=cpu torchrun ...`.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend, parallel, training


def main(device=None):
    device = backend.resolve_device(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    space = 2 if n % 2 == 0 and n > 1 else 1
    mesh = parallel.create_mesh(data=n // space, space=space, device=device)
    print('mesh:', dict(zip(mesh.mesh_dim_names, mesh.shape)))

    size, nb_labels, batch = 32, 4, max(2, n // space)
    model = nt.models.unet(nb_features=8, input_shape=(size, size, 1),
                           nb_levels=3, conv_size=3, nb_labels=nb_labels,
                           device=device)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, nb_labels, size=(batch, size, size))
    x = labels[..., None].astype(np.float32)
    y = np.eye(nb_labels, dtype=np.float32)[labels]

    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    sharded = parallel.make_sharded_train_step(step, mesh)

    batch_on_mesh = parallel.shard_batch({'x': x, 'y': y}, mesh)
    for i in range(5):
        state, metrics = sharded(state, batch_on_mesh,
                                 torch.Generator(device).manual_seed(i))
        print(f'step {i}: loss {float(metrics["loss"]):.4f}')
    return {'loss': float(metrics['loss'])}


if __name__ == '__main__':
    dev = os.environ.get('NEURITE_EXAMPLE_DEVICE')
    if 'WORLD_SIZE' in os.environ:          # started by torchrun
        if dev != 'cpu':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('gloo' if dev == 'cpu' else 'nccl')
    try:
        main(dev)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
