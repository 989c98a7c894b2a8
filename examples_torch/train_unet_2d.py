"""
Example: train a 2-D UNet segmenter on synthetic label maps (PyTorch port of
`examples/train_unet_2d.py`).

The minimum end-to-end slice (BASELINE.md config #1): the UNet constructor,
the soft Dice loss, a train step and the `fit` loop with callbacks. Runs on
the card unless main() is given device='cpu'.

Run: python examples_torch/train_unet_2d.py
"""

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend, training


def batches(device, size=64, nb_labels=4, batch=8):
    """Infinite synthetic (image, one-hot labels) batches."""
    rng = np.random.default_rng(0)
    while True:
        labels = rng.integers(0, nb_labels, size=(batch, size, size))
        image = labels[..., None] + 0.1 * rng.normal(
            size=(batch, size, size, 1))
        yield {'x': torch.as_tensor(image, dtype=torch.float32,
                                    device=device),
               'y': torch.as_tensor(np.eye(nb_labels, dtype=np.float32)[
                   labels], device=device)}


def main(device=None):
    device = backend.resolve_device(device)
    size, nb_labels = 64, 4
    model = nt.models.unet(nb_features=8, input_shape=(size, size, 1),
                           nb_levels=3, conv_size=3, nb_labels=nb_labels,
                           feat_mult=2, nb_conv_per_level=2, device=device)

    data = batches(device, size, nb_labels)
    state = training.create_train_state(model, training.adam(1e-3))

    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    state, history = training.fit(
        state, step, data, nb_steps=100, rng=1,
        callbacks=[nt.callbacks.ModelWeightCheck(),
                   nt.callbacks.CheckLossTrend(),
                   nt.callbacks.TimeHistory()],
        log_every=20)
    print('final loss:', history[-1]['loss'])
    return {'final_loss': float(history[-1]['loss'])}


if __name__ == '__main__':
    main()
