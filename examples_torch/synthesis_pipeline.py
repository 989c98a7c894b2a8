"""
Example: on-device label-map -> image synthesis (SynthMorph-style) feeding
a 3-D UNet (BASELINE.md config #5; PyTorch port of
`examples/synthesis_pipeline.py`).

Each step draws a random affine + SVF warp, per-label intensities, a bias
field, noise and blur on the device, normalizes, then takes a UNet train
step on the synthesized (image, one-hot map) pair. Runs on the card unless
main() is given device='cpu'.

Run: python examples_torch/synthesis_pipeline.py
"""

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend, training


def main(device=None):
    device = backend.resolve_device(device)
    size, nb_labels = 32, 8          # 128/16+ on the card
    gen = nt.models.labels_to_image_new(
        labels_in=list(range(nb_labels)), out_shape=(size,) * 3,
        one_hot=True, device=device)
    unet = nt.models.unet(nb_features=8, input_shape=(size,) * 3 + (1,),
                          nb_levels=3, conv_size=3, nb_labels=nb_labels,
                          device=device)

    labels = torch.as_tensor(np.random.default_rng(0).integers(
        0, nb_labels, size=(1, size, size, size, 1)), dtype=torch.int32,
        device=device)
    state = training.create_train_state(unet, training.adam(1e-3))
    loss = nt.losses.SoftDice(check_input_limits=False).loss
    base_step = training.make_train_step(loss)

    def synth_step(state, labels, generator):
        out = gen(labels, generator)
        return base_step(state, (out['image'], out['map']), generator)

    for i in range(10):
        state, metrics = synth_step(state, labels,
                                    training.step_generator(0, i, device))
        print(f'step {i}: loss {float(metrics["loss"]):.4f}')
    return {'loss': float(metrics['loss'])}


if __name__ == '__main__':
    main()
