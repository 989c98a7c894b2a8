"""
Example: SynthStrip-style brain extraction trained purely on synthetic data
(reference `neurite/tf/models.py:1888-1965`; PyTorch port of
`examples/synthstrip_training.py`): a label-map -> image generator feeds a
stripping UNet; the model output concatenates the prediction with the
synthesized ground truth so the loss needs no labels. Runs on the card
unless main() is given device='cpu'.

Run: python examples_torch/synthstrip_training.py
"""

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend, training


def loss_fn(_, out):
    """Soft Dice between sigmoid(pred) and the synthesized brain mask."""
    pred, truth = out[..., :1], out[..., 1:]
    p = torch.sigmoid(pred)
    top = 2 * torch.sum(p * truth, dim=(1, 2, 3))
    bot = torch.sum(p * p, dim=(1, 2, 3)) + torch.sum(truth * truth,
                                                      dim=(1, 2, 3))
    return -torch.mean(top / torch.clamp_min(bot, 1e-7))


def main(device=None):
    device = backend.resolve_device(device)
    size, nb_gen_labels = 32, 6
    model = nt.models.SynthStrip(
        inshape=(size, size), labels_in=list(range(nb_gen_labels)),
        labels_out=[1, 2],                 # brain labels to strip to
        nb_unet_features=8, nb_unet_levels=3, device=device)

    rng = np.random.default_rng(0)
    labels = torch.as_tensor(rng.integers(0, nb_gen_labels,
                                          size=(2, size, size, 1)),
                             dtype=torch.int32, device=device)
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(loss_fn)
    for i in range(10):
        state, metrics = step(state, (labels, labels),
                              training.step_generator(0, i, device))
        if i % 3 == 0:
            print(f'step {i}: loss {float(metrics["loss"]):.4f}')
    return {'loss': float(metrics['loss'])}


if __name__ == '__main__':
    main()
