"""
Example: anatomical-priors VAE with sparse-observation imputation
(BASELINE.md config #4; Dalca et al., CVPR 2018 workflow; PyTorch port of
`examples/anatomical_priors_vae.py`).

Two pieces:
1. a convolutional VAE over full volumes (prior head optional);
2. SpatiallySparse_Dense encode/decode for sparsely-observed inputs
   (e.g. sparse slice acquisitions): the same weight matrix serves a
   per-sample masked least-squares encode and a dense decode.

Runs on the card unless main() is given device='cpu'.

Run: python examples_torch/anatomical_priors_vae.py
"""

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend, training
from neurite_tpu_torch.utils import vae as vae_utils


def main(device=None):
    device = backend.resolve_device(device)
    size = 32
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, size, size, size, 1)),
                        dtype=torch.float32, device=device)

    # 1. conv VAE, trained to reconstruct
    model = nt.models.ae(nb_features=8, input_shape=(size,) * 3 + (1,),
                         nb_levels=3, conv_size=3, nb_labels=1,
                         enc_size=(4, 4, 4, 8), ae_type='conv', do_vae=True,
                         final_pred_activation='linear', device=device)
    state = training.create_train_state(model, training.adam(1e-3))
    mse = nt.losses.MeanSquaredErrorProb().loss
    step = training.make_train_step(mse, rng_names=('dropout', 'sample'))
    for i in range(10):
        state, metrics = step(state, (x, x),
                              training.step_generator(0, i, device))
    print('VAE loss:', float(metrics['loss']))

    # latent analysis: stats + decode extraction
    stats = vae_utils.latent_stats(model, iter(lambda: x, None),
                                   nb_batches=2)
    print('latent mu shape:', stats['mu'].shape)

    # 2. sparse-observation imputation layer
    layer = nt.layers.SpatiallySparse_Dense(input_shape=(size, size),
                                            output_len=16, device=device)
    y_full = torch.as_tensor(rng.normal(size=(4, size, size)),
                             dtype=torch.float32, device=device)
    mask = torch.as_tensor(rng.uniform(size=(4, size, size)) > 0.5,
                           dtype=torch.float32, device=device)
    with torch.no_grad():
        z = layer([y_full * mask, mask])       # masked lstsq encode
        recon = layer(z)                       # dense decode
    print('imputation: z', tuple(z.shape), '-> recon', tuple(recon.shape))
    return {'loss': float(metrics['loss']),
            'mu_shape': tuple(stats['mu'].shape),
            'z_shape': tuple(z.shape), 'recon_shape': tuple(recon.shape)}


if __name__ == '__main__':
    main()
