"""
(V)AE latent-space analysis tools; counterpart of `neurite_tpu/utils/vae.py`
(reference `neurite/tf/utils/vae.py`).

The JAX functions take a flax module and its variables; here the model
holds its parameters, so the `variables` argument goes and a function that
changes weights (`pca_init_dense`) changes the model in place. Encodes draw
their sample noise from `generator` (a new one seeded 0 when None, as the
JAX functions default to PRNGKey(0)); decodes run in eval mode; gradients
are `torch.func.jacrev`. Host data (numpy batches) goes to `device`, the
card unless 'cpu'.
"""

import numpy as np
import torch

from neurite_tpu_torch import backend

__all__ = ['enc_output_shape', 'extract_z_dec', 'z_effect', 'sample_dec',
           'sweep_dec_given_x', 'pca_init_dense', 'pca_init_dense_from_acts',
           'latent_stats', 'flatten_intermediates', 'latent_stats_plots',
           'model_output_pca']


def _device(model):
    return next(model.parameters()).device


def _input(model, x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=_device(model))


def _generator(model, generator):
    """`generator`, or a new one seeded 0 on the model's device."""
    if generator is not None:
        return generator
    return torch.Generator(device=_device(model)).manual_seed(0)


def enc_output_shape(model, sample_input, generator=None):
    """Shape [*spatial, C] of the encoder output feeding the AE bottleneck
    (what the bottleneck decode must reconstruct — NOT the latent shape)."""
    with torch.no_grad():
        out = model(_input(model, sample_input), return_parts=True,
                    training=False, generator=_generator(model, generator))
    return tuple(out[2].shape[1:])    # (out, mid_out, enc_out)


def extract_z_dec(model, sample_input, generator=None):
    """
    Return (decode_fn, z_shape): decode_fn(z) maps latent batches to model
    outputs (eval mode), the counterpart of reference `extract_z_dec`
    (`vae.py:45-90`, which cuts a keras submodel at the sample layer).
    """
    with torch.no_grad():
        z = model(_input(model, sample_input), mode='encode', training=False,
                  generator=_generator(model, generator))

    def decode_fn(zz):
        return model(torch.as_tensor(zz, dtype=torch.float32,
                                     device=_device(model)),
                     mode='decode', training=False)

    return decode_fn, tuple(z.shape[1:])


def z_effect(decode_fn, z_mu, portion=None):
    """
    Mean absolute effect of each latent dimension on the output:
    mean_v |d out / d z_i| evaluated at `z_mu` [bs, *z_shape].

    Parity: reference `vae.py:93-128` (one `jacrev` per item).
    """
    z_mu = torch.as_tensor(z_mu, dtype=torch.float32)
    effects = []
    for z_single in z_mu:
        jac = torch.func.jacrev(lambda z: decode_fn(z[None])[0])(z_single)
        out_ndim = jac.ndim - z_single.ndim
        effects.append(jac.abs().mean(dim=tuple(range(out_ndim))))
    effects = torch.stack(effects)                  # [bs, *z_shape]
    if portion is not None:
        effects = effects[:int(portion * effects.shape[0])]
    return effects.mean(0)


def sample_dec(decode_fn, z_shape, nb_samples=1, seed=None, z_std=1.,
               sweep_dim=None, sweep_range=(-3., 3.), device=None):
    """
    Decode latent samples: random z ~ N(0, z_std) draws (from `seed`, a
    torch.Generator or an int, 0 when None), or (when `sweep_dim` is set) a
    linear sweep of one latent dimension with the others at zero. Returns
    (decoded, z).

    Parity: reference `sample_dec` (`vae.py:131-193`).
    """
    if isinstance(seed, torch.Generator):
        device = seed.device
    device = backend.resolve_device(device)
    if sweep_dim is not None:
        z = np.zeros((nb_samples,) + tuple(z_shape), np.float32)
        flat = z.reshape(nb_samples, -1)
        flat[:, sweep_dim] = np.linspace(*sweep_range, nb_samples)
        z = torch.from_numpy(flat.reshape(z.shape)).to(device)
    else:
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=device).manual_seed(
                0 if seed is None else int(seed))
        z = z_std * torch.randn((nb_samples,) + tuple(z_shape),
                                generator=gen, device=device)
    return decode_fn(z), z


def sweep_dec_given_x(model, decode_fn, x1, x2, nb_steps=10,
                      generator=None):
    """
    Decode a linear latent interpolation between the encodings of two
    inputs; both encodings draw the same sample noise (a generator of
    `generator`'s seed each, 0 when None), as the JAX function's one key
    does.

    Parity: reference `sweep_dec_given_x` (`vae.py:196-241`).
    """
    seed = 0 if generator is None else generator.initial_seed()
    with torch.no_grad():
        z1, z2 = (model(_input(model, x), mode='encode', training=False,
                        generator=torch.Generator(
                            device=_device(model)).manual_seed(seed))
                  for x in (x1, x2))
    alphas = torch.linspace(0., 1., nb_steps, device=z1.device).reshape(
        (-1,) + (1,) * z1.ndim)
    z = (1. - alphas) * z1[None] + alphas * z2[None]      # [S, bs, *z]
    z = z.reshape((-1,) + tuple(z1.shape[1:]))
    return decode_fn(z), z


def pca_init_dense(model, x_batch, mu_dense_path=('mid', 'ae_mu_enc_dense'),
                   dec_dense_path=('mid', 'ae_dense_dec'), whiten=False,
                   generator=None):
    """
    Initialize a dense (V)AE bottleneck from the PCA of the pre-bottleneck
    encoder activations of `x_batch` (see `pca_init_dense_from_acts`).
    `*_path` are attribute paths in the model naming the Dense layers
    (defaults match the AE builder). Changes the model in place and returns
    it.

    Parity: reference `pca_init_dense` / `model_output_pca`
    (`vae.py:244-375`; sklearn PCA -> numpy SVD).
    """
    with torch.no_grad():
        out = model(_input(model, x_batch), return_parts=True, training=False,
                    generator=_generator(model, generator))
    enc_out = out[2]            # (out, mid_out, enc_out) from AE.forward
    acts = enc_out.float().cpu().numpy().reshape(enc_out.shape[0], -1)
    return pca_init_dense_from_acts(model, acts, mu_dense_path,
                                    dec_dense_path, whiten=whiten)


def _module(model, path):
    for name in path:
        model = getattr(model, name)
    return model


def pca_init_dense_from_acts(model, acts, mu_dense_path, dec_dense_path,
                             whiten=False):
    """
    PCA-initialize the dense bottleneck from precomputed pre-dense
    activations `acts` [N, D], in place; returns the model.

    The mu Dense kernel [D, d] gets the top-d principal axes (scaled by
    1/sqrt(eigval) when `whiten`), its bias -W^T mean; the decode Dense
    kernel [d, D] gets the transposed axes and bias the mean, so
    decode(encode(x)) ~= the PCA reconstruction of x (reference check
    `vae.py:357-373`).
    """
    acts = np.asarray(acts, np.float64)
    acts2d = acts.reshape(acts.shape[0], -1)
    mean = acts2d.mean(0)
    _, s, vt = np.linalg.svd(acts2d - mean, full_matrices=False)

    mu_dense = _module(model, mu_dense_path)
    dec_dense = _module(model, dec_dense_path)
    d = mu_dense.kernel.shape[1]
    w = vt[:d].T                                   # [D, d]
    w_dec = vt[:d]                                 # [d, D]
    if whiten:
        scale = np.maximum(s[:d] / np.sqrt(max(acts2d.shape[0] - 1, 1)), 1e-8)
        w = w / scale
        w_dec = w_dec * scale[:, None]

    def put(param, value):
        param.copy_(torch.as_tensor(np.asarray(value, np.float32)))

    with torch.no_grad():
        put(mu_dense.kernel, w)
        put(mu_dense.bias, -mean @ w)
        put(dec_dense.kernel, w_dec)
        put(dec_dense.bias, mean)
    return model


def latent_stats(model, data_iter, nb_batches=10, generator=None):
    """
    Collect mu / log-var statistics over a generator of input batches from
    the model's intermediates (ae_mu / ae_sigma); every batch's sample
    noise comes from a generator of one seed (`generator`'s, 0 when None),
    as the JAX function's one key.

    Parity: reference `latent_stats` (`vae.py:378-404`).
    Returns dict with 'mu' [N, *z] and (if variational) 'logvar' [N, *z].
    """
    seed = 0 if generator is None else generator.initial_seed()
    mus, logvars = [], []
    for _ in range(nb_batches):
        batch = next(data_iter)
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        with torch.no_grad():
            _, inter = model(
                _input(model, x), training=False, return_intermediates=True,
                generator=torch.Generator(
                    device=_device(model)).manual_seed(seed))
        flat = flatten_intermediates(inter)
        if 'ae_mu' in flat:
            mus.append(flat['ae_mu'].float().cpu().numpy())
        if 'ae_sigma' in flat:
            logvars.append(flat['ae_sigma'].float().cpu().numpy())
    out = {}
    if mus:
        out['mu'] = np.concatenate(mus, 0)
    if logvars:
        out['logvar'] = np.concatenate(logvars, 0)
    return out


def flatten_intermediates(tree, out=None):
    """Flatten a (nested) intermediates tree to {leaf_name: last_value}."""
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            flatten_intermediates(v, out)
        else:
            out[k] = v[-1] if isinstance(v, (tuple, list)) else v
    return out


def latent_stats_plots(stats, figsize=(12, 4)):
    """
    Scatter + sorted-statistic plots of latent mu/log-var
    (ref `latent_stats_plots`, `vae.py:405-498`). Returns (fig, axes).
    """
    import matplotlib.pyplot as plt
    mu = stats['mu'].reshape(stats['mu'].shape[0], -1)
    has_lv = 'logvar' in stats
    fig, axes = plt.subplots(1, 3 if has_lv else 2, figsize=figsize)
    axes[0].scatter(mu[:, 0], mu[:, 1] if mu.shape[1] > 1 else mu[:, 0],
                    s=4, alpha=0.5)
    axes[0].set_title('latent mu scatter (dims 0,1)')
    order = np.argsort(np.abs(mu).mean(0))[::-1]
    axes[1].plot(np.abs(mu).mean(0)[order])
    axes[1].set_title('sorted mean |mu|')
    if has_lv:
        lv = stats['logvar'].reshape(stats['logvar'].shape[0], -1)
        axes[2].plot(np.sort(np.exp(lv).mean(0))[::-1])
        axes[2].set_title('sorted mean var')
    fig.tight_layout()
    return fig, axes


def model_output_pca(apply_fn, data_iter, nb_batches, nb_components=None,
                     device=None):
    """
    PCA of a model-output (or any apply_fn-output) distribution gathered over
    a generator of batches, each handed to apply_fn as a float32 tensor on
    `device` (reference `model_output_pca`, `vae.py:322-355`; sklearn PCA
    -> numpy SVD). Returns (components [k, D], explained_variance [k],
    mean [D], projected [N, k]).
    """
    device = backend.resolve_device(device)
    outs = []
    for _ in range(nb_batches):
        batch = next(data_iter)
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        with torch.no_grad():
            out = apply_fn(torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                           device=device))
        out = out.float().cpu().numpy()
        outs.append(out.reshape(out.shape[0], -1))
    data = np.concatenate(outs, 0)
    mean = data.mean(0)
    centered = data - mean
    _, s, vt = np.linalg.svd(centered, full_matrices=False)
    k = nb_components or vt.shape[0]
    var = (s ** 2) / max(data.shape[0] - 1, 1)
    return vt[:k], var[:k], mean, centered @ vt[:k].T
