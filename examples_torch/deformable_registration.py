"""
Example: pairwise deformable registration (SVF, MI loss; PyTorch port of
`examples/deformable_registration.py`).

    phi = exp(v)  (scaling & squaring),  moved = moving o phi,
    loss = -MI(moved, fixed) + lambda * |grad v|^2

The field is optimized directly with Adam. Runs on the card unless main()
is given device='cpu'.

Run: python examples_torch/deformable_registration.py
"""

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import backend
from neurite_tpu_torch.utils import spatial


def make_pair(device, size=32, key=0):
    """Synthetic moving/fixed pair: a blob warped by a known smooth field."""
    rng = np.random.default_rng(key)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 2, indexing='ij'), -1)
    c1, c2 = size * 0.45, size * 0.55
    moving = np.exp(-((grid[..., 0] - c1) ** 2
                      + (grid[..., 1] - c1) ** 2) / (size * 0.8))
    fixed = np.exp(-((grid[..., 0] - c2) ** 2
                     + (grid[..., 1] - c2) ** 2) / (size * 1.2))
    moving += 0.02 * rng.normal(size=moving.shape)
    fixed += 0.02 * rng.normal(size=fixed.shape)
    return (torch.as_tensor(moving, dtype=torch.float32,
                            device=device)[..., None],
            torch.as_tensor(fixed, dtype=torch.float32,
                            device=device)[..., None])


def grad_l2(v):
    """Smoothness penalty: mean squared forward differences of the SVF."""
    loss = 0.
    for ax in range(v.ndim - 1):
        d = torch.diff(v, dim=ax)
        loss = loss + torch.mean(d * d)
    return loss


def main(device=None):
    device = backend.resolve_device(device)
    size = 32
    moving, fixed = make_pair(device, size)
    mi = nt.metrics.MutualInformation(nb_bins=16)

    def register_loss(vel):
        disp = spatial.integrate_vec(vel, nb_steps=5)
        moved = spatial.transform(moving, disp)
        mi_val = mi.volumes(moved[None], fixed[None])[0]
        return -mi_val + 0.05 * grad_l2(vel), mi_val

    vel = torch.zeros((size, size, 2), device=device, requires_grad=True)
    opt = torch.optim.Adam([vel], lr=0.5, eps=1e-8)

    with torch.no_grad():
        mi0 = float(register_loss(vel)[1])
    for _ in range(60):
        opt.zero_grad(set_to_none=True)
        loss, mi_val = register_loss(vel)
        loss.backward()
        opt.step()
    mi1 = float(mi_val.detach())
    with torch.no_grad():
        disp = float(spatial.integrate_vec(vel, 5).abs().max())
    print(f'MI before {mi0:.4f} -> after {mi1:.4f} (disp max {disp:.2f} vox)')
    if not mi1 > mi0 + 0.05:
        raise RuntimeError('registration failed to improve MI')
    print('OK')
    return {'mi_before': mi0, 'mi_after': mi1}


if __name__ == '__main__':
    main()
