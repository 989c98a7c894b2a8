"""
The MI-registration step (a moving volume warped by a trainable bounded
displacement field, soft-MI loss against a fixed volume, Adam on the field;
the step of `benchmarks/mi_context.py:32-62`) through the PyTorch port
against the JAX package at 16^3, one case per MI route: `volumes`,
`volumes_fused` 'jnp' and `volumes_fused` 'pallas' (JAX's Pallas kernel in
interpret mode; the port's kernel route with the plain forward). Each of
three steps compares the loss and the field gradient, then hands the port's
gradient to optax's Adam and to torch's and compares the updated fields.

The field starts at uniform +-2 voxel draws, not at zero: at the zero field
every sample lies on an integer coordinate, where the JAX window engine's
location gradient on the volume's upper edge differs from `core.interpn`'s,
which the port follows.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu.utils import spatial as jspatial  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.utils import spatial  # noqa: E402

torch.set_num_threads(1)

SIZE = 16
STEPS = 3
LR = 1e-2


def make_pair(size, seed=0):
    """A 3-D version of `examples/deformable_registration.py:25-37`: blobs
    at 0.45 and 0.55 of the size, widths size*0.8 and size*1.2, plus 0.02
    normal noise; [1, size^3, 1] float32 each."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing='ij'), -1)
    moving = np.exp(-((grid - size * 0.45) ** 2).sum(-1) / (size * 0.8))
    fixed = np.exp(-((grid - size * 0.55) ** 2).sum(-1) / (size * 1.2))
    moving = moving + 0.02 * rng.normal(size=moving.shape)
    fixed = fixed + 0.02 * rng.normal(size=fixed.shape)
    return (moving.astype(np.float32)[None, ..., None],
            fixed.astype(np.float32)[None, ..., None])


def start_field(size, seed=1):
    """[1, size^3, 3] float32 displacements, uniform in +-2 voxels."""
    return np.random.default_rng(seed).uniform(
        -2., 2., size=(1, size, size, size, 3)).astype(np.float32)


def _jax_loss(moving, fixed, route):
    mi = ne.metrics.MutualInformation(nb_bins=16, check_input_limits=False)

    def loss(field):
        warped = jspatial.batch_transform(moving, jnp.clip(field, -3., 3.),
                                          impl='window', max_disp=3.0)
        if route == 'volumes':
            return -jnp.mean(mi.volumes(warped, fixed))
        return -jnp.mean(mi.volumes_fused(warped, fixed, impl=route,
                                          interpret=True))
    return jax.jit(jax.value_and_grad(loss))


def _port_loss(moving, fixed, route):
    mi = nt.metrics.MutualInformation(nb_bins=16, check_input_limits=False)

    def loss(field):
        warped = spatial.batch_transform(moving, torch.clamp(field, -3., 3.),
                                         impl='window', max_disp=3.0)
        if route == 'volumes':
            return -mi.volumes(warped, fixed).mean()
        return -mi.volumes_fused(warped, fixed, impl=route).mean()
    return loss


@pytest.mark.parametrize('route', ['volumes', 'jnp', 'pallas'])
def test_registration_steps_match_jax(route):
    moving, fixed = make_pair(SIZE)
    jstep = _jax_loss(moving, fixed, route)
    loss = _port_loss(torch.from_numpy(moving), torch.from_numpy(fixed),
                      route)
    field_j = jnp.asarray(start_field(SIZE))
    field = torch.from_numpy(start_field(SIZE)).requires_grad_()
    opt = torch.optim.Adam([field], lr=LR)
    tx = optax.adam(LR)
    opt_j = tx.init(field_j)
    losses = []
    for _ in range(STEPS):
        lj, gj = jstep(field_j)
        opt.zero_grad()
        lt = loss(field)
        lt.backward()
        lt = float(lt.detach())
        # rtol 1e-5 and atol 1e-7: MI sums 4096 voxels in another order,
        # and its terms cancel
        np.testing.assert_allclose(lt, float(lj), rtol=1e-5,
                                   atol=1e-7)
        gj = np.asarray(gj)
        # within 1e-4 of the largest gradient: a sum over the whole volume
        # behind every voxel's gradient
        np.testing.assert_allclose(field.grad.numpy(), gj, rtol=0,
                                   atol=1e-4 * np.abs(gj).max())
        # Adam on both sides from the port's gradient (as
        # tests/test_torch_training.py does). atol 1e-6, 1e-4 of the step
        # size: torch adds the step in one fused op where optax rounds the
        # update first (one ulp, 2.4e-7, at |field| ~ 2), the two order
        # m_hat / (sqrt(v_hat) + eps) differently, and three steps add up
        upd, opt_j = tx.update(jnp.asarray(field.grad.numpy()), opt_j,
                               field_j)
        field_j = optax.apply_updates(field_j, upd)
        opt.step()
        np.testing.assert_allclose(field.detach().numpy(),
                                   np.asarray(field_j), rtol=0, atol=1e-6)
        losses.append(lt)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
