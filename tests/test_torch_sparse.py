"""
The PyTorch port's `layers.SpatiallySparse_Dense` against the JAX
package's, and config #4's sparse-imputation VAE (`benchmarks/vae_sparse.py`
`SparseVAE`) built from the port's public layers against the flax model and
optax.

Both encode branches run in both packages by patching
`_ENCODE_CHUNK_ELEMS`, as `tests/test_layers.py` does for the JAX package.
Weights go across by `convert.load_flax_params`; the VAE's sampling noise
is the JAX run's, recovered from its captured mu, log-var and sample.
Tolerances, float32: values within 1e-5 of their largest magnitude (the
d x d inverse and solve run in other LAPACK calls, and the Gram products sum
in another order); gradients within 1e-4 of each tensor's largest
magnitude, as the port's other step tests state.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from benchmarks.vae_sparse import SparseVAE as JaxSparseVAE  # noqa: E402
from neurite_tpu.layers import sparse as jsparse  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert  # noqa: E402
from neurite_tpu_torch.layers import sparse as tsparse  # noqa: E402
from neurite_tpu_torch.models.ae import Dense  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(seed, shape, scale=1.):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _rel_close(got, want, rel):
    """|got - want| <= rel * max|want|, elementwise."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _branch(monkeypatch, branch):
    """Pin both packages to one encode branch."""
    limit = 0 if branch == 'chunked' else 1 << 40
    monkeypatch.setattr(jsparse, '_ENCODE_CHUNK_ELEMS', limit)
    monkeypatch.setattr(tsparse, '_ENCODE_CHUNK_ELEMS', limit)


def _layers(shape, d, use_bias):
    jl = jsparse.SpatiallySparse_Dense(input_shape=shape, output_len=d,
                                       use_bias=use_bias)
    params = jax.jit(jl.init)(jax.random.PRNGKey(3),
                              [jnp.zeros((1, d))])['params']
    tl = tsparse.SpatiallySparse_Dense(shape, d, use_bias=use_bias,
                                       device='cpu')
    convert.load_flax_params(tl, params)
    return jl, tl, params


@pytest.mark.parametrize('branch', ['oneshot', 'chunked'])
@pytest.mark.parametrize('use_bias,a_fact,fractional', [
    (False, 1, False), (True, 1, False), (True, 2, False), (False, 1, True),
    (True, 3, True),
])
def test_encode_matches_jax(monkeypatch, branch, use_bias, a_fact,
                            fractional):
    """Each branch against the same JAX branch: values, and gradients of
    the parameters and of y. A fractional mask pins each branch's own
    weighting (m^2 one-shot, m chunked), which differ as in JAX."""
    _branch(monkeypatch, branch)
    shape, d = (8, 16, a_fact), 6
    jl, tl, params = _layers(shape, d, use_bias)
    rng = np.random.default_rng(4)
    y = _normal(5, (2, *shape))
    if fractional:
        mask = rng.uniform(.2, 1., size=(2, 8, 16, 1)).astype(np.float32)
        mask[rng.uniform(size=mask.shape) < .3] = 0
    else:
        mask = (rng.uniform(size=(2, 8, 16, 1)) > .4).astype(np.float32)
    r = _normal(6, (2, d))

    def jloss(p, yy):
        out = jl.apply({'params': p}, [yy, jnp.asarray(mask)])
        return jnp.sum(out * r), out

    (_, want), (gp, gy) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(y))
    yt = _t(y).requires_grad_()
    got = tl([yt, _t(mask)])
    (got * _t(r)).sum().backward()
    _rel_close(got, want, 1e-5)
    _rel_close(yt.grad, gy, 1e-4)
    gt = convert.to_flax_params(tl, grad=True)
    for p, g in _leaves(gp).items():
        _rel_close(_leaves(gt)[p], g, 1e-4)


def test_fractional_mask_branches_differ_as_in_jax(monkeypatch):
    """The one-shot branch weighs the mask squared, the chunked branch
    once: for a fractional mask they disagree, in both packages alike."""
    shape, d = (8, 16), 5
    jl, tl, params = _layers(shape, d, False)
    y = _normal(7, (1, *shape))
    mask = np.full((1, *shape), .5, np.float32)
    outs = {}
    for branch in ('oneshot', 'chunked'):
        _branch(monkeypatch, branch)
        outs[branch] = (tl([_t(y), _t(mask)]).detach(),
                        jl.apply({'params': params},
                                 [jnp.asarray(y), jnp.asarray(mask)]))
    (t1, j1), (t2, j2) = outs['oneshot'], outs['chunked']
    # wotwo scales by m^2 = 1/4 against m = 1/2 and rhs by m in both: the
    # one-shot solution is twice the chunked one, in each package
    _rel_close(t1, 2 * t2, 1e-5)
    _rel_close(j1, 2 * j2, 1e-5)


@pytest.mark.parametrize('use_bias', [False, True])
def test_decode_matches_jax(use_bias):
    shape, d = (4, 6, 5, 2), 7
    jl, tl, params = _layers(shape, d, use_bias)
    x = _normal(8, (3, d))
    r = _normal(9, (3, *shape))

    def jloss(p, xx):
        out = jl.apply({'params': p}, [xx])
        return jnp.sum(out * r), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = tl([xt])
    assert tuple(got.shape) == (3, *shape)
    (got * _t(r)).sum().backward()
    _rel_close(got, want, 1e-5)
    _rel_close(xt.grad, gx, 1e-4)
    gt = _leaves(convert.to_flax_params(tl, grad=True))
    assert gt.keys() == _leaves(gp).keys()
    for p, g in _leaves(gp).items():
        _rel_close(gt[p], g, 1e-4)


def test_init_names_and_singular_gram():
    tl = tsparse.SpatiallySparse_Dense((64, 4), 8, use_bias=True,
                                       generator=torch.Generator()
                                       .manual_seed(1), device='cpu')
    assert dict(tl.named_parameters()).keys() == {'mult_kernel',
                                                  'bias_kernel'}
    k = tl.mult_kernel.detach()
    assert k.shape == (256, 8)
    assert abs(float(k.std()) - .05) < .005 and abs(float(k.mean())) < .01
    assert nt.layers.SpatiallySparse_Dense is tsparse.SpatiallySparse_Dense
    # no host check: a singular Gram gives non-finite values, as in JAX
    with torch.no_grad():
        tl.mult_kernel.zero_()
    out = tl([torch.zeros(1, 8)])
    assert not bool(torch.isfinite(out).all())


# --- config #4's sparse VAE (benchmarks/vae_sparse.py:33-46) ---------------

class SparseVAE(torch.nn.Module):
    """`benchmarks/vae_sparse.py`'s SparseVAE from the port's public layers:
    SpatiallySparse_Dense encode, Dense mu and logvar, SampleNormalLogVar,
    the shared-weight decode. Attribute names follow the flax tree."""

    def __init__(self, shape, latent, device):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.ssd = nt.layers.SpatiallySparse_Dense(shape, latent,
                                                   generator=gen,
                                                   device=device)
        self.mu = Dense(latent, latent, generator=gen).to(device)
        self.logvar = Dense(latent, latent, generator=gen).to(device)
        self.sample = nt.layers.SampleNormalLogVar()

    def forward(self, yx, noise):
        z = self.ssd(list(yx))
        zs = self.sample.apply([self.mu(z), self.logvar(z)], noise)
        return self.ssd([zs])


def test_sparse_vae_adam_steps_match_jax():
    """Three Adam steps (1e-4) of config #4's sparse VAE at [1, 8^3, 1],
    d = 8, from the flax model's initial weights and its sampling noise."""
    size, latent = 8, 8
    shape = (size,) * 3 + (1,)
    rng = np.random.default_rng(1)
    y = rng.normal(size=(1, *shape)).astype(np.float32)
    mk = np.zeros((1, *shape), np.float32)
    mk[:, ::8] = 1.
    jm = JaxSparseVAE(shape=shape, latent=latent)
    params = jax.jit(jm.init)({'params': jax.random.PRNGKey(0),
                               'sample': jax.random.PRNGKey(9)},
                              (jnp.asarray(y), jnp.asarray(mk)))['params']

    def jloss(p, key):
        out, inter = jm.apply({'params': p}, (y, mk), rngs={'sample': key},
                              capture_intermediates=True)
        loss = jnp.sum(mk * (y - out.reshape(y.shape)) ** 2) / jnp.sum(mk)
        return loss, inter['intermediates']

    tx = optax.adam(1e-4)
    opt = tx.init(params)
    jloss_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))

    @jax.jit
    def adam_step(g, o, p):
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), o

    tm = SparseVAE(shape, latent, 'cpu')
    convert.load_flax_params(tm, params)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-4)
    yt, mt = _t(y), _t(mk)
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(5), i)
        (lj, inter), gj = jloss_grad(params, key)
        mu = np.asarray(inter['mu']['__call__'][0])
        lv = np.asarray(inter['logvar']['__call__'][0])
        zs = np.asarray(inter['sample']['__call__'][0])
        noise = (zs - mu) / np.exp(lv / 2.)
        params, opt = adam_step(gj, opt, params)

        topt.zero_grad()
        out = tm((yt, mt), _t(noise))
        loss = torch.sum(mt * (yt - out.reshape(yt.shape)) ** 2) / mt.sum()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(lj),
                                   rtol=1e-5)
        gt = _leaves(convert.to_flax_params(tm, grad=True))
        for p, g in _leaves(gj).items():
            _rel_close(gt[p], g, 1e-4)
        topt.step()
        after = _leaves(convert.to_flax_params(tm))
        for p, v in _leaves(params).items():
            # Adam moves each entry by ~1e-4 a step; its float32 rounding
            _rel_close(after[p], v, 1e-5)


def test_benchmark_weights_overflow_the_sampler_in_both_packages():
    """At 64^3, d = 64, the benchmark's initial weights give a log-variance
    near 190, so exp(lv / 2) overflows float32 and the loss is NaN in both
    packages alike (the 128^3, d = 128 step of `chip_smoke.py` phase 21 is
    further past it): the port reproduces it, and its encode, mu and
    log-variance stay finite and agree with the flax model's."""
    size, latent = 64, 64
    shape = (size,) * 3 + (1,)
    y = np.random.default_rng(1).normal(size=(1, *shape)).astype(np.float32)
    mk = np.zeros((1, *shape), np.float32)
    mk[:, ::8] = 1.
    jm = JaxSparseVAE(shape=shape, latent=latent)
    params = jax.jit(jm.init)({'params': jax.random.PRNGKey(0),
                               'sample': jax.random.PRNGKey(9)},
                              (jnp.asarray(y), jnp.asarray(mk)))['params']
    out, inter = jax.jit(lambda p: jm.apply(
        {'params': p}, (y, mk), rngs={'sample': jax.random.PRNGKey(5)},
        capture_intermediates=True))(params)
    inter = inter['intermediates']
    jloss = jnp.sum(mk * (y - out.reshape(y.shape)) ** 2) / jnp.sum(mk)
    tm = SparseVAE(shape, latent, 'cpu')
    convert.load_flax_params(tm, params)
    with torch.no_grad():
        z = tm.ssd([_t(y), _t(mk)])
        lv = tm.logvar(z)
        noise = torch.ones(1, latent)
        loss = torch.sum(_t(mk) * (_t(y) - tm((_t(y), _t(mk)), noise)
                                   .reshape(y.shape)) ** 2) / _t(mk).sum()
    _rel_close(z, inter['ssd']['__call__'][0], 1e-4)
    _rel_close(lv, inter['logvar']['__call__'][0], 1e-4)
    assert float(lv.max()) / 2 > np.log(np.finfo(np.float32).max)
    assert not np.isfinite(float(jloss)) and not np.isfinite(float(loss))
