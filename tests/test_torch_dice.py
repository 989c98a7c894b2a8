"""
The PyTorch port's Dice sums and Dice metrics/losses against the JAX
package's, on the same numpy inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu import ops as jops  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, dice_red  # noqa: E402

torch.set_num_threads(1)


def _maps(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    return x, y


def _torch_sums_and_grads(x, y, w, impl):
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    sums = nt.ops.dice_sums(xt, yt, impl=impl)
    loss = sum((torch.from_numpy(wi) * s).sum() for wi, s in zip(w, sums))
    dx, dy = torch.autograd.grad(loss, (xt, yt))
    return [s.detach().numpy() for s in sums], (dx.numpy(), dy.numpy())


@pytest.mark.parametrize('jax_impl,interpret', [('pallas', True), ('jnp', False)])
def test_plain_dice_sums_match_jax(jax_impl, interpret):
    x, y = _maps(0, (2, 1000, 3))       # V not a multiple of the TPU chunk
    w = [np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
         for _ in range(3)]

    def jloss(a, b):
        sums = jops.dice_sums(a, b, impl=jax_impl, interpret=interpret)
        return sum(jnp.sum(wi * s) for wi, s in zip(w, sums)), sums

    (_, jsums), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(x, y)
    for impl in ('plain', 'auto', 'kernel', 'jnp', 'pallas'):
        tsums, tgrads = _torch_sums_and_grads(x, y, w, impl)
        # rtol 1e-6: f32 sums of 1000 terms, added in another order
        for a, b in zip(tsums, jsums):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
        # the gradients are elementwise formulas of the same inputs
        for a, b in zip(tgrads, jgrads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_dice_sums_validation():
    x, y = _maps(2, (1, 10, 2))
    with pytest.raises(ValueError, match='impl'):
        nt.ops.dice_sums(torch.from_numpy(x), torch.from_numpy(y), impl='xla')
    with pytest.raises(ValueError, match='CUDA'):
        dice_red.dice_sums_cuda(torch.from_numpy(x), torch.from_numpy(y))
    # K3's launch shape: whole label groups per block, at most 1024 blocks
    for n_vox, nb_labels in [(128 ** 3, 4), (10, 3), (1000, 300), (7, 1024)]:
        threads, nblk = dice_red._launch_shape(n_vox, nb_labels)
        assert threads % nb_labels == 0 and threads <= 1024
        assert 1 <= nblk <= 1024


def _onehot(labels, n):
    return np.eye(n, dtype=np.float32)[labels]


def _dice_inputs(kind):
    rng = np.random.default_rng(3)
    shape = (2, 6, 5, 4)
    nb = 3
    if kind == 'max_label':
        return (rng.integers(0, nb, size=shape),
                rng.integers(0, nb, size=shape), nb)
    t = _onehot(rng.integers(0, nb, size=shape), nb)
    p = rng.random(shape + (nb,)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    if kind == 'absent':
        # label 2 absent from both: bottom == 0 -> dice 0
        t[..., 2] = 0.
        p[..., 2] = 0.
    return t, p, nb


CASES = {
    'soft': ('SoftDice', dict(), 'prob'),
    'soft_laplace': ('SoftDice', dict(laplace_smoothing=0.5), 'prob'),
    'soft_weights': ('SoftDice', dict(weights=[[1., 2., .5], [0., 1., 3.]]),
                     'prob'),
    'soft_normalize': ('SoftDice', dict(normalize=True), 'prob'),
    'soft_bottom_zero': ('SoftDice', dict(), 'absent'),
    'hard_prob': ('HardDice', dict(nb_labels=3, input_type='prob'), 'prob'),
    'hard_max_label': ('HardDice', dict(nb_labels=3), 'max_label'),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_dice_metrics_and_losses_match_jax(case):
    cls, kw, kind = CASES[case]
    t, p, _ = _dice_inputs(kind)
    tt, pt = torch.from_numpy(t), torch.from_numpy(p)
    for mod_j, mod_t in ((ne.metrics, nt.metrics), (ne.losses, nt.losses)):
        dj = getattr(mod_j, cls)(**kw)
        dt = getattr(mod_t, cls)(**kw)
        # rtol 1e-6: per-label sums over 120 voxels in another order
        np.testing.assert_allclose(dt.dice(tt, pt).numpy(),
                                   np.asarray(dj.dice(t, p)), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(dt.mean_dice(tt, pt)),
                                   float(dj.mean_dice(t, p)), rtol=1e-6)
    lj = getattr(ne.losses, cls)(**kw).loss(t, p)
    lt = getattr(nt.losses, cls)(**kw).loss(tt, pt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(
        float(getattr(nt.losses, cls)(**kw).mean_loss(tt, pt)), float(lj),
        rtol=1e-6)


def test_soft_dice_loss_grad_matches_jax():
    t, p, _ = _dice_inputs('prob')
    gj = jax.grad(lambda q: ne.losses.SoftDice().loss(t, q))(p)
    pt = torch.from_numpy(p).requires_grad_()
    (gt,) = torch.autograd.grad(nt.losses.SoftDice().loss(
        torch.from_numpy(t), pt), pt)
    # rtol 1e-5 / atol 1e-8: the sums behind each gradient differ in order
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-8)


def test_check_limits():
    t, p, _ = _dice_inputs('prob')
    bad = torch.from_numpy(p) * 2.
    with pytest.raises(ValueError, match='outside range'):
        nt.losses.SoftDice().loss(torch.from_numpy(t), bad)
    # check_input_limits=False skips the host check, as on the hot path
    nt.losses.SoftDice(check_input_limits=False).loss(torch.from_numpy(t), bad)
    # 'checkify' outside a checked step raises at once, as JAX's eager check
    with pytest.raises(nt.checkify.CheckError,
                       match=r'x: value outside range \[0.0, 1.0\]'):
        nt.metrics._check_limits(bad, 'x', 'checkify')
    with pytest.raises(ValueError, match='nb_labels'):
        nt.metrics.Dice(dice_type='hard', input_type='max_label')
    with pytest.raises(ValueError, match='probabilistic'):
        nt.metrics.Dice(dice_type='soft', input_type='max_label')


@pytest.mark.parametrize('shape,ptrs,want', [
    # the flagship's L = 4 and config #5's L = 16 at 128^3
    ((1, 128 ** 3, 4), (0, 512), ('vec', 512, 264, 170)),
    ((1, 128 ** 3, 16), (0, 512), ('vec', 512, 264, 42)),
    # few voxels: as many blocks as give each thread 4 float4s
    ((1, 4096, 4), (0, 512), ('vec', 512, 2, 2)),
    ((2, 100000, 8), (0, 512), ('vec', 512, 98, 42)),
    ((2, 1000, 8), (0, 512), ('vec', 512, 1, 1)),
    # L / 4 does not divide 512: whole label groups a block
    ((3, 50, 12), (16, 32), ('vec', 510, 1, 1)),
    ((3, 17, 300), (0, 512), ('vec', 450, 1, 1)),
    # more float4 columns of partials than threads: passes of 512
    ((1, 10, 1024), (16, 32), ('vec', 512, 2, 1)),
    # many rows: fewer blocks a row
    ((1000, 4096, 4), (0, 512), ('vec', 512, 1, 1)),
    # L not a multiple of 4, a pointer off 16 bytes, 2^31 elements a row
    ((2, 1000, 3), (0, 512), ('scalar',) + dice_red._launch_shape(1000, 3)),
    ((3, 17, 299), (0, 512), ('scalar',) + dice_red._launch_shape(17, 299)),
    ((1, 4096, 4), (4, 512), ('scalar',) + dice_red._launch_shape(4096, 4)),
    ((1, 2 ** 29, 4), (0, 512),
     ('scalar',) + dice_red._launch_shape(2 ** 29, 4)),
])
def test_dice_plan(shape, ptrs, want):
    p = dice_red.plan(*shape, ptrs)
    assert (p.body, p.threads, p.nblk) == want[:3]
    if p.body == 'scalar':
        assert p.fin is None
        return
    assert p.fin == want[3]
    bs, n_vox, nb_labels = shape
    # a block's stride through a row is whole label groups of float4s, so
    # a thread keeps its 4 labels; the final threads fit the block
    l4 = nb_labels // 4
    assert p.threads % l4 == 0 and p.threads <= dice_red.THREADS
    assert 1 <= p.fin <= p.nblk
    assert p.fin * min(3 * l4 * bs, p.threads) <= p.threads
    assert p.nblk <= max(1, -(-dice_red.BLOCKS // bs))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 1000, 3), (1, 4096, 4), (3, 17, 300),
                                   (3, 17, 299), (1, 64 ** 3, 16),
                                   (2, 1000, 8), (2, 100000, 8),
                                   (3, 50, 12)])
def test_dice_kernel_matches_plain_on_card(cuda, shape):
    x, y = (torch.from_numpy(a).to(cuda) for a in _maps(4, shape))
    before = _build.launches['dice_sums_vec']
    k = dice_red.dice_sums_cuda(x, y)
    vec = shape[2] % 4 == 0
    assert _build.launches['dice_sums_vec'] == before + vec
    p = dice_red._dice_sums_plain(x, y)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        # rtol 1e-5: another summation order
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.)
    # a fixed order of additions: the same bits on the next call
    for a, b in zip(k, dice_red.dice_sums_cuda(x, y)):
        assert torch.equal(a, b)
