"""
The port's Adam (`ops/adam.py`, what `training.adam` builds) on the CPU,
where it runs its plain version: against optax.adam and torch.optim.Adam,
bfloat16 leaves against a float32 Adam rounded once per stored value,
state dicts passing to and from torch.optim.Adam, step hooks, the
options it refuses, and `plan`'s choice of K11's body. K11 itself runs
on the card: `tests/test_torch_adam_cuda.py`.
"""
import copy
import io

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from torch.optim.adam import adam as functional_adam  # noqa: E402

from neurite_tpu_torch import training  # noqa: E402
from neurite_tpu_torch.ops import adam  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(3, 3, 3, 1, 4), (4,), (7, 5), (1001,)]
LR = 1e-2


def _params(seed, dtype=torch.float32, shapes=SHAPES):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype).requires_grad_()
            for s in shapes]


def _grads(seed, step, shapes=SHAPES):
    rng = np.random.default_rng([seed, step])
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g).to(p.dtype)


def _state(opt, p):
    s = opt.state[p]
    return s['step'], s['exp_avg'], s['exp_avg_sq']


def test_plain_matches_optax_over_three_steps():
    """Float32 leaves, both handed the same gradients, as
    `test_torch_training.py`'s Adam step does: the parameters agree to
    float32 rounding, rtol 1e-6, and to atol 3e-5 lr where an update moves
    by part of itself: optax computes 1 - b2^t in float32, where 0.999 is
    0.99900001, so 1 - b2 is off by 4.7e-5 of itself and an update by up
    to half that."""
    params = _params(0)
    want = [jnp.asarray(p.detach().numpy().copy()) for p in params]
    tx = optax.adam(1e-3)
    opt_state = tx.init(want)
    opt = adam.Adam(params, lr=1e-3)

    @jax.jit
    def step(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    for t in range(3):
        grads = _grads(0, t)
        _set_grads(params, grads)
        opt.step()
        want, opt_state = step([jnp.asarray(g) for g in grads], opt_state,
                               want)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=3e-5 * 1e-3)


@pytest.mark.parametrize('skip', [False, True])
def test_plain_is_bit_equal_to_torch_adam(skip):
    """Float32 leaves: parameters and the whole state bit-equal to
    torch.optim.Adam's over three steps; with `skip`, one leaf has no
    gradient in the second step, so the leaves' step counts differ."""
    ours, theirs = _params(1), _params(1)
    opt = adam.Adam(ours, lr=LR, betas=(0.8, 0.99), eps=1e-6)
    ref = torch.optim.Adam(theirs, lr=LR, betas=(0.8, 0.99), eps=1e-6)
    for t in range(3):
        for ps in (ours, theirs):
            _set_grads(ps, _grads(1, t))
            if skip and t == 1:
                ps[0].grad = None
        opt.step()
        ref.step()
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
        for x, y in zip(_state(opt, a), _state(ref, b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert float(opt.state[ours[0]]['step']) == (2. if skip else 3.)


def test_bfloat16_leaves_round_once_per_stored_value():
    """Bfloat16 leaves: each step equals torch's float32 Adam on float32
    copies of the stored parameter, gradient and moments, rounded once to
    bfloat16, bit for bit."""
    params = _params(2, torch.bfloat16)
    opt = adam.Adam(params, lr=LR)
    held = [p.detach().clone() for p in params]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in held]
    for t in range(3):
        grads = _grads(2, t)
        _set_grads(params, grads)
        opt.step()
        for i, p in enumerate(params):
            f = [x.float() for x in (held[i], params[i].grad, *moments[i])]
            functional_adam([f[0]], [f[1]], [f[2]], [f[3]], [],
                            [torch.tensor(float(t))], foreach=False,
                            amsgrad=False, beta1=0.9, beta2=0.999, lr=LR,
                            weight_decay=0., eps=1e-8, maximize=False)
            held[i] = f[0].to(torch.bfloat16)
            moments[i] = (f[2].to(torch.bfloat16), f[3].to(torch.bfloat16))
            _, m, v = _state(opt, p)
            assert p.dtype == m.dtype == v.dtype == torch.bfloat16
            assert torch.equal(p.detach(), held[i])
            assert torch.equal(m, moments[i][0])
            assert torch.equal(v, moments[i][1])


@pytest.mark.parametrize('first', ['torch', 'port'])
def test_state_dict_continues_bit_equal(first):
    """Two steps by one optimizer, its state dict saved and loaded into the
    other (torch.optim.Adam and the port's, either way round), two steps
    more: bit-equal to four steps of the first without a stop."""
    kinds = {'torch': torch.optim.Adam, 'port': adam.Adam}
    then = 'port' if first == 'torch' else 'torch'
    straight = _params(3)
    ref = kinds[first](straight, lr=LR)
    for t in range(4):
        _set_grads(straight, _grads(3, t))
        ref.step()
    params = _params(3)
    opt = kinds[first](params, lr=LR)
    for t in range(2):
        _set_grads(params, _grads(3, t))
        opt.step()
    buf = io.BytesIO()
    torch.save({'params': [p.detach() for p in params],
                'optimizer': opt.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf)
    resumed = [p.clone().requires_grad_() for p in saved['params']]
    opt2 = kinds[then](resumed, lr=1.)    # the loaded groups set lr
    opt2.load_state_dict(saved['optimizer'])
    for t in range(2, 4):
        _set_grads(resumed, _grads(3, t))
        opt2.step()
    for a, b in zip(resumed, straight):
        assert torch.equal(a, b)
        for x, y in zip(_state(opt2, a), _state(ref, b)):
            assert torch.equal(x, y)


def test_step_pre_hook_runs_before_the_update():
    """A step pre-hook that doubles the gradients (as the data-parallel
    step's hook averages them) gives the update of doubled gradients."""
    hooked, plain = _params(4), _params(4)
    opt = adam.Adam(hooked, lr=LR)
    ref = adam.Adam(plain, lr=LR)
    seen = []

    def double(optimizer, args, kwargs):
        seen.append(len(optimizer.state))
        for p in hooked:
            p.grad.mul_(2.)

    opt.register_step_pre_hook(double)
    for t in range(2):
        grads = _grads(4, t)
        _set_grads(hooked, grads)
        _set_grads(plain, [2. * g for g in grads])
        opt.step()
        ref.step()
    assert seen == [0, len(SHAPES)]
    for a, b in zip(hooked, plain):
        assert torch.equal(a, b)


def test_closure_and_a_group_without_gradients():
    """`step(closure)` returns the closure's loss; a group none of whose
    parameters has a gradient is left as it is."""
    params = _params(5)
    opt = adam.Adam([{'params': params[:2]}, {'params': params[2:]}], lr=LR)
    before = [p.detach().clone() for p in params]

    def closure():
        opt.zero_grad()
        loss = (params[0] ** 2).sum() + params[1].sum()
        loss.backward()
        return loss

    loss = opt.step(closure)
    assert float(loss.detach()) == float((before[0] ** 2).sum()
                                         + before[1].sum())
    assert not torch.equal(params[0], before[0])
    for p, b in zip(params[2:], before[2:]):
        assert torch.equal(p, b) and p not in opt.state


@pytest.mark.parametrize('case', [
    # (name, pointers, numel, itemsize, body)
    ('bf16 aligned, 8k', (0, 16, 32, 4096), 8 * 1024, 2, 'vec'),
    ('f32 aligned, 4k', (512, 1024, 2048, 4096), 4 * 1024, 4, 'vec'),
    ('bf16 ragged', (0, 16, 32, 48), 1003, 2, 'scalar'),
    ('f32 ragged', (0, 16, 32, 48), 1001, 4, 'scalar'),
    ('f32 gradient 4 bytes off', (0, 20, 32, 48), 4096, 4, 'scalar'),
    ('bf16 moment 2 bytes off', (0, 16, 34, 48), 4096, 2, 'scalar'),
    # config #3's head kernel [1, 108, 160^3] and a bfloat16 tensor past
    # 2^31 bytes, from their shapes alone
    ('head kernel', (0, 16, 32, 48), 108 * 160 ** 3, 2, 'vec'),
    ('bf16 past 2^31 bytes', (0, 16, 32, 48), 2 ** 30 + 8, 2, 'vec'),
    ('f32 past 2^31 bytes, ragged', (0, 16, 32, 48), 2 ** 29 + 1, 4,
     'scalar'),
], ids=lambda c: c[0])
def test_plan_picks_the_body(case):
    _, ptrs, numel, itemsize, body = case
    assert adam.plan(ptrs, numel, itemsize) == body


@pytest.mark.parametrize('option', [dict(weight_decay=0.1),
                                    dict(amsgrad=True), dict(maximize=True)],
                         ids=lambda o: next(iter(o)))
def test_unsupported_options_raise(option):
    """At construction, and at a step whose group, loaded from
    torch.optim.Adam's state dict, sets the option."""
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        adam.Adam(_params(6), lr=LR, **option)
    theirs = _params(6)
    ref = torch.optim.Adam(theirs, lr=LR, **option)
    params = _params(6)
    opt = adam.Adam(params, lr=LR)
    opt.load_state_dict(ref.state_dict())
    _set_grads(params, _grads(6, 0))
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        opt.step()


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA launcher takes no CPU tensor and no other dtype: it raises,
    and never falls back to the plain version."""
    p = torch.zeros(8)
    for x in (p, p.half()):
        with pytest.raises(ValueError, match='float32 or bfloat16 CUDA'):
            adam.adam_cuda([x], [x], [x], [x], 1, LR, 0.9, 0.999, 1e-8)


def test_training_adam_keeps_torch_adams_defaults_and_state():
    """`training.adam` builds the port's Adam with torch.optim.Adam's
    defaults and, after a step, its state keys and dtypes: 'step' a CPU
    float tensor, the moments in each parameter's dtype."""
    params = _params(7, shapes=[(4, 4)]) + _params(7, torch.bfloat16,
                                                   shapes=[(16,)])
    opt = training.adam(LR, b1=0.8, b2=0.99, eps=1e-7)(params)
    ref = torch.optim.Adam(params, lr=LR, betas=(0.8, 0.99), eps=1e-7)
    assert isinstance(opt, adam.Adam)
    assert {k: opt.defaults[k] for k in opt.defaults} == {
        k: ref.defaults[k] for k in opt.defaults}
    _set_grads(params, [np.ones((4, 4), np.float32),
                        np.ones(16, np.float32)])
    opt.step()
    for p in params:
        s = opt.state[p]
        assert sorted(s) == ['exp_avg', 'exp_avg_sq', 'step']
        assert s['step'].device.type == 'cpu' and s['step'].ndim == 0
        assert s['step'].dtype == torch.get_default_dtype()
        assert s['exp_avg'].dtype == s['exp_avg_sq'].dtype == p.dtype


@pytest.mark.parametrize('case', [
    ('contiguous', lambda: torch.zeros(4, 3, 5), True),
    ('channels-last conv weight', lambda: torch.zeros(
        4, 3, 3, 3, 8).permute(0, 4, 1, 2, 3), True),
    ('size-1 dims anywhere', lambda: torch.zeros(1, 6, 1).transpose(0, 2),
     True),
    ('a slice with gaps', lambda: torch.zeros(4, 6)[:, :3], False),
    ('an expanded, overlapping view', lambda: torch.zeros(4, 1).expand(4, 3),
     False),
], ids=lambda c: c[0])
def test_dense_layouts(case):
    """K11 updates four tensors of one layout as flat arrays: it takes a
    parameter whose elements fill numel consecutive places in some order
    of its dims, and no other."""
    _, make, dense = case
    assert adam._dense(make()) is dense


def test_deep_copy_steps_as_the_original():
    """A deep copy (state and groups through `__setstate__`) takes the
    same next step as the optimizer it was copied from."""
    params = _params(8)
    opt = adam.Adam(params, lr=LR)
    _set_grads(params, _grads(8, 0))
    opt.step()
    twin = copy.deepcopy(opt)      # its own copies of the parameters
    twin_params = twin.param_groups[0]['params']
    assert twin_params[0] is not params[0]
    for ps in (params, twin_params):
        _set_grads(ps, _grads(8, 1))
    opt.step()
    twin.step()
    for a, b in zip(params, twin_params):
        assert torch.equal(a, b)
