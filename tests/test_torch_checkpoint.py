"""
The PyTorch port's checkpoints, checked step and profiler helpers
(`training.save_checkpoint`, `restore_checkpoint`,
`make_checked_train_step`, `profile_trace`, `annotate_step`) and
check_input_limits='checkify', against the JAX package where it has a
counterpart.

An exact resume is bit for bit: 2 steps, a save, a restore into a fresh
state and 2 more steps give the tensors of 4 uninterrupted steps. The
checked step's range-check messages are JAX's, character for character.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
from neurite_tpu import training as jtraining  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import checkify, convert, training  # noqa: E402

torch.set_num_threads(1)

CFG = dict(nb_features=4, input_shape=(8, 8, 8, 1), nb_levels=2,
           conv_size=3, nb_labels=3, feat_mult=2, nb_conv_per_level=2)


def _batch(seed, vol=8, nb_labels=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, vol, vol, vol, 1)).astype(np.float32)
    y = np.eye(nb_labels, dtype=np.float32)[
        rng.integers(0, nb_labels, size=(1, vol, vol, vol))]
    return x, y


def _state(seed, **kw):
    model = nt.models.unet(device='cpu', **CFG, **kw,
                           generator=torch.Generator().manual_seed(seed))
    return training.create_train_state(model, training.adam(1e-3))


def _tensors(state):
    """Every parameter, buffer and optimizer tensor of a state, by name."""
    out = {f'model/{k}': v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()['state'].items():
        out.update({f'opt/{i}/{k}': v for k, v in s.items()})
    return out


@pytest.mark.parametrize('remat', [False, True])
def test_exact_resume(tmp_path, remat):
    """With dropout, BatchNorm statistics and Adam's moments and step
    counts: 2 + save/restore + 2 steps equal 4 steps, bit for bit."""
    kw = dict(conv_dropout=.2, batch_norm=-1, remat=remat)
    x, y = (torch.from_numpy(a) for a in _batch(0))
    step = training.make_train_step(nt.losses.SoftDice().loss)

    def batches():
        while True:
            yield x, y

    ref, _ = training.fit(_state(1, **kw), step, batches(), 4, seed=3)
    first, _ = training.fit(_state(1, **kw), step, batches(), 2, seed=3)
    training.save_checkpoint(tmp_path / 'ckpt', first,
                             extra={'data_pos': 2, 'note': 'resume'})
    fresh = _state(2, **kw)     # other weights, no optimizer state yet
    resumed, extra = training.restore_checkpoint(tmp_path / 'ckpt', fresh)
    assert resumed is fresh and resumed.step == 2
    assert extra == {'data_pos': 2, 'note': 'resume'}
    resumed, _ = training.fit(resumed, step, batches(), 2, seed=3,
                              start_step=2)
    want, got = _tensors(ref), _tensors(resumed)
    assert want.keys() == got.keys() and resumed.step == ref.step == 4
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert any(k.endswith('exp_avg_sq') for k in got)
    assert any('bn_down_0.mean' in k for k in got)


def _jax_checked(loss, x, y, params):
    model = ne.models.unet(**CFG)
    state = jtraining.TrainState.create(model.apply, params,
                                        optax.adam(1e-3))
    step = jax.jit(jtraining.make_checked_train_step(loss))
    err, (state, metrics) = step(state, (jnp.asarray(x), jnp.asarray(y)),
                                 jax.random.PRNGKey(0))
    return err, float(metrics['loss'])


@pytest.mark.parametrize('case', ['clean', 'y_true', 'y_pred', 'nan'])
def test_checked_step_against_jax(case):
    """A clean step reports nothing; a Dice input outside [0, 1] reports
    JAX's message; a NaN input (without range checks) is caught by both, by
    JAX at the first primitive that makes a NaN and by the port at the
    loss."""
    x, y = _batch(1)
    if case == 'y_true':
        y = y * 2
    elif case == 'nan':
        x[0, 1, 2, 3, 0] = np.nan
    state = _state(4)
    params = convert.to_flax_params(state.model)
    limits = False if case == 'nan' else 'checkify'
    if case == 'y_pred':
        def scaled(loss):
            return lambda t, p: loss(t, p * 2)
    else:
        def scaled(loss):
            return loss
    jerr, jloss = _jax_checked(
        scaled(ne.losses.SoftDice(check_input_limits=limits).loss), x, y,
        params)
    step = training.make_checked_train_step(
        scaled(nt.losses.SoftDice(check_input_limits=limits).loss))
    err, (state, metrics) = step(state, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
    assert isinstance(err, checkify.Error) and err.code.dtype == torch.int32
    assert state.step == 1
    msg, jmsg = err.get(), jerr.get()
    if case == 'clean':
        assert msg is None and jmsg is None
        err.throw()
        np.testing.assert_allclose(float(metrics['loss']), jloss, rtol=1e-5)
    elif case == 'nan':
        assert jmsg.startswith('nan generated by primitive')
        assert msg == 'non-finite value in the loss'
    else:
        assert msg == jmsg == (f'{case}: value outside range [0.0, 1.0] '
                               '(`check` failed)')
    if msg is not None:
        with pytest.raises(checkify.CheckError) as e:
            err.throw()
        assert str(e.value) == msg


def test_checked_step_flags_the_update():
    """An infinite learning rate leaves the loss and gradients finite and
    makes the updated parameters non-finite: the first is reported."""
    x, y = (torch.from_numpy(a) for a in _batch(2))
    model = nt.models.unet(device='cpu', **CFG)
    state = training.create_train_state(model, training.adam(float('inf')))
    err, _ = training.make_checked_train_step(
        nt.losses.SoftDice().loss)(state, (x, y))
    first = next(n for n, _ in model.named_parameters())
    assert err.get() == f'non-finite value in {first} after the update'


def test_checked_step_flags_a_gradient():
    """A loss that stays finite with a NaN gradient (0 * sqrt at 0): the
    first parameter's gradient is reported."""
    x, y = (torch.from_numpy(a) for a in _batch(2))
    model = nt.models.unet(device='cpu', **CFG)
    state = training.create_train_state(model, training.adam(1e-3))
    dice = nt.losses.SoftDice().loss

    def loss(t, p):
        return dice(t, p) + 0. * torch.sqrt(p - p).sum()

    err, (_, metrics) = training.make_checked_train_step(loss)(state, (x, y))
    assert np.isfinite(float(metrics['loss']))
    first = next(n for n, _ in model.named_parameters())
    assert err.get() == f'non-finite gradient of {first}'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_all_finite_flags_each_tensor(dtype):
    """NaN and both infinities are flagged; large finite values (whose
    squares overflow float32) and empty tensors are not."""
    t = [torch.tensor([1., float('nan')]), torch.tensor([float('inf'), 1.]),
         torch.tensor([-float('inf')]), torch.full((1000,), 3e38),
         torch.zeros(0), torch.ones(3)]
    flags = training._all_finite([v.to(dtype) for v in t])
    assert flags.tolist() == [False, False, False, True, True, True]


def test_error_reports_the_first_failed_check():
    ok, bad = torch.tensor(True), torch.tensor(False)
    assert checkify.error([], 'cpu').get() is None
    assert checkify.error([(ok, 'a'), (ok, 'b')], 'cpu').get() is None
    err = checkify.error([(ok, 'a'), (bad, 'b'), (bad, 'c')], 'cpu')
    assert err.code.dtype == torch.int32 and int(err.code) == 2
    assert err.get() == 'b'


def test_checkify_outside_a_checked_step_raises_like_jax():
    x, y = _batch(3)
    bad = y * 2.
    with pytest.raises(Exception) as je:
        ne.losses.SoftDice(check_input_limits='checkify').loss(
            jnp.asarray(bad), jnp.asarray(y))
    with pytest.raises(checkify.CheckError) as te:
        nt.losses.SoftDice(check_input_limits='checkify').loss(
            torch.from_numpy(bad), torch.from_numpy(y))
    assert str(te.value) == str(je.value)
    # in range: no error, the same loss as with the host check
    a = nt.losses.SoftDice(check_input_limits='checkify').loss(
        torch.from_numpy(y), torch.from_numpy(y))
    assert float(a) == float(nt.losses.SoftDice().loss(
        torch.from_numpy(y), torch.from_numpy(y)))
    # MutualInformation's maps check non-negativity the same way
    mi = nt.metrics.MutualInformation(check_input_limits='checkify')
    with pytest.raises(checkify.CheckError, match=r'x: value outside range'):
        mi.maps(-torch.from_numpy(y), torch.from_numpy(y))


def test_profile_trace_and_annotate_step(tmp_path):
    x, y = (torch.from_numpy(a) for a in _batch(4))
    state = _state(5)
    step = training.make_train_step(nt.losses.SoftDice().loss)
    with training.profile_trace(str(tmp_path)):
        for i in range(2):
            with training.annotate_step(i):
                state, _ = step(state, (x, y))
    files = [f for f in os.listdir(tmp_path) if f.endswith('.json')]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'train/0', 'train/1'} <= names
