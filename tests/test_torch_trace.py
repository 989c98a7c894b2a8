"""
The port's spans (`neurite_tpu_torch.trace`): the shared no-op while no
profiler records, and under `torch.profiler.profile` the ranges
'neurite/...' that the train step and `fit` open, in their order and
number (the layers' spans: `test_torch_trace_layers.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import trace, training  # noqa: E402

torch.set_num_threads(1)

UNET = dict(nb_features=2, nb_levels=3, conv_size=3, nb_labels=2,
            feat_mult=1, nb_conv_per_level=1)


def _unet(vol=8, **kw):
    return nt.models.unet(input_shape=(vol,) * 3 + (1,), device='cpu',
                          **dict(UNET, **kw),
                          generator=torch.Generator().manual_seed(0))


def _batch(seed, vol=8, nb_labels=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, vol, vol, vol, 1)).astype(np.float32)
    y = np.eye(nb_labels, dtype=np.float32)[
        rng.integers(0, nb_labels, size=(1, vol, vol, vol))]
    return torch.from_numpy(x), torch.from_numpy(y)


def _spans(prof):
    """[(name, start, end)] of the port's ranges, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith(('neurite/', 'train/'))),
                  key=lambda e: (e[1], -e[2]))


def _names(prof):
    return [n for n, _, _ in _spans(prof)]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_span_is_the_shared_noop_without_a_profiler():
    assert not trace.recording()
    assert trace.span('train/step', 3) is trace.OFF
    assert trace.span('seg/apply') is trace.OFF
    assert training.annotate_step(3) is trace.OFF
    with trace.span('x') as a, trace.span('y') as b:
        assert a is None and b is None


def test_span_names_and_args_under_the_profiler():
    ranges = []

    def body():
        for name, args in (('seg/apply', 7), ('synth/perlin', None)):
            s = trace.span(name, args)
            ranges.append(s)
            with s:
                torch.ones(4).sum()

    prof = _profiled(body)
    assert _names(prof) == ['neurite/seg/apply', 'neurite/synth/perlin']
    assert [(r.name, r.args) for r in ranges] == [
        ('neurite/seg/apply', '7'), ('neurite/synth/perlin', None)]
    # each range holds the op run inside it
    (_, s0, e0), _ = _spans(prof)
    ops = [e for e in prof.events() if e.name == 'aten::ones']
    assert s0 <= ops[0].time_range.start <= e0
    assert not trace.recording()


@pytest.mark.parametrize('checked', [False, True])
def test_train_step_phases(checked):
    """One step: 'train/step' holds forward, loss, backward and optimizer
    in that order; the checked step adds 'train/check' after it."""
    state = training.create_train_state(_unet(), training.adam(1e-3))
    loss = nt.losses.SoftDice().loss
    step = (training.make_checked_train_step(loss) if checked
            else training.make_train_step(loss))
    batch = _batch(0)
    prof = _profiled(lambda: step(state, batch))
    spans = [s for s in _spans(prof) if s[0].startswith('neurite/train/')]
    names = [n[len('neurite/'):] for n, _, _ in spans]
    assert names == ['train/step', 'train/forward', 'train/loss',
                     'train/backward', 'train/optimizer'] + (
                         ['train/check'] if checked else [])
    _, lo, hi = spans[0]
    for n, s, e in spans[1:5]:
        assert lo <= s <= e <= hi, n
    for (_, _, e), (_, s, _) in zip(spans[1:5], spans[2:5]):
        assert e <= s
    if checked:
        assert spans[5][1] >= hi
    assert state.step == 1


@pytest.mark.parametrize('callbacks', [False, True])
def test_fit_spans(callbacks):
    """`fit`: one 'fit/next_batch' and one 'train/{step}' a step, the step's
    own 'train/step' inside the latter; 'fit/callbacks' only when there
    are logs to read."""
    state = training.create_train_state(_unet(), training.adam(1e-3))
    step = training.make_train_step(nt.losses.SoftDice().loss)
    batches = iter([_batch(i) for i in range(3)])

    class Record:
        def on_batch_end(self, i, state, logs):
            assert np.isfinite(logs['loss'])

    cbs = [Record()] if callbacks else []
    prof = _profiled(lambda: training.fit(state, step, batches, 3,
                                          callbacks=cbs, start_step=5))
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert [n for n in names if n.startswith('train/')] == [
        'train/5', 'train/6', 'train/7']
    assert names.count('neurite/fit/next_batch') == 3
    assert names.count('neurite/fit/callbacks') == (3 if callbacks else 0)
    assert names.count('neurite/train/step') == 3
    marks = [s for s in spans if s[0].startswith('train/')]
    inner = [s for s in spans if s[0] == 'neurite/train/step']
    for (_, lo, hi), (_, s, e) in zip(marks, inner):
        assert lo <= s <= e <= hi
    # the feed's wait precedes its step
    feeds = [s for s in spans if s[0] == 'neurite/fit/next_batch']
    for (_, _, e), (_, lo, _) in zip(feeds, marks):
        assert e <= lo
