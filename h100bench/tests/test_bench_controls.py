"""The comparison that decides `correct` fails what it must, at small
sizes on the CPU against each cell's own limits: the control (the reference in
the precision below the configuration's, in the program's place), a
step that returns its state unchanged, and a served answer altered where
it is produced; and a sound run passes."""

import time

import pytest

from h100bench import calibrate, compare, harness

TRAIN = ['flagship-train-mem', 'synthstrip-train']


def _cell(sizes, monkeypatch):
    orig = harness.Cell.__init__

    def init(self, w, seed, trace, device, bench=None, overrides=None,
             files=None):
        orig(self, w, seed, trace, device, bench, sizes[w], files)
    monkeypatch.setattr(harness.Cell, '__init__', init)


@pytest.mark.parametrize('workload', TRAIN + ['flagship-serve-256'])
def test_sound_run_is_correct(workload, small):
    r = harness.run(workload, 2 ** 31 + 11, 0.3, 0, 'cpu', time.time(),
                    overrides=small[workload], log=lambda s: None)
    assert r['correct'], r['compared']


@pytest.mark.parametrize('workload', TRAIN + ['flagship-serve-256'])
def test_control_is_not_correct(workload, control_sizes, monkeypatch):
    _cell(control_sizes, monkeypatch)
    r = calibrate.readings(workload, 21, True, 'cpu')
    cell = harness.Cell(workload, 21, False, 'cpu')
    ok, compared = compare.verdict(r['numbers'], cell.limits)
    assert not ok, compared


@pytest.mark.parametrize('workload', TRAIN)
def test_state_left_unchanged_is_not_correct(workload, small, monkeypatch):
    import neurite_tpu_torch as nt
    real = nt.training.make_train_step

    def frozen(loss_fn, **kw):
        step = real(loss_fn, **kw)

        def run(state, batch, generator=None):
            saved = {k: v.detach().clone() for k, v in
                     state.model.state_dict().items()}
            state, m = step(state, batch, generator)
            state.model.load_state_dict(saved)
            state.optimizer.state.clear()
            return state, m
        return run
    monkeypatch.setattr(nt.training, 'make_train_step', frozen)
    r = harness.run(workload, 2 ** 31 + 12, 0.3, 0, 'cpu', time.time(),
                    overrides=small[workload], log=lambda s: None)
    assert not r['correct']
    assert r['compared']['update_gap']['value'] == pytest.approx(1.0)


def test_altered_answer_is_not_correct(small, monkeypatch):
    import neurite_tpu_torch as nt
    real = nt.utils.seg.predict_volume_device

    def altered(*a, **kw):
        out = real(*a, **kw)
        out = out.clone()
        out[0, 0, 0] += 0.5
        return out
    monkeypatch.setattr(nt.utils.seg, 'predict_volume_device', altered)
    r = harness.run('flagship-serve-256', 2 ** 31 + 13, 0.3, 0, 'cpu',
                    time.time(), overrides=small['flagship-serve-256'],
                    log=lambda s: None)
    assert not r['correct']
