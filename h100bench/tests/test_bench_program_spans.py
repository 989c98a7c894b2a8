"""The readers of the program's own spans (`program_spans.py` and the
seven `layer_metrics/` files that name it) on hand-written Chrome-trace
events: device ms by launch inside 'neurite/...' spans (a backward
launched from autograd's own thread, a copy split in two device events,
an event matched to no launch), the synchronising calls of a step (a
pageable copy with and without its wait, a wait outside the step), and
None where the trace holds none of the program's spans."""

import os
import types

import pytest

from h100bench import harness
from h100bench.trace import Trace

METRICS = ['train.optimizer_ms', 'train.host_syncs', 'synthstrip.host_syncs',
           'synth.perlin_apply_ms', 'serve.copy_in_ms',
           'serve.accumulate_ms', 'serve.glue_ms']


def _reader(name):
    return harness.load_module(
        os.path.join(harness.HERE, 'layer_metrics', f'{name}.py'),
        'reader_' + name.replace('.', '_')).read


class Events:
    """A Chrome trace's complete events, written by hand."""

    def __init__(self):
        self.events, self.corr = [], 0

    def host(self, cat, name, ts, end, tid=1):
        self.events.append({'ph': 'X', 'cat': cat, 'name': name, 'ts': ts,
                            'dur': end - ts, 'tid': tid, 'args': {}})

    def span(self, name, ts, end, tid=1):
        self.host('user_annotation', name, ts, end, tid)

    def launch(self, ts, *device, name='kernel', api='cudaLaunchKernel',
               tid=1):
        """A runtime call at `ts` and its device events [(start, end)]."""
        self.corr += 1
        self.events.append({'ph': 'X', 'cat': 'cuda_runtime', 'name': api,
                            'ts': ts, 'dur': 2, 'tid': tid,
                            'args': {'correlation': self.corr}})
        for s, e in device:
            self.events.append({'ph': 'X', 'cat': 'kernel' if api ==
                                'cudaLaunchKernel' else 'gpu_memcpy',
                                'name': name, 'ts': s, 'dur': e - s,
                                'tid': 7, 'args': {'correlation': self.corr}})

    def device(self, name, ts, end):
        """A device event matched to no launch."""
        self.events.append({'ph': 'X', 'cat': 'kernel', 'name': name,
                            'ts': ts, 'dur': end - ts, 'tid': 7, 'args': {}})

    def reading(self, iterations):
        return types.SimpleNamespace(trace=Trace(self.events),
                                     iterations=iterations)


def _train_steps():
    """Two steps. Step 0: a pageable upload with no wait (non-blocking)
    in the forward, an event matched to no launch in Adam's span. Step 1:
    an `.item()` in the loss (its pageable copy and its wait: one sync).
    Both: the backward's kernel launched from thread 2, Adam's two
    kernels (80 + 40 us); a device-wide wait after each step, outside
    it."""
    ev = Events()
    ev.span('h100bench/window', 0, 2000)
    for k in range(2):
        t = 1000 * k
        ev.span('h100bench/step', t + 5, t + 905)
        ev.span('neurite/train/step', t + 10, t + 900)
        ev.span('neurite/train/forward', t + 20, t + 200)
        ev.launch(t + 50, (t + 60, t + 160), name='conv_fprop')
        ev.span('neurite/train/loss', t + 200, t + 300)
        ev.span('neurite/train/backward', t + 300, t + 600)
        ev.host('cpu_op', 'ConvolutionBackward0', t + 340, t + 360, tid=2)
        ev.launch(t + 350, (t + 400, t + 550), name='conv_dgrad', tid=2)
        ev.span('neurite/train/optimizer', t + 600, t + 880)
        ev.launch(t + 610, (t + 620, t + 700), name='multi_tensor_apply_adam')
        ev.launch(t + 650, (t + 700, t + 740), name='multi_tensor_apply_adam')
        ev.host('cuda_runtime', 'cudaDeviceSynchronize', t + 950, t + 990)
    ev.host('cpu_op', 'aten::copy_', 30, 40)
    ev.launch(32, (34, 38), name='Memcpy HtoD (Pageable -> Device)',
              api='cudaMemcpyAsync')
    ev.device('unmatched', 800, 810)
    ev.host('cpu_op', 'aten::_local_scalar_dense', 1210, 1260)
    ev.launch(1215, (1220, 1225), name='Memcpy DtoH (Device -> Pageable)',
              api='cudaMemcpyAsync')
    ev.host('cuda_runtime', 'cudaStreamSynchronize', 1226, 1250)
    return ev.reading(2)


def test_train_readers():
    r = _train_steps()
    # Adam: 2 x (80 + 40) us, and the unmatched 10 us by its own start
    assert _reader('train.optimizer_ms')(r) == pytest.approx(0.250 / 2)
    # step 0 its unwaited pageable copy, step 1 its item(): 2 in 2 steps
    assert _reader('train.host_syncs')(r) == 1.
    assert _reader('synthstrip.host_syncs')(r) == 1.
    from h100bench import program_spans
    # the backward's launch from thread 2 lies inside the span
    assert program_spans.device_ms(r, 'train/backward') == pytest.approx(
        0.150)
    assert program_spans.device_ms(r, 'train/forward') == pytest.approx(
        (100 + 100 + 4) / 1e3 / 2)


def test_host_syncs_counts_each_wait_once():
    ev = Events()
    ev.span('neurite/train/step', 0, 100)
    ev.host('cpu_op', 'aten::_local_scalar_dense', 10, 30)
    ev.launch(12, (14, 16), name='Memcpy DtoH (Device -> Pageable)',
              api='cudaMemcpyAsync')
    ev.host('cuda_runtime', 'cudaStreamSynchronize', 17, 29)
    ev.host('cuda_runtime', 'cudaEventSynchronize', 40, 45)
    ev.launch(50, (52, 60))
    assert _reader('train.host_syncs')(ev.reading(1)) == 2.


def test_synth_reader():
    ev = Events()
    for k in range(2):
        t = 100 * k
        ev.span('neurite/synth/perlin', t + 10, t + 50)
        ev.launch(t + 20, (t + 20, t + 50))
        ev.span('neurite/synth/apply', t + 50, t + 90)
        ev.launch(t + 60, (t + 60, t + 100))
        ev.launch(t + 95, (t + 100, t + 200))      # the UNet's, outside
    assert _reader('synth.perlin_apply_ms')(ev.reading(2)) == \
        pytest.approx(0.070)


def test_serve_readers():
    """One volume: its copy in two device events, the glue's three
    launches among the model's, the accumulation of one patch and the
    mean."""
    ev = Events()
    ev.span('h100bench/request', 0, 700)
    ev.span('neurite/seg/copy_in', 10, 100)
    ev.host('cpu_op', 'aten::copy_', 15, 99)
    ev.launch(20, (25, 95), (95, 98), name='Memcpy HtoD (Pageable -> Device)',
              api='cudaMemcpyAsync')
    ev.host('cuda_runtime', 'cudaStreamSynchronize', 23, 98)
    ev.span('neurite/seg/apply', 100, 500)
    ev.span('neurite/unet/cast', 110, 120)
    ev.launch(112, (130, 140))
    ev.launch(150, (140, 300), name='conv_fprop')
    ev.span('neurite/unet/upsample', 200, 210)
    ev.launch(205, (300, 320))
    ev.span('neurite/unet/concat', 220, 230)
    ev.launch(225, (320, 335))
    ev.span('neurite/seg/accumulate', 500, 520)
    ev.launch(505, (510, 530))
    ev.launch(510, (530, 535))
    ev.span('neurite/seg/mean', 600, 610)
    ev.launch(602, (605, 612))
    r = ev.reading(1)
    assert _reader('serve.copy_in_ms')(r) == pytest.approx(0.073)
    assert _reader('serve.accumulate_ms')(r) == pytest.approx(0.032)
    assert _reader('serve.glue_ms')(r) == pytest.approx(0.045)


@pytest.mark.parametrize('metric', METRICS)
def test_none_without_the_programs_spans(metric):
    """A trace of a program that opens no span (the harness's own spans
    and device events only) reads nothing."""
    ev = Events()
    ev.span('h100bench/window', 0, 300)
    ev.span('h100bench/step', 10, 200)
    ev.span('h100bench/synth', 10, 50)
    ev.launch(20, (30, 60), name='Memcpy HtoD (Pageable -> Device)',
              api='cudaMemcpyAsync')
    ev.host('cuda_runtime', 'cudaStreamSynchronize', 25, 60)
    assert _reader(metric)(ev.reading(1)) is None


def test_every_new_metric_is_an_entry():
    per_layer = {m['name']: m for m in harness.benchmark()['per_layer']}
    for name in METRICS:
        assert per_layer[name]['source'] == 'program_span'
        assert len(per_layer[name]['workloads']) == 1
