"""
The spans the port's layers open under `torch.profiler.profile`: the
UNet's glue, the serve path's copy, patches and mean, and the synthesis,
in their order and number (the step's and `fit`'s: `test_torch_trace.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.models.unet import Conv  # noqa: E402
from neurite_tpu_torch.utils import seg  # noqa: E402
from test_torch_trace import _batch, _names, _profiled, _unet  # noqa: E402


def test_unet_glue_spans():
    """The UNet's forward: one 'unet/cast' a conv, one 'unet/upsample' and
    one 'unet/concat' a decoder level (3 levels: 2)."""
    model = _unet()
    convs = sum(isinstance(m, Conv) for m in model.modules())
    x, _ = _batch(1)
    prof = _profiled(lambda: model(x))
    names = _names(prof)
    assert names.count('neurite/unet/cast') == convs > 0
    assert names.count('neurite/unet/upsample') == 2
    assert names.count('neurite/unet/concat') == 2
    # each level upsamples, then concatenates its skip
    levels = [n for n in names if n != 'neurite/unet/cast']
    assert levels == ['neurite/unet/upsample', 'neurite/unet/concat'] * 2


@pytest.mark.parametrize('how, copies', [('array', 1), ('tensor', 0),
                                         ('tensor on device', 0)])
def test_predict_volume_device_spans(how, copies):
    """16^3 in 8^3 patches at stride 4: 27 patches, each applied and
    accumulated; one copy to the device where one is made; one mean."""
    model = _unet()
    vol = np.random.default_rng(2).normal(size=(16, 16, 16, 1)).astype(
        np.float32)
    args = {'array': (vol, 'cpu'), 'tensor': (torch.from_numpy(vol), None),
            'tensor on device': (torch.from_numpy(vol), 'cpu')}[how]
    out = []
    prof = _profiled(lambda: out.append(seg.predict_volume_device(
        model, args[0], (8, 8, 8), stride=4, device=args[1])))
    names = _names(prof)
    assert names.count('neurite/seg/copy_in') == copies
    assert names.count('neurite/seg/apply') == 27
    assert names.count('neurite/seg/accumulate') == 27
    assert names.count('neurite/seg/mean') == 1
    per_patch = [n for n in names
                 if n in ('neurite/seg/apply', 'neurite/seg/accumulate')]
    assert per_patch == ['neurite/seg/apply', 'neurite/seg/accumulate'] * 27
    assert tuple(out[0].shape) == (16, 16, 16, 2)


def _synthstrip():
    return nt.models.SynthStrip(inshape=(16,) * 3, labels_in=range(4),
                                labels_out={1: 1, 2: 1}, nb_unet_features=4,
                                nb_unet_levels=2, device='cpu')


@pytest.mark.parametrize('call', ['module draws', 'module given draws',
                                  'generator'])
def test_synthesis_spans(call):
    """'synth/draw' only where the draws are made; 'synth/perlin' and
    'synth/apply' once: SynthStrip's forward, and `LabelsToImageV1`'s."""
    model = _synthstrip()
    labels = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4, size=(1, 16, 16, 16, 1)))
    gen = torch.Generator().manual_seed(4)
    if call == 'generator':
        run = lambda: model.gen(labels, gen)  # noqa: E731
    else:
        draws = (model.gen.draw(labels.shape, gen)
                 if call == 'module given draws' else None)
        run = lambda: model(labels, generator=gen, draws=draws)  # noqa: E731
    names = [n for n in _names(_profiled(run))
             if n.startswith('neurite/synth/')]
    assert names == ([] if call == 'module given draws'
                     else ['neurite/synth/draw']) + [
        'neurite/synth/perlin', 'neurite/synth/apply']
