"""
The disk slice as a whole, against the JAX package: FreeSurfer-style
`norm`/`aseg` `.mgz` pairs on disk → `generators.vol_seg` with the crop,
rescale and relabel of `chip_smoke.py`'s disk phase → the port's
`prefetch_to_device(device='cpu')` → the port's `training.fit` of a 2-level
float32 UNet with SoftDice and Adam, for 3 steps; the reference: the JAX
package's `vol_seg` → its `training.fit` with optax's Adam, from the same
weights (carried by `convert.load_flax_params`). Losses within 1e-5
relative, final parameters within 1e-5 of each tensor's largest magnitude.

The feed is float16 (`vol_seg`'s casts). A UNet without a compute dtype
computes in its input's dtype in both packages (`dt = self.dtype or
x.dtype`), so the test sets float32, as the card's path sets bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import optax  # noqa: E402

import neurite_tpu as ne  # noqa: E402
import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import convert, training  # noqa: E402

torch.set_num_threads(1)

LABELS = [0, 2, 3, 41]   # unknown, left WM, left cortex, right WM
VOL, CROP, STEPS = 16, 2, 3
CFG = dict(nb_features=4, input_shape=(VOL - 2 * CROP,) * 3 + (1,),
           nb_levels=2, conv_size=3, nb_labels=4, feat_mult=2,
           nb_conv_per_level=2)


@pytest.fixture(scope='module')
def subjects(tmp_path_factory):
    root = tmp_path_factory.mktemp('subjects')
    rng = np.random.default_rng(0)
    for d in ('norm', 'aseg'):
        (root / d).mkdir()
    for i in range(3):
        nt.io.save_volfile(str(root / 'norm' / f'subj{i:02d}_norm.mgz'),
                           rng.integers(0, 256, size=(VOL,) * 3,
                                        dtype=np.uint8))
        nt.io.save_volfile(str(root / 'aseg' / f'subj{i:02d}_aseg.mgz'),
                           rng.choice(LABELS, size=(VOL,) * 3)
                           .astype(np.int32))
    return str(root / 'norm'), str(root / 'aseg')


def _feed(pkg, norm, aseg):
    return pkg.generators.vol_seg(
        norm, aseg, ext='.mgz',
        proc_vol_fn=lambda v: pkg.dataproc.vol_proc(v, crop=CROP,
                                                     rescale=1 / 255),
        proc_seg_fn=lambda s: pkg.dataproc.volcrop(s, CROP),
        relabel=LABELS, nb_labels_reshape=4)


class Record:
    def __init__(self):
        self.losses = []

    def on_batch_end(self, i, state, logs):
        self.losses.append(logs['loss'])


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, 'items'):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_disk_slice_trains_as_the_jax_package(subjects):
    norm, aseg = subjects
    jm = ne.models.unet(**CFG, dtype=jax.numpy.float32)
    x0, _ = next(_feed(ne, norm, aseg))
    params = jm.init(jax.random.PRNGKey(0), x0)['params']

    jrec = Record()
    jstate = ne.training.TrainState.create(jm.apply, params, optax.adam(1e-3))
    jstep = ne.training.make_train_step(
        ne.losses.SoftDice(check_input_limits=False).loss)
    jstate, _ = ne.training.fit(jstate, jstep, _feed(ne, norm, aseg), STEPS,
                                rng=jax.random.PRNGKey(0), callbacks=[jrec])

    tm = nt.models.unet(device='cpu', **CFG, dtype=torch.float32)
    convert.load_flax_params(tm, params)
    state = training.create_train_state(tm, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    feed = nt.generators.prefetch_to_device(_feed(nt, norm, aseg), size=2,
                                            device='cpu')
    seen = []

    def tap(it):
        for b in it:
            seen.append(b)
            yield b
    trec = Record()
    state, _ = training.fit(state, step, tap(feed), STEPS, callbacks=[trec])
    feed.close()

    assert [tuple(x.shape) for x, _ in seen] == [(1, 12, 12, 12, 1)] * STEPS
    assert all(x.dtype == y.dtype == torch.float16 for x, y in seen)
    assert all(bool((y.sum(-1) == 1).all()) for _, y in seen)
    # 3 subjects, then the circular order starts again
    np.testing.assert_array_equal(seen[0][0].numpy(), x0)
    assert len(trec.losses) == len(jrec.losses) == STEPS
    assert all(np.isfinite(trec.losses))
    assert trec.losses[2] < trec.losses[0] - 1e-3   # the weights moved
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)

    want = _leaves(jstate.params)
    got = _leaves(convert.to_flax_params(tm))
    assert got.keys() == want.keys()
    for p, v in got.items():
        np.testing.assert_allclose(v, want[p], rtol=0,
                                   atol=1e-5 * np.abs(want[p]).max(),
                                   err_msg='/'.join(p))
