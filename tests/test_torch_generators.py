"""
The port's host generators (`neurite_tpu_torch.generators`) against the JAX
package's on the same temporary files and seeds: every generator of the
reference API, `VolumeDataset` (resume, thread pool) and the helpers yield
the same arrays, bit for bit, with the same dtypes and tuple nesting, in
the same order. `prefetch_to_device` on the CPU keeps a batch's structure
and values; its two repairs (a producer exception is raised at the
consumer; closing the generator stops the producer) are pinned against the
JAX version's behaviour.
"""
import collections
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu import generators as jg  # noqa: E402
from neurite_tpu import io as jio  # noqa: E402
from neurite_tpu_torch import dataproc as tproc  # noqa: E402
from neurite_tpu_torch import generators as tg  # noqa: E402
from test_torch_generators_cuda import _prefetch_threads  # noqa: E402

LABELS = [0, 2, 3, 41]
SHAPE = (8, 10, 6)


def same(a, b, path='out'):
    """a (JAX's) and b (the port's): the same nesting and container types,
    arrays of the same dtype and shape with the same bits."""
    assert type(a) is type(b), f'{path}: {type(a)} vs {type(b)}'
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f'{path}[{i}]')
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f'{path}[{k!r}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f'{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}'
        assert a.tobytes() == b.tobytes(), path
    elif a is None:
        assert b is None
    else:
        assert a == b, path


def take(gen, n):
    return [next(gen) for _ in range(n)]


def both(name, n, *args, **kwargs):
    """n items of generator `name` from each package, compared."""
    a = take(getattr(jg, name)(*args, **kwargs), n)
    b = take(getattr(tg, name)(*args, **kwargs), n)
    same(a, b, name)
    return b


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('gen')
    rng = np.random.default_rng(0)
    d = {k: root / k for k in ('vols', 'segs', 'norm', 'aseg', 'sr', 'cats',
                               'prior')}
    for p in d.values():
        p.mkdir()
    for i in range(4):
        v = rng.normal(size=SHAPE).astype(np.float32)
        s = rng.choice(LABELS, size=SHAPE).astype(np.int32)
        np.savez_compressed(d['vols'] / f'subj{i:02d}_norm.npz', vol_data=v)
        np.savez_compressed(d['segs'] / f'subj{i:02d}_aseg.npz', vol_data=s)
        jio.save_volfile(str(d['norm'] / f'subj{i:02d}_norm.mgz'),
                         rng.integers(0, 256, size=(10, 10, 10), dtype=np.uint8))
        jio.save_volfile(str(d['aseg'] / f'subj{i:02d}_aseg.mgz'),
                         rng.choice(LABELS, size=(10, 10, 10)).astype(np.int32))
        np.savez_compressed(d['sr'] / f'v{i}.npz',
                            vol_data=rng.normal(size=(4, 5, 12)))
    for c, n in (('a', 2), ('b', 3)):
        (d['cats'] / c).mkdir()
        for i in range(n):
            np.savez_compressed(d['cats'] / c / f'{c}{i}.npz',
                                vol_data=rng.normal(size=(6, 6, 6)))
    np.savez(d['prior'] / 'prior.npz',
             prior=rng.dirichlet(np.ones(4), size=SHAPE).astype(np.float32))
    (d['vols'] / 'notes.txt').write_text('not a volume')
    return {k: str(v) for k, v in d.items()}


VOL_CASES = {
    'defaults': {},
    'batch3': dict(batch_size=3),
    'patches': dict(patch_size=[4, 5, 3], patch_stride=2, batch_size=2),
    'patch_none_axis': dict(patch_size=[4, None, 3], patch_stride=[2, 1, 3],
                            nb_labels_reshape=1),
    'seed': dict(vol_rand_seed=3, batch_size=2),
    'feats': dict(nb_feats=2, nb_labels_reshape=1),
    'binary': dict(binary=True),
    'patch_rand': dict(patch_size=[4, 5, 3], patch_rand=True,
                       patch_rand_seed=5),
    'proc_collapse': dict(data_proc_fn=lambda v: v * 2,
                          patch_size=[4, 5, 1], collapse_2d=2, batch_size=4),
    'cycle': dict(nb_restart_cycle=3, batch_size=2,
                  yield_incomplete_final_batch=False),
    'expected': dict(expected_nb_files=4, expected_files=['x']),
}


@pytest.mark.parametrize('case', sorted(VOL_CASES))
def test_vol(data, case):
    out = both('vol', 7, data['vols'], **VOL_CASES[case])
    assert all(o.dtype == (bool if case == 'binary' else np.float32)
               for o in out)


def test_vol_seg_labels_and_mgz(data):
    both('vol', 6, data['segs'], relabel=LABELS, nb_labels_reshape=4,
         keep_vol_size=True, batch_size=2)
    both('vol', 5, data['norm'], ext='.mgz', batch_size=2,
         nb_labels_reshape=1)
    with pytest.raises(AssertionError):
        next(tg.vol(data['vols'], ext='.nii'))
    with pytest.raises(AssertionError):
        next(tg.vol(data['vols'], expected_nb_files=2))


def test_patch_send_and_infinite():
    vol = np.random.default_rng(1).normal(size=(6, 8, 4)).astype(np.float32)
    outs = []
    for g in (jg, tg):
        gen = g.patch(vol, [3, 4, 2], patch_stride=[3, 2, 2],
                      nb_labels_reshape=1, variable_batch_size=True,
                      infinite=True)
        assert next(gen) is None
        outs.append([gen.send(2), gen.send(3), gen.send(None), gen.send(1),
                     *take(gen, 20)])
    same(*outs)
    lab = np.random.default_rng(2).integers(0, 3, size=(4, 4, 4))
    for kw in (dict(nb_labels_reshape=3), dict(nb_labels_reshape=0,
                                               patch_rand=True,
                                               patch_rand_seed=2),
               dict(nb_labels_reshape=3, keep_vol_size=True, batch_size=3)):
        same(list(jg.patch(lab, [2, 2, 4], **kw)),
             list(tg.patch(lab, [2, 2, 4], **kw)))


def test_vol_seg(data):
    out = both('vol_seg', 6, data['vols'], data['segs'], relabel=LABELS,
               nb_labels_reshape=4, batch_size=2)
    assert all(x.dtype == y.dtype == np.float16 for x, y in out)
    assert out[0][1].shape == (2, *SHAPE, 4)


def test_vol_seg_from_mgz_with_the_disk_path_processing(data):
    kw = dict(ext='.mgz', relabel=LABELS, nb_labels_reshape=4,
              proc_vol_fn=lambda v: tproc.vol_proc(v, crop=2, rescale=1 / 255),
              proc_seg_fn=lambda s: tproc.volcrop(s, 2))
    a = take(jg.vol_seg(data['norm'], data['aseg'], **kw), 5)
    b = take(tg.vol_seg(data['norm'], data['aseg'], **kw), 5)
    same(a, b)
    x, y = b[0]
    assert x.shape == (1, 6, 6, 6, 1) and y.shape == (1, 6, 6, 6, 4)
    np.testing.assert_array_equal(y.sum(-1), 1)


def test_vol_cat(data):
    out = both('vol_cat', 8, data['cats'], crop=1, rescale=.5,
               vol_rand_seed=1)
    assert {int(z.argmax()) for _, z in out} == {0, 1}


@pytest.mark.parametrize('kind', ['location', 'file', 'array'])
def test_add_prior(data, kind):
    prior_file = {'location': None,
                  'file': os.path.join(data['prior'], 'prior.npz'),
                  'array': np.load(os.path.join(data['prior'], 'prior.npz'))[
                      'prior']}[kind]
    # batches of 2 need 2 patches of the prior a pass: with one patch a
    # volume, `patch` empties its stack every pass and never yields, in both
    # packages (as in the reference)
    patches = dict(patch_size=[4, 5, 3], patch_stride=2) \
        if kind == 'location' else {}
    outs = []
    for g in (jg, tg):
        base = g.vol(data['vols'], batch_size=2 if patches else 1,
                     nb_labels_reshape=1, **patches)
        outs.append(take(g.add_prior(base, prior_type=kind,
                                     prior_file=prior_file, vol_size=SHAPE,
                                     force_binary=kind == 'array', **patches),
                         4))
    same(*outs)
    assert outs[1][0][1].dtype == np.float16


@pytest.mark.parametrize('feed', ['input', 'output'])
def test_vol_prior_and_hacks(data, feed):
    np.random.seed(0)
    both('vol_prior', 4, data['vols'], prior_feed=feed, vol_size=SHAPE)
    both('vol_seg_prior', 4, data['vols'], data['segs'], prior_feed=feed,
         vol_size=SHAPE, relabel=LABELS, nb_labels_reshape=4)
    out = both('vol_prior_hack', 4, data['vols'], prior_feed=feed,
               vol_size=SHAPE)
    assert isinstance(out[0], tuple)
    out = both('vol_seg_hack', 3, data['vols'], data['segs'])
    assert out[0].dtype == np.float16


@pytest.mark.parametrize('mode', [dict(rand_slices=True),
                                  dict(rand_slices=False),
                                  dict(simulate_whole_sparse_vol=True),
                                  dict(simulate_whole_sparse_vol=True,
                                       rand_slices=False)])
def test_vol_sr_slices(data, mode):
    out = both('vol_sr_slices', 6, data['sr'], 3, 1, batch_size=2,
               vol_rand_seed=4, **mode)
    assert out[0][0].shape == (2, 4, 5, 3)


def test_img_seg(tmp_path):
    Image = pytest.importorskip('PIL.Image')
    rng = np.random.default_rng(3)
    for d in ('img', 'seg'):
        (tmp_path / d).mkdir()
        for i in range(3):
            a = (rng.integers(0, 256, size=(6, 7, 3)) if d == 'img'
                 else rng.integers(0, 2, size=(6, 7))).astype(np.uint8)
            Image.fromarray(a).save(tmp_path / d / f'{i}.png')
    out = both('img_seg', 4, str(tmp_path / 'img'), str(tmp_path / 'seg'),
               batch_size=2)
    # the seg keeps its reader's leading axis, as in JAX: [B, 1, H, W, 2]
    assert out[0][0].shape == (2, 6, 7, 1) and out[0][1].shape == (2, 1, 6, 7, 2)


DS_CASES = {
    'whole': dict(),
    'patches': dict(patch_size=(4, 5, 3), patch_stride=(2, 5, 3)),
    'labels': dict(relabel=LABELS, nb_labels_reshape=4),
    'proc': dict(data_proc_fn=lambda v: v[:6], nb_labels_reshape=1, seed=7),
}


@pytest.mark.parametrize('case', sorted(DS_CASES))
def test_volume_dataset(data, case):
    d = 'segs' if case == 'labels' else 'vols'
    a = jg.VolumeDataset(data[d], **DS_CASES[case])
    b = tg.VolumeDataset(data[d], **DS_CASES[case])
    assert len(a) == len(b) and a.vol_shape == b.vol_shape
    assert a.patches_per_vol == b.patches_per_vol
    same([a[i] for i in range(len(a))], [b[i] for i in range(len(b))])
    same(list(a.epoch_order(1)), list(b.epoch_order(1)))
    whole = list(b.batches(2, epochs=2))
    same(list(a.batches(2, epochs=2)), whole)
    # resumed from a global step: the tail of the uninterrupted run
    same(whole[3:], list(b.batches(2, start_step=3, epochs=2)))
    same(whole, list(b.batches(2, epochs=2, num_workers=3)))
    assert tg.Vol is tg.VolumeDataset


def test_helpers(data, tmp_path):
    same(jg._get_file_list(data['vols'], '.npz', 5),
         tg._get_file_list(data['vols'], '.npz', 5))
    same(jg._get_file_list(data['vols']), tg._get_file_list(data['vols']))
    lab = np.random.default_rng(4).integers(0, 4, size=(3, 4, 2))
    for args in ((lab, 4, False, None), (lab, 1, True, None),
                 (lab, 0, False, None)):
        same(jg._categorical_prep(*args), tg._categorical_prep(*args))
    for kw in (dict(), dict(num_classes=6), dict(reshape=False)):
        same(jg._to_categorical(lab, **kw), tg._to_categorical(lab, **kw))
    f = lab.astype(np.float32) * 1.5
    same(jg._relabel(f, [0., 3.]), tg._relabel(f, [0., 3.]))
    same(jg._relabel(lab, [0, 1, 2, 3], forcecheck=True),
         tg._relabel(lab, [0, 1, 2, 3], forcecheck=True))
    with pytest.raises(AssertionError):
        tg._relabel(lab, [0, 1], forcecheck=True)
    p = str(tmp_path / 'h.npz')
    np.savez(p, a=np.zeros((2, 3), np.int16), b=np.ones(4))
    assert list(jg._npz_headers(p)) == list(tg._npz_headers(p))
    assert list(tg._npz_headers(p, ['b.npy'])) == [('b', (4,), np.float64)]
    nested = ([np.zeros((5, 2)), 1], np.ones(3))
    assert jg._get_shape(nested) == tg._get_shape(nested) == 5


# ----------------------------------------------------------- prefetch

Pair = collections.namedtuple('Pair', 'x y')


def _batches(n=4):
    rng = np.random.default_rng(6)
    for i in range(n):
        yield (rng.normal(size=(2, 3)).astype(np.float16),
               [rng.integers(0, 9, size=4), {'m': rng.random(2) > .5,
                                             's': 'name', 'n': None}],
               Pair(np.float32(i), np.arange(3, dtype='>i4')),
               3.5)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*map(_to_numpy, tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(_to_numpy, tree))
    if torch.is_tensor(tree):
        return tree.numpy()
    return tree


def test_prefetch_cpu_keeps_structure_and_values():
    out = list(tg.prefetch_to_device(_batches(), size=2, device='cpu'))
    assert len(out) == 4
    for host, dev in zip(_batches(), out):
        assert isinstance(dev, tuple) and isinstance(dev[1], list)
        assert isinstance(dev[2], Pair) and isinstance(dev[1][1], dict)
        assert all(torch.is_tensor(t) and t.device.type == 'cpu'
                   for t in (dev[0], dev[1][0], dev[1][1]['m'], dev[2].x,
                             dev[2].y, dev[3]))
        assert dev[0].dtype == torch.float16 and dev[2].y.dtype == torch.int32
        assert dev[1][1]['s'] == 'name' and dev[1][1]['n'] is None
        np.testing.assert_array_equal(dev[0].numpy(), host[0])
        np.testing.assert_array_equal(dev[1][0].numpy(), host[1][0])
        np.testing.assert_array_equal(dev[1][1]['m'].numpy(), host[1][1]['m'])
        np.testing.assert_array_equal(dev[2].y.numpy(), host[2].y)
        assert float(dev[2].x) == float(host[2].x) and float(dev[3]) == 3.5


def test_prefetch_matches_jax_values_in_order():
    def plain(n=6):
        rng = np.random.default_rng(9)
        for _ in range(n):
            yield (rng.normal(size=(3, 2)).astype(np.float32),
                   {'y': rng.integers(0, 4, size=(5,)).astype(np.int32)})
    a = [(np.asarray(x), {'y': np.asarray(d['y'])})
         for x, d in jg.prefetch_to_device(plain(), size=3)]
    b = [(x.numpy(), {'y': d['y'].numpy()})
         for x, d in tg.prefetch_to_device(plain(), size=3, device='cpu')]
    same(a, b)


def test_prefetch_devices_put_replaces_the_default():
    out = list(tg.prefetch_to_device(iter([1, 2]), devices_put=lambda b: ('p', b),
                                     device='cpu'))
    assert out == [('p', 1), ('p', 2)]


def test_prefetch_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tg.prefetch_to_device(iter([]))


def _failing(n_ok):
    for i in range(n_ok):
        yield np.full(2, i, np.float32)
    raise ValueError('corrupt volume')


@pytest.mark.filterwarnings(
    'ignore::pytest.PytestUnhandledThreadExceptionWarning')
def test_prefetch_reraises_the_producer_exception():
    gen = tg.prefetch_to_device(_failing(2), device='cpu')
    assert [float(next(gen)[0]) for _ in range(2)] == [0., 1.]
    with pytest.raises(ValueError, match='corrupt volume'):
        next(gen)
    # the JAX version ends the stream silently: a shorter dataset
    out = list(jg.prefetch_to_device(_failing(2)))
    assert [float(o[0]) for o in out] == [0., 1.]


def _counting(counter):
    i = 0
    while True:
        counter.append(i)
        yield np.full(3, i, np.float32)
        i += 1


@pytest.mark.parametrize('how', ['close', 'break'])
def test_prefetch_close_stops_the_producer(how):
    seen = []
    gen = tg.prefetch_to_device(_counting(seen), size=2, device='cpu')
    if how == 'close':
        assert float(next(gen)[0]) == 0.
        gen.close()
    else:
        for b in gen:
            if float(b[0]) == 2.:
                break
        del gen   # a generator dropped after `break` is closed
    assert not _prefetch_threads()
    n = len(seen)
    time.sleep(0.2)
    assert len(seen) == n <= 3 + 2 + 1   # consumed, queued, in hand


def test_prefetch_jax_producer_blocks_after_close():
    before = set(threading.enumerate())
    seen = []
    gen = jg.prefetch_to_device(_counting(seen), size=2)
    next(gen)
    gen.close()
    # one batch consumed, two queued, one in hand: then the put blocks
    deadline = time.monotonic() + 30
    while len(seen) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    # JAX's daemon thread stays blocked on its full queue
    assert len(left) == 1 and len(seen) == 4


def test_prefetch_order_under_thread_switches():
    """Many small batches through a one-slot queue with the interpreter
    switching threads as often as it can: every batch once, in order."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        src = (np.full(2, i, np.int64) for i in range(300))
        out = [int(b[0]) for b in tg.prefetch_to_device(src, size=1,
                                                        device='cpu')]
    finally:
        sys.setswitchinterval(old)
    assert out == list(range(300))
    assert not _prefetch_threads()
