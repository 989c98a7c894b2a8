"""
The port's offline preprocessing (`neurite_tpu_torch.dataproc`), toy
datasets (`data`) and split helpers (`py.data`) against the JAX package's
on the same temporary files and seeds: host outputs bit-equal, with the
same dtypes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu import data as jdata  # noqa: E402
from neurite_tpu import dataproc as jproc  # noqa: E402
from neurite_tpu import io as jio  # noqa: E402
from neurite_tpu.py import data as jpydata  # noqa: E402
from neurite_tpu_torch import data as tdata  # noqa: E402
from neurite_tpu_torch import dataproc as tproc  # noqa: E402
from neurite_tpu_torch.py import data as tpydata  # noqa: E402


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f'{a.dtype}{a.shape} vs {b.dtype}{b.shape}'
    assert a.tobytes() == b.tobytes()


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


VOL = np.random.default_rng(0).normal(size=(10, 12, 8)).astype(np.float32)


@pytest.mark.parametrize('crop', [None, 2, [1, 0, 3], [(1, 2), None, (0, 3)],
                                  [2, (3, 0), 1]])
def test_volcrop(crop):
    same(jproc.volcrop(VOL, crop), tproc.volcrop(VOL, crop))


PROC_CASES = {
    'offset_rescale': dict(offset=1.5, rescale=1 / 255),
    'prctle': dict(rescale_prctle=90),
    'resize': dict(resize_shape=(5, 6, 4), interp_order=1),
    'resize_last_none': dict(resize_shape=(5, 6, None), interp_order=0),
    'resize_slices': dict(resize_slices=[5, None, 4], interp_order=1),
    'crop_clip': dict(crop=1, clip=(-0.5, 0.5)),
    'extract': dict(extract_nd=[range(2, 6), range(3), range(1, 8, 2)]),
    'binary': dict(force_binary=True),
    'all': dict(offset=-.2, rescale=2., resize_shape=(8, 8, 8),
                interp_order=2, crop=[1, 2, 0], clip=(-1, 1),
                force_binary=False),
}


@pytest.mark.parametrize('case', sorted(PROC_CASES))
def test_vol_proc(case):
    kw = PROC_CASES[case]
    a, b = jproc.vol_proc(VOL, **kw), tproc.vol_proc(VOL, **kw)
    same(a, b)
    if case == 'prctle':   # the f64 promotion of the percentile rescale
        assert b.dtype == np.float64


def test_vol_proc_uint8_as_the_disk_path_calls_it():
    v = np.random.default_rng(1).integers(0, 256, size=(20, 20, 20),
                                          dtype=np.uint8)
    same(jproc.vol_proc(v, crop=2, rescale=1 / 255),
         tproc.vol_proc(v, crop=2, rescale=1 / 255))


@pytest.fixture(scope='module')
def mgz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('mgz')
    rng = np.random.default_rng(2)
    for i in range(3):
        jio.save_volfile(str(d / f's{i}.mgz'),
                         rng.integers(0, 5, size=(8, 8, 6)).astype(np.int32))
    jio.save_volfile(str(d / 's3.mgz'),
                     rng.normal(size=(8, 8, 6, 2)).astype(np.float32))
    (d / 'skip.txt').write_text('x')
    return str(d)


@pytest.mark.parametrize('kw', [dict(crop=1), dict(label_idx=2),
                                dict(crop=2, clip=(0, 3))])
def test_proc_mgh_vols(tmp_path, mgz_dir, kw, capsys):
    import shutil
    src = tmp_path / 'src'
    shutil.copytree(mgz_dir, src)
    # a 3^3 volume: cropped empty by crop=2, which the clip's check then
    # fails on, so it is skipped (and named), in both
    jio.save_volfile(str(src / 'bad.mgz'), np.zeros((3, 3, 3), np.float32))
    outs = []
    for i, m in enumerate((jproc, tproc)):
        out = tmp_path / str(i)
        out.mkdir()
        m.proc_mgh_vols(str(src), str(out), **kw)
        outs.append(str(out))
    a, b = tree(outs[0]), tree(outs[1])
    skipped = 'clip' in kw
    assert a.keys() == b.keys() and len(a) == 5 - skipped
    assert capsys.readouterr().err.count('Skipped: bad.mgz') == 2 * skipped
    for k in a:
        same(np.load(os.path.join(outs[0], k))['vol_data'],
             np.load(os.path.join(outs[1], k))['vol_data'])


@pytest.mark.parametrize('kw', [dict(slice_nrs=[2, 3]),
                                dict(slice_nrs=None, slice_pad=1,
                                     vol_inner_pad_for_slice_nrs=1),
                                dict(slice_nrs=[1], dim_idx=0, label_idx=3)])
def test_scans_to_slices_nii(tmp_path, mgz_dir, kw):
    outs = []
    for i, m in enumerate((jproc, tproc)):
        out = tmp_path / str(i)
        out.mkdir()
        m.scans_to_slices(mgz_dir, str(out), out_ext='.nii.gz', **kw)
        outs.append(str(out))
    a = tree(outs[0])
    assert a.keys() == tree(outs[1]).keys() and a
    for k in a:
        same(jio.load_volfile(os.path.join(outs[0], k)),
             jio.load_volfile(os.path.join(outs[1], k)))


def test_scans_to_slices_png(tmp_path, mgz_dir):
    Image = pytest.importorskip('PIL.Image')
    outs = []
    for i, m in enumerate((jproc, tproc)):
        out = tmp_path / str(i)
        out.mkdir()
        m.scans_to_slices(mgz_dir, str(out), [1, 4], rescale=1 / 8)
        outs.append(str(out))
    a = tree(outs[0])
    assert a.keys() == tree(outs[1]).keys() and a
    for k in a:
        same(np.asarray(Image.open(os.path.join(outs[0], k))),
             np.asarray(Image.open(os.path.join(outs[1], k))))


@pytest.mark.parametrize('kw', [dict(), dict(min_freq=.2), dict(nargout=2),
                                dict(force_binary=True)])
def test_prior_to_weights(tmp_path, kw):
    rng = np.random.default_rng(3)
    prior = rng.dirichlet([4, 1, 1, .2], size=(6, 5, 4)).astype(np.float32)
    a, b = jproc.prior_to_weights(prior, **kw), tproc.prior_to_weights(prior, **kw)
    if kw.get('nargout') == 2:
        same(a[1], b[1])
        a, b = a[0], b[0]
    same(a, b)
    p = str(tmp_path / 'prior.npz')
    np.savez(p, prior=prior)
    same(jproc.prior_to_weights(p), tproc.prior_to_weights(p))


def test_prior_to_weights_zero_support(capsys):
    prior = np.zeros((3, 3, 3), np.float32)
    prior[..., 0], prior[..., 1] = .7, .3
    prior = np.stack([prior[..., 0], prior[..., 1], prior[..., 2]], -1)
    a, b = jproc.prior_to_weights(prior), tproc.prior_to_weights(prior)
    same(a, b)
    assert b[2] == 0 and 'Warning' in capsys.readouterr().err


@pytest.mark.parametrize('layout', ['subject_first', 'file_first'])
@pytest.mark.parametrize('copy', [True, False])
def test_filestruct_change(tmp_path, layout, copy):
    outs = []
    for i, m in enumerate((jproc, tproc)):
        src = tmp_path / f'src{i}'
        for s in ('subjA', 'subjB'):
            (src / s).mkdir(parents=True)
            for f in ('norm.mgz', 'aseg.mgz'):
                (src / s / f).write_bytes(f'{s}/{f}'.encode())
        (src / 'loose.txt').write_text('not a subject')
        dst = tmp_path / f'dst{i}'
        m.filestruct_change(str(src), dirstruct_in=layout, dst=str(dst),
                            copy=copy)
        outs.append((tree(src), tree(dst)))
    assert outs[0] == outs[1] and outs[1][1]
    with pytest.raises(AssertionError):
        tproc.filestruct_change(str(tmp_path), dst=None)


@pytest.mark.parametrize('seed', [None, 4])
def test_ml_split(tmp_path, seed):
    outs = []
    for i, m in enumerate((jproc, tproc)):
        src = tmp_path / f'src{i}'
        src.mkdir()
        for j in range(11):
            (src / f'f{j:02d}.npz').write_bytes(bytes([j]))
        m.ml_split(str(src), seed=4 if seed is None else seed,
                   ratios=(.6, .2, .2))
        outs.append(tree(src))
    assert outs[0] == outs[1]
    assert sum(k.startswith('train') for k in outs[1]) == 6
    with pytest.raises(AssertionError):
        tproc.ml_split(str(tmp_path / 'src1'), ratios=(.5, .2))


# ------------------------------------------------------------------ data


@pytest.mark.parametrize('kw', [dict(nb_items=12), dict(nb_items=7, size=16,
                                                        nb_classes=10, seed=3)])
def test_synthetic_shapes(kw):
    a, b = jdata.synthetic_shapes(**kw), tdata.synthetic_shapes(**kw)
    same(a[0], b[0])
    same(a[1], b[1])


def _splits(ds):
    return {s: (ds.x[s], ds.y[s]) for s in ds.x._splits}


def _same_splits(a, b):
    sa, sb = _splits(a), _splits(b)
    assert list(sa) == list(sb)
    for k in sa:
        same(sa[k][0], sb[k][0])
        same(sa[k][1], sb[k][1])


@pytest.mark.parametrize('kw', [dict(nb_items=24),
                                dict(nb_items=30, sel_class=3, pad_amt=2),
                                dict(nb_items=18, zoom_factor=.5)])
def test_dataset(kw):
    _same_splits(jdata.Dataset('synthetic', **kw),
                 tdata.Dataset('synthetic', **kw))


def test_dataset_arrays_randomized_and_methods():
    rng = np.random.default_rng(5)
    arrays = (rng.random((20, 6, 6)) * 255, rng.integers(0, 3, 20),
              rng.random((5, 6, 6)) * 255, rng.integers(0, 3, 5))
    np.random.seed(11)
    a = jdata.Dataset(arrays, randomize=True)
    np.random.seed(11)
    b = tdata.Dataset(arrays, randomize=True)
    _same_splits(a, b)
    for ds in (a, b):
        ds.select_class(1, splits=['train'])
        ds.pad(1, splits=['test'])
        ds.reshape(2, splits=['val'], order=0)
        ds.corrupt_mix(nb_corrupt=3, seed=2)
        ds.corrupt_gaussian(sigma=.2, splits=['train', 'test'], seed=3,
                            output_suffix=None)
    _same_splits(a, b)
    assert tdata.KerasDataset is tdata.Dataset


def test_dataset_show_examples():
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    ds = tdata.Dataset('synthetic', nb_items=12)
    ds.show_examples(nb_examples=2, splits=['train'])
    assert plt.get_fignums()
    plt.close('all')


def test_datasplit_and_split_dataset():
    for m in (jpydata, tpydata):
        d = m.DataSplit(train=1)
        d['extra'] = 5
        d.map_fn(lambda v: v, splits=['train'])
        assert d._splits == ['train', 'val', 'test', 'extra'] and d.extra == 5
        with pytest.raises(AssertionError):
            d['nope']
        with pytest.raises(AssertionError):
            d.add_split('train', 2)
    arr = np.arange(30).reshape(10, 3)
    for kw in (dict(ratios=(.7, .3), randomize=False),
               dict(ratios=(1, 1, 2), randomize=True, rand_seed=3),
               dict(ratios=(.5, .5), axis=1, randomize=False)):
        for x, y in zip(jpydata.split_dataset(arr, **kw),
                        tpydata.split_dataset(arr, **kw)):
            same(x, y)
    lst = list('abcdefg')
    assert jpydata.split_dataset(lst, (.5, .5), rand_seed=2) == \
        tpydata.split_dataset(lst, (.5, .5), rand_seed=2)
    with pytest.raises(AssertionError):
        tpydata.split_dataset(lst, (.5, .5), axis=1)
    with pytest.raises(ValueError):
        tpydata.load_dataset('no-such-dataset')
