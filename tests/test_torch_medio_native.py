"""
The port's medical-image IO (`neurite_tpu_torch.io.medio`) and native host
ops (`io.native`, built from the port's copy of `hostops.cpp`) against the
JAX package's: files written by either package load in the other to the
same array, dtype and affine, and the same input writes the same bytes
(gzip's header carries a time, so compressed files compare decompressed);
the spec-level fixtures of `tests/test_io.py`; one-hot, relabel and the
nan-aggregates equal to JAX's native library and to numpy; the f32 quilt's
nan-median through the port's library; a failed build raises.
"""
import gzip
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import test_io  # noqa: E402  (the byte strings of its spec fixtures)

from neurite_tpu import io as jio  # noqa: E402
from neurite_tpu.io import native as jnative  # noqa: E402
from neurite_tpu.io import tiling as jtiling  # noqa: E402
from neurite_tpu_torch import io as tio  # noqa: E402
from neurite_tpu_torch.io import native, tiling  # noqa: E402
from neurite_tpu_torch.ops import _build  # noqa: E402

PKGS = {'jax': jio, 'port': tio}
DTYPES = [np.float32, np.int16, np.uint8, np.int32]


def _affine(rng):
    a = np.eye(4)
    a[:3, :3] = np.diag(rng.uniform(0.5, 2.0, 3))
    a[:3, 3] = rng.normal(size=3) * 10
    return a


def _vol(rng, dtype, shape=(5, 6, 7)):
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000),
                        size=shape).astype(dtype)


def _raw(path):
    opener = gzip.open if path.endswith(('.gz', '.mgz')) else open
    with opener(path, 'rb') as f:
        return f.read()


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ext', ['.nii', '.nii.gz'])
def test_nii_across_packages(tmp_path, writer, reader, dtype, ext):
    rng = np.random.default_rng(len(ext) + np.dtype(dtype).itemsize)
    vol, aff = _vol(rng, dtype), _affine(rng)
    p = str(tmp_path / f'v{ext}')
    PKGS[writer].save_nii(p, vol, aff)
    out = PKGS[reader].load_nii(p)
    want = jio.load_nii(p)
    assert out.data.dtype == vol.dtype == want.data.dtype
    np.testing.assert_array_equal(out.data, vol)
    np.testing.assert_array_equal(out.affine, want.affine)
    np.testing.assert_allclose(out.affine, aff, rtol=1e-6, atol=1e-5)
    assert out.header['datatype'] == want.header['datatype']
    np.testing.assert_array_equal(out.header['pixdim'], want.header['pixdim'])


@pytest.mark.parametrize('writer,reader', [('jax', 'port'), ('port', 'jax')])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('ext', ['.mgh', '.mgz'])
def test_mgh_across_packages(tmp_path, writer, reader, dtype, ext):
    rng = np.random.default_rng(3 * len(ext) + np.dtype(dtype).itemsize)
    vol, aff = _vol(rng, dtype), _affine(rng)
    p = str(tmp_path / f'v{ext}')
    PKGS[writer].save_mgh(p, vol, aff)
    out = PKGS[reader].load_mgh(p)
    want = jio.load_mgh(p)
    # MGH is big-endian on disk, and both readers return its byte order
    assert out.data.dtype == want.data.dtype
    assert out.data.dtype.newbyteorder('=') == vol.dtype
    np.testing.assert_array_equal(out.data, vol)
    np.testing.assert_array_equal(out.affine, want.affine)
    # float32 header fields: the affine comes back to float32 rounding
    np.testing.assert_allclose(out.affine, aff, rtol=1e-5, atol=1e-4)
    assert out.header == want.header


@pytest.mark.parametrize('ext', ['.nii', '.nii.gz', '.mgh', '.mgz'])
@pytest.mark.parametrize('dtype', [np.float32, np.int32, np.float64, np.bool_])
def test_same_bytes(tmp_path, ext, dtype):
    """The same input writes the same (decompressed) bytes, including the
    dtype conversions each writer makes (float64 and bool)."""
    rng = np.random.default_rng(7)
    vol = rng.normal(size=(4, 5, 6)).astype(dtype) if dtype != np.bool_ \
        else rng.random((4, 5, 6)) > .5
    if dtype == np.int32:
        vol = rng.integers(-50, 50, size=(4, 5, 6)).astype(np.int32)
    aff = _affine(rng)
    pj, pt = str(tmp_path / f'j{ext}'), str(tmp_path / f't{ext}')
    jio.save_volfile(pj, vol, aff)
    tio.save_volfile(pt, vol, aff)
    assert _raw(pj) == _raw(pt)
    a, b = jio.load_volfile(pt), tio.load_volfile(pj)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('ext', ['.npz', '.npy'])
def test_numpy_volfiles_across_packages(tmp_path, ext):
    vol = np.random.default_rng(4).normal(size=(3, 4, 5)).astype(np.float32)
    for writer, reader in (('jax', 'port'), ('port', 'jax')):
        p = str(tmp_path / f'{writer}{ext}')
        PKGS[writer].save_volfile(p, vol)
        out = PKGS[reader].load_volfile(p)
        assert out.dtype == vol.dtype
        np.testing.assert_array_equal(out, vol)
    # an npz with one array under another name, as both read it
    p = str(tmp_path / 'other.npz')
    np.savez(p, other=vol)
    np.testing.assert_array_equal(tio.load_volfile(p), jio.load_volfile(p))
    with pytest.raises(ValueError):
        tio.load_volfile(str(tmp_path / 'v.txt'))
    with pytest.raises(ValueError):
        tio.save_volfile(str(tmp_path / 'v.txt'), vol)


def test_four_d_mgh_and_volume_accessors(tmp_path):
    vol = np.random.default_rng(5).normal(size=(3, 4, 5, 2)).astype(np.float32)
    p = str(tmp_path / 'v.mgz')
    tio.save_mgh(p, vol)
    out, want = tio.load_mgh(p), jio.load_mgh(p)
    assert out.shape == want.shape == (3, 4, 5, 2)
    np.testing.assert_array_equal(out.data, want.data)
    assert out.get_fdata().dtype == np.float64
    np.testing.assert_array_equal(out.get_fdata(), want.get_fdata())
    v = tio.Volume(vol)
    np.testing.assert_array_equal(v.affine, np.eye(4))
    assert v.header == {}


@pytest.mark.parametrize('endian', ['<', '>'])
def test_nifti1_spec_fixture(tmp_path, endian):
    raw, srow = test_io.TestSpecLevelFixtures._nifti1_bytes(endian)
    p = str(tmp_path / 'spec.nii')
    with open(p, 'wb') as f:
        f.write(raw)
    out = tio.load_nii(p)
    want = np.arange(24).reshape(2, 3, 4, order='F') * 2.0 + 10.0
    np.testing.assert_allclose(out.data, want)
    np.testing.assert_allclose(out.affine[:3], np.asarray(srow), rtol=1e-6)
    np.testing.assert_array_equal(out.data, jio.load_nii(p).data)


def test_nifti1_spec_fixture_gz_and_pixdim(tmp_path):
    raw, _ = test_io.TestSpecLevelFixtures._nifti1_bytes('<')
    p = str(tmp_path / 'spec.nii.gz')
    with gzip.open(p, 'wb') as f:
        f.write(raw)
    np.testing.assert_allclose(
        tio.load_nii(p).data,
        np.arange(24).reshape(2, 3, 4, order='F') * 2.0 + 10.0)
    raw = bytearray(raw)
    struct.pack_into('<h', raw, 254, 0)   # sform_code 0: the pixdim affine
    p = str(tmp_path / 'nos.nii')
    with open(p, 'wb') as f:
        f.write(bytes(raw))
    np.testing.assert_allclose(np.diag(tio.load_nii(p).affine),
                               [1.5, 2.5, 3.5, 1.0])


def test_mgh_spec_fixture(tmp_path):
    """A 2x3x2 float32 MGH per the FreeSurfer spec (big-endian), as
    `tests/test_io.py` assembles it."""
    hdr = bytearray(284)
    struct.pack_into('>i', hdr, 0, 1)
    struct.pack_into('>4i', hdr, 4, 2, 3, 2, 1)
    struct.pack_into('>i', hdr, 20, 3)
    struct.pack_into('>h', hdr, 28, 1)
    struct.pack_into('>3f', hdr, 30, 1.0, 2.0, 3.0)
    mdc = np.asarray([[0., 1., 0.], [0., 0., 1.], [1., 0., 0.]])
    struct.pack_into('>9f', hdr, 42, *mdc.flatten(order='F'))
    struct.pack_into('>3f', hdr, 78, 5., 6., 7.)
    vals = np.arange(12, dtype='>f4')
    p = str(tmp_path / 'spec.mgh')
    with open(p, 'wb') as f:
        f.write(bytes(hdr) + vals.tobytes())
    out, want = tio.load_mgh(p), jio.load_mgh(p)
    np.testing.assert_array_equal(
        out.data, np.arange(12, dtype=np.float32).reshape(2, 3, 2, order='F'))
    np.testing.assert_array_equal(out.affine, want.affine)
    np.testing.assert_allclose(out.affine[:3, :3], mdc * [1., 2., 3.])


@pytest.mark.parametrize('case', ['nii_size', 'nii_magic', 'nii_dtype',
                                  'mgh_version', 'mgh_type'])
def test_bad_headers_raise(tmp_path, case):
    raw, _ = test_io.TestSpecLevelFixtures._nifti1_bytes('<')
    raw = bytearray(raw)
    p = str(tmp_path / ('x.nii' if case.startswith('nii') else 'x.mgh'))
    if case == 'nii_size':
        struct.pack_into('<i', raw, 0, 100)
    elif case == 'nii_magic':
        raw[344:348] = b'xx1\x00'
    elif case == 'nii_dtype':
        struct.pack_into('<h', raw, 70, 3)
    else:
        raw = bytearray(284 + 8)
        struct.pack_into('>i', raw, 0, 2 if case == 'mgh_version' else 1)
        struct.pack_into('>4i', raw, 4, 2, 1, 1, 1)
        struct.pack_into('>i', raw, 20, 9)
    with open(p, 'wb') as f:
        f.write(bytes(raw))
    load = tio.load_nii if case.startswith('nii') else tio.load_mgh
    with pytest.raises(ValueError):
        load(p)


# -------------------------------------------------------------- native ops

def test_library_is_built_from_the_port_source():
    lib = native.library()
    assert native.available()
    assert lib._name == native.SO
    assert os.path.dirname(native.SO) == _build.BUILD_DIR
    assert native.SRC.startswith(os.path.dirname(os.path.abspath(
        native.__file__)))
    assert os.path.getmtime(native.SO) >= os.path.getmtime(native.SRC)
    with open(native.SRC) as f, open(jnative._SRC) as g:
        port, ref = f.read(), g.read()
    # the same kernels; only the header comment names the port
    assert port.split('#include', 1)[1] == ref.split('#include', 1)[1]


@pytest.mark.parametrize('dtype', [np.float32, np.uint8, bool, np.float64])
@pytest.mark.parametrize('labels_dtype', [np.int32, np.int64, np.uint8])
def test_one_hot(dtype, labels_dtype):
    rng = np.random.default_rng(8)
    labels = rng.integers(-1, 6, size=(4, 5, 3))
    if labels_dtype == np.uint8:
        labels = np.abs(labels)
    labels = labels.astype(labels_dtype)
    out = native.one_hot(labels, 5, dtype=dtype)
    want = jnative.one_hot(labels, 5, dtype=dtype)
    ref = np.zeros((labels.size, 5), dtype)
    flat = labels.reshape(-1).astype(np.int64)
    ok = (flat >= 0) & (flat < 5)
    ref[np.nonzero(ok)[0], flat[ok]] = 1
    assert out.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, ref.reshape(4, 5, 3, 5))


def test_one_hot_labels_beyond_int32_take_numpy(monkeypatch):
    labels = np.asarray([0, 2 ** 31 + 1, 3, -2 ** 33], np.int64)
    calls = []
    lib = native.library()
    monkeypatch.setattr(native, 'library',
                        lambda: calls.append(1) or lib)
    out = native.one_hot(labels, 4)
    assert not calls
    np.testing.assert_array_equal(out, jnative.one_hot(labels, 4))
    np.testing.assert_array_equal(out.sum(-1), [1, 0, 1, 0])
    native.one_hot(labels[[0, 2]], 4)
    assert calls


@pytest.mark.parametrize('vol_dtype', [np.int32, np.int16, np.uint8,
                                       np.int64, np.float32])
def test_relabel(vol_dtype):
    rng = np.random.default_rng(9)
    vol = rng.choice([0, 2, 3, 41, 7], size=(6, 5, 4)).astype(vol_dtype)
    labels = [0, 2, 3, 41]
    out = native.relabel(vol, labels)
    want = jnative.relabel(vol, labels)
    ref = np.zeros_like(vol)
    for i, v in enumerate(labels):
        ref[vol == v] = i
    assert out.dtype == want.dtype == vol.dtype
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, ref)


def test_relabel_beyond_int32():
    vol = np.asarray([[0, 2 ** 40], [5, 2 ** 40]], np.int64)
    for labels in ([0, 2 ** 40], [5, 0]):
        out = native.relabel(vol, labels)
        np.testing.assert_array_equal(out, jnative.relabel(vol, labels))
    np.testing.assert_array_equal(native.relabel(vol, [0, 2 ** 40]),
                                  [[0, 1], [0, 1]])


@pytest.mark.parametrize('agg', ['nanmedian', 'nanmean'])
@pytest.mark.parametrize('n_layers', [1, 2, 5, 8])
def test_nan_aggregate(agg, n_layers):
    rng = np.random.default_rng(10 + n_layers)
    layers = rng.normal(size=(n_layers, 7, 9)).astype(np.float32)
    layers[rng.random(layers.shape) < .3] = np.nan
    layers[:, 0, 0] = np.nan          # an all-NaN column
    layers[:, 1, :] = np.nan
    layers[:n_layers // 2 + 1, 1, 1] = 2.5   # ties
    out = native.nan_aggregate_axis0(layers, agg)
    want = jnative.nan_aggregate_axis0(layers, agg)
    assert out.dtype == np.float32 and out.shape == (7, 9)
    np.testing.assert_array_equal(out, want)
    with np.errstate(invalid='ignore'), pytest.warns(RuntimeWarning):
        ref = getattr(np, agg)(layers.astype(np.float64), axis=0)
    assert np.isnan(out[0, 0]) and np.array_equal(np.isnan(out),
                                                  np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        native.nan_aggregate_axis0(layers, 'median')


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_quilt_nanmedian_native_for_f32(monkeypatch, dtype):
    rng = np.random.default_rng(11)
    vol_shape, patch, stride = (12, 10, 8), (6, 6, 4), (3, 2, 2)
    n = int(np.prod(tiling.grid_size(vol_shape, patch, stride)))
    patches = rng.normal(size=(n, *patch)).astype(dtype)
    patches[rng.random(patches.shape) < .2] = np.nan
    calls = []
    agg = native.nan_aggregate_axis0
    monkeypatch.setattr(native, 'nan_aggregate_axis0',
                        lambda *a, **k: calls.append(1) or agg(*a, **k))
    out = tiling.quilt(patches, patch, vol_shape, stride, agg='nanmedian')
    want = jtiling.quilt(patches, patch, vol_shape, stride, agg='nanmedian')
    assert len(calls) == (dtype == np.float32)
    assert out.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, want)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'SO', str(tmp_path / 'build' / 'lib.so'))
    monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-g++'))
    with pytest.raises(RuntimeError, match='building the host ops failed'):
        native.library()
    assert not native.available()
    with pytest.raises(RuntimeError):
        native.one_hot(np.zeros(3, np.int32), 2)
    # labels beyond int32 never needed the library
    native.one_hot(np.asarray([2 ** 40]), 2)
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, 'CXX', 'g++')
    monkeypatch.setattr(native, 'SRC', str(bad))
    with pytest.raises(RuntimeError, match='building the host ops failed'):
        native.library()
    assert not os.listdir(tmp_path / 'build')   # no temp file left behind


def test_unloadable_library_raises(monkeypatch, tmp_path):
    so = tmp_path / 'lib.so'
    so.write_bytes(b'not a shared object')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'SO', str(so))
    os.utime(so, (os.path.getmtime(native.SRC) + 10,) * 2)
    with pytest.raises(RuntimeError, match='loading the host ops'):
        native.library()


def test_rebuilds_when_the_source_is_newer(monkeypatch, tmp_path):
    so = tmp_path / 'lib.so'
    so.write_bytes(b'stale')
    os.utime(so, (os.path.getmtime(native.SRC) - 10,) * 2)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'SO', str(so))
    lib = native.library()
    assert lib._name == str(so) and so.stat().st_size > 100
    np.testing.assert_array_equal(native.one_hot(np.asarray([1, 0]), 2),
                                  [[0, 1], [1, 0]])
