"""
ctypes loader for the native host-pipeline kernels (`io/_native/hostops.cpp`).

Counterpart of `neurite_tpu/io/native.py`. The reference's host path is
single-threaded numpy; the native library multithreads its hot spots:
one-hot expansion (`generators.py:1024-1051`), relabelling
(`generators.py:1054-1066`) and the quilt's nan-median over overlap layers
(pystrum `pl.quilt`, `seg.py:363-374`).

The library is built from the port's own copy of the source with
`g++ -O3 -fPIC -shared -pthread -std=c++17` at first use, into
`build/neurite_tpu_torch/` beside the CUDA kernels, and rebuilt when the
source is newer. Nothing builds at import. A build or load failure raises:
unlike the JAX package, which falls back to numpy when g++ fails, a missing
toolchain here is a fault to see. The fallbacks that are part of the
semantics stay: labels outside int32, `one_hot` dtypes other than float32,
uint8 and bool, and non-integer volumes in `relabel` take numpy.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from neurite_tpu_torch.ops._build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), '_native',
                   'hostops.cpp')
SO = os.path.join(BUILD_DIR, 'libneurite_hostops.so')
CXX = 'g++'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-pthread', '-std=c++17')

_lock = threading.Lock()
_lib = None


def _build():
    # per-process temp name, then an atomic rename: a concurrent build
    # never loads a half-written library
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    tmp = f'{SO}.{os.getpid()}.tmp'
    cmd = [CXX, *CXX_FLAGS, SRC, '-o', tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'building the host ops failed '
                               f'({res.returncode}): {" ".join(cmd)}\n'
                               f'{res.stdout}{res.stderr}')
        os.replace(tmp, SO)
    except OSError as e:
        raise RuntimeError(f'building the host ops failed: {" ".join(cmd)}: '
                           f'{e}') from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library():
    """The loaded host-ops library, built first where it is missing or
    older than its source; once per process. Raises when it cannot be built
    or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(SO) or os.path.getmtime(SO) < os.path.getmtime(SRC):
            _build()
        try:
            lib = ctypes.CDLL(SO)
        except OSError as e:
            raise RuntimeError(f'loading the host ops {SO} failed: {e}') from e
        c_i64, c_i32 = ctypes.c_int64, ctypes.c_int32
        pf = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        pi = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        pu = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
        for name, argtypes in (('one_hot_f32', [pi, c_i64, c_i32, pf]),
                               ('one_hot_u8', [pi, c_i64, c_i32, pu]),
                               ('nanmedian_axis0', [pf, c_i64, c_i64, pf]),
                               ('nanmean_axis0', [pf, c_i64, c_i64, pf]),
                               ('relabel_i32', [pi, c_i64, pi, c_i32, pi])):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


def available():
    """True when the native library is built and loads."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _fits_int32(a):
    """Values representable in int32? Otherwise the native cast would wrap
    (e.g. a >= 2^31 label one-hotting a wrong class instead of the all-zero
    row the numpy path produces) — numpy takes those."""
    if a.size == 0 or np.issubdtype(a.dtype, np.bool_):
        return True
    if not np.issubdtype(a.dtype, np.integer):
        return False
    info = np.iinfo(np.int32)
    if np.can_cast(a.dtype, np.int32):
        return True
    return bool((a.min() >= info.min) and (a.max() <= info.max))


def one_hot(labels, nb_labels, dtype=np.float32):
    """
    labels [*shape] int -> one-hot [*shape, nb_labels]; out-of-range labels
    produce all-zero rows. Multithreaded native path for float32, uint8 and
    bool within int32; numpy otherwise.
    """
    labels = np.asarray(labels)
    shape = labels.shape
    if dtype in (np.float32, np.uint8, bool) and _fits_int32(labels):
        lib = library()
        flat = np.ascontiguousarray(labels.reshape(-1), np.int32)
        if dtype == np.float32:
            out = np.empty((flat.size, nb_labels), np.float32)
            lib.one_hot_f32(flat, flat.size, nb_labels, out)
        else:
            out = np.empty((flat.size, nb_labels), np.uint8)
            lib.one_hot_u8(flat, flat.size, nb_labels, out)
            if dtype == bool:
                out = out.view(bool)
        return out.reshape(*shape, nb_labels)
    flat = labels.reshape(-1).astype(np.int64)
    out = np.zeros((flat.size, nb_labels), dtype)
    valid = (flat >= 0) & (flat < nb_labels)
    out[np.nonzero(valid)[0], flat[valid]] = 1
    return out.reshape(*shape, nb_labels)


def nan_aggregate_axis0(layers, agg='nanmedian'):
    """NaN-skipping median/mean over axis 0 of [L, *shape], in float32 (NaN
    where a column has no value)."""
    if agg not in ('nanmedian', 'nanmean'):
        raise ValueError(f'agg must be nanmedian or nanmean, got {agg!r}')
    layers = np.asarray(layers)
    lib = library()
    shape = layers.shape[1:]
    flat = np.ascontiguousarray(layers.reshape(layers.shape[0], -1),
                                np.float32)
    out = np.empty(flat.shape[1], np.float32)
    fn = lib.nanmedian_axis0 if agg == 'nanmedian' else lib.nanmean_axis0
    fn(flat, flat.shape[0], flat.shape[1], out)
    return out.reshape(shape)


def relabel(vol, labels):
    """Map each voxel value to its index in `labels` (0 when absent)."""
    vol = np.asarray(vol)
    if (vol.dtype.kind not in 'iu' or not _fits_int32(vol)
            or not _fits_int32(np.asarray(labels))):
        out = np.zeros(vol.shape, vol.dtype)
        for idx, val in enumerate(np.asarray(labels).reshape(-1)):
            out[vol == val] = idx
        return out
    lib = library()
    flat = np.ascontiguousarray(vol.reshape(-1), np.int32)
    labs = np.ascontiguousarray(np.asarray(labels).reshape(-1), np.int32)
    out = np.empty(flat.size, np.int32)
    lib.relabel_i32(flat, flat.size, labs, labs.size, out)
    return out.reshape(vol.shape).astype(vol.dtype)
