"""
Build and load the port's CUDA kernels.

Each of `ops/csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own `nvcc`
process, all started together, and one more `nvcc` links the objects into a
shared library with a plain C interface, loaded with `ctypes`. The
library's name carries a hash of the sources and flags, so a changed source
builds anew and an unchanged one is loaded from `build/neurite_tpu_torch/`
beside the package. Nothing builds at import: the first kernel launch calls
`library()`. Any build or load failure raises.

Every kernel wrapper adds one to `launches[<kernel>]` where it launches its
kernel, and nowhere else, so a run can show which kernels it went through.
"""

import collections
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    'build', 'neurite_tpu_torch')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# kernel name -> launches since the last clear(); see the module docstring
launches = collections.Counter()

_vp, _i64, _int, _f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_POOL_VEC = [_vp, _vp] + [_i64] * 5 + [_int] * 5 + [_vp]
_SIGNATURES = {
    'neurite_pool2_fwd_f32': [_vp, _vp] + [_i64] * 5 + [_vp],
    'neurite_pool2_fwd_bf16': [_vp, _vp] + [_i64] * 5 + [_vp],
    'neurite_pool2_fwd_vec_f32': _POOL_VEC,
    'neurite_pool2_fwd_vec_bf16': _POOL_VEC,
    'neurite_pool2_bwd_f32': [_vp, _vp, _vp] + [_i64] * 5 + [_vp],
    'neurite_pool2_bwd_bf16': [_vp, _vp, _vp] + [_i64] * 5 + [_vp],
    'neurite_dice_sums_f32': [_vp, _vp, _vp, _vp, _i64, _i64, _int, _int,
                              _int, _vp],
    'neurite_dice_sums_vec_f32': [_vp] * 5 + [_i64, _i64] + [_int] * 4 + [_vp],
    'neurite_interpn3d_f32': [_vp, _vp, _vp] + [_i64] * 6 + [_int, _int, _f32,
                                                             _vp],
    'neurite_interpn3d_vec_f32': [_vp, _vp, _vp] + [_i64] * 6
                                 + [_int, _int, _f32, _vp],
    'neurite_blur_axis_f32': [_vp] * 3 + [_i64] * 3 + [_int] * 4 + [_vp],
    'neurite_lc_fwd': [_vp, _vp, _vp, _i64p, _int, _int, _int, _vp],
    'neurite_lc_dk': [_vp, _vp, _vp, _i64p, _int, _int, _int, _vp],
    'neurite_lc_dx': [_vp, _vp, _vp, _i64p, _int, _int, _int, _int, _vp],
    'neurite_mi_hist_f32': [_vp] * 8 + [_i64, _i64, _int, _int, _f32, _vp,
                                        _f32, _f32, _int, _int, _vp],
}


class Library:
    """The loaded kernels, how long the build took, and nvcc's report."""

    def __init__(self, lib, path, build_seconds, compiler_log):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.compiler_log = compiler_log

    def call(self, name, *args):
        """Call launcher `name`; raise if it returns a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err:
            msg = self.lib.neurite_cuda_error_string(err).decode()
            raise RuntimeError(f'{name}: CUDA error {err}: {msg}')


def _nvcc():
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '',
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {CSRC}')
    return srcs


@functools.cache
def library():
    """Build (if needed) and load the kernel library, once per process."""
    srcs = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, 'rb') as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f'libneurite_kernels_{h.hexdigest()[:16]}.so')
    t0 = time.perf_counter()
    log = ''
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # per-process temp name, then an atomic rename: a concurrent build
        # never loads a half-written library
        tmp = f'{path}.{os.getpid()}.tmp'
        objs = [f'{tmp}.{i}.o' for i in range(len(srcs))]
        compiles = []
        try:
            nvcc = _nvcc()
            for src, o in zip(srcs, objs):
                compiles.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, '-c', '-o', o, src], text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for src, proc in zip(srcs, compiles):
                out, _ = proc.communicate()
                log += out
                if proc.returncode != 0:
                    raise RuntimeError(
                        f'nvcc failed ({proc.returncode}) on {src}:\n{out}')
            link = [nvcc, *NVCC_FLAGS[:2], '-shared', '-o', tmp, *objs]
            res = subprocess.run(link, capture_output=True, text=True)
            log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f'nvcc link failed ({res.returncode}): {" ".join(link)}\n'
                    f'{log}')
            os.replace(tmp, path)
        finally:
            for proc in compiles:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for f in (tmp, *objs):
                if os.path.exists(f):
                    os.unlink(f)
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.neurite_cuda_error_string.argtypes = [ctypes.c_int]
    lib.neurite_cuda_error_string.restype = ctypes.c_char_p
    return Library(lib, path, time.perf_counter() - t0, log)


def stream_of(t):
    """The current CUDA stream of tensor t's device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
