"""
Smoke test of the PyTorch/CUDA port (`neurite_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases 1,2,10,13   # only the phases named

Drives the port's four paths through their public entry points: the
flagship 3-D UNet training step (nb_features=16, nb_levels=4, feat_mult=2,
nb_conv_per_level=2, conv_size=3, nb_labels=4, 128^3, batch 1, SoftDice,
Adam 1e-3), the config #5 synthesis -> UNet training step, the config #3
UNet -> LocallyConnected3D head training step and the MI registration step
(`benchmarks/mi_context.py:32-62`); and checks every
hand-written kernel on them against its plain PyTorch version, each path's
launch counts set to 0 just before it and read just after. Phases (phase
1 runs whatever --phases names):

  1. device: the card, its power limit, the torch and CUDA versions;
  2. build: nvcc builds the kernels (`neurite_tpu_torch/ops/csrc`);
  3. pool: K1/K2 vs the plain pool at the flagship's three pool shapes,
     config #3's two ([1, 160^3, 8], [1, 80^3, 16]), C = 7 and misaligned
     views of the flagship's shapes, float32 and bfloat16, on
     half-quantized inputs (ties) with a NaN window: forward and dx must be
     bit-equal (NaN positions equal, every other bit equal), each K1 check
     naming the body `pool_cuda.plan` picks ('vec' at the path shapes,
     counted in `pool2_fwd_vec`; 'scalar' at C = 7 and on the views), each
     K1 time beside its own bound and whether its bytes stay in L2 when
     timed back to back;
  4. Dice: K3 vs the plain sums at the flagship's (1, 128^3, 4), config
     #5's (1, 128^3, 16), (2, 1000, 3), (3, 17, 299), (3, 17, 300) and a
     misaligned view of (1, 128^3, 4): each within rtol 1e-5 (another
     summation order), two calls bit-equal, by the body `dice_red.plan`
     picks ('vec', one device launch a call, counted in `dice_sums_vec`;
     'scalar', two), each time beside its bound and by kernel name;
  5. one float32 step through the kernels and one through the plain versions
     from the same weights (TF32 off, deterministic cuDNN): losses within
     rtol 1e-5, each gradient within 1e-4 of its largest magnitude (the Dice
     sums' order is the only difference);
  6. 10 bfloat16 training steps: finite losses, launch counts of K1, K2 and
     K3 exactly those of 10 steps, every K1 and K3 launch by its 'vec' body,
     median step time, vol/s, peak memory; a profile of 3 more steps;
  7. interpolation: K4 vs the plain gather chain at the synthesis path's
     shapes ([1, 64^3, 3] linear under a smooth +-8 voxel field and under
     the same field shifted by 20 voxels; [1, 128^3, 1] nearest with fill 0
     at half-integer ties): linear within 1e-5, nearest bit-equal; K4's
     gradient vs plain autograd at 32^3;
  8. blur: K6 vs the plain per-axis convs at [3, 64^3] with 41 taps and
     [1, 128^3] with 165 and 7 taps: forward within 1e-5 of max|y|, dx
     within 1e-5 and the tap gradients within 1e-4 of their largest
     magnitude (sums over up to 2M products in other orders); each of the
     9 distinct axis passes alone within 1e-5 of max|y|, by the 'whole'
     body (`blur_cuda.plan`, counted in `blur_whole`), with its ms beside
     its own bound; one pass each at ragged shapes (L and the columns not
     multiples of 8 or 32, post 1 with 105 rows, one tap, 165 taps on a
     20-voxel axis) and by the 'halo' body (a 4096-voxel axis; 1001 and
     6143 taps in chunks), each check naming the body that ran;
  9. config #5 (bench.py's synth_rate): `labels_to_image_new(labels_in=
     range(16), out_shape=(128,)*3, one_hot=True)` feeding the bf16 UNet
     (nb_labels=16) for 10 steps of synthesis then train step; finite
     losses, one-hot maps, launch counts of K1-K4 and K6 exactly those of 10
     steps (each K6 launch by the 'whole' body, each K1 and K3 launch by
     its 'vec' body); synthesis ms, step ms,
     vol/s, peak memory; no host sync in the synthesis (CUDA's sync debug
     mode); the synthesis through the kernels against the plain CPU path on
     the same raw draws at 64^3 (every K4 and K6 call of the path: the
     Perlin blurs, the squarings, the label warp and the image blur);
     profiles of 3 synthesis calls and of 3 steps (device time by kernel,
     idle share);
 10. LC: K7 (forward), K8 (dk) and K9 (dx) vs their plain versions at the
     config #3 head's shapes (x [1, 160^3, 4], weights [1, 108, 160^3],
     g [1, 160^3, 1]; bfloat16 and float32): equal, each through its row
     body; at 32^3 with 2 filters and batch 3, in both weight layouts:
     equal, by the one-voxel bodies; at batch 1: [1, 15, 17, 19, 4]
     (W = 19: the one-voxel bodies), [1, 16, 17, 24, 4] (the row bodies, V
     a multiple of 8 but not of 8 x 256: a ragged last block), [1, 16, 17,
     18, 4] 'valid' (K7's and K8's row bodies without padding, K9's
     one-voxel body) and [1, 32^3, 4] with 2 filters (the row bodies'
     filter loops), bf16 and f32: equal. Each check names the body that
     ran, from the launch counts (`lc_fwd_row`, `lc_dk_row`, `lc_dx_row`).
     The keras-layout `lc3d_pallas` (the v1 semantics, bf16 products
     rounded in dx) at [160^3, 4], forward and both gradients: equal, by
     the one-voxel bodies, and those kernels' times. Bandwidth probes: the
     card's read rate for the weights' bytes (`w.sum(dtype=float32)` at
     [1, 108, 160^3] bf16) beside K7 and K9, K7 timed twice, and its
     write rate for dk's (`torch.empty_like(dk).zero_()`) beside K8;
 11. one float32 config #3 step at 64^3 through the kernels and one through
     the plain versions from the same weights (TF32 off, deterministic
     cuDNN): losses within rtol 1e-5, each gradient within 1e-4 of its
     largest magnitude; K7, K8 and K9 each once, by its row body;
 12. config #3 (`bench.py:335-372`): the UNet trunk (nb_features=8,
     nb_levels=3, feat_mult=2, linear output, bf16 compute) feeding
     LocallyConnected3D(filters=1, kernel_size=3, 'same', bf16 weights
     [1, 108, 160^3]), MSE, Adam 1e-4, 160^3, 10 steps: finite losses,
     launch counts of K1, K2 and K7-K9 exactly those of 10 steps, each of
     K7-K9 by its row body every step (`lc_fwd_row`, `lc_dk_row`,
     `lc_dx_row`) and each K1 launch by its 'vec' body (`pool2_fwd_vec`),
     median step ms, vol/s, peak memory; a profile of 3
     steps;
 13. MI histograms: K10 vs the plain forward at the path's [1, 128^3] with
     16 bins and centers from the data, at [2, 1000], [1, 128^3 + 37], 8
     bins clipped to [0, 1] on inputs in [-1, 2], with one NaN voxel, and at
     [1, 64^3] with 5 and 17 bins (pair tiles of 4 x 4 that do not divide
     them), 65 and 128 bins and [1, 32^3] with 1024 (past one 64-bin chunk;
     fewer blocks at 1024, for the scratch): within 1e-5 of the largest
     magnitude, NaN where the plain version has it, two calls bit-equal,
     each by the 'tiled' body (`mi_hist_tiled`); alpha as a CUDA 0-d tensor,
     through the wrapper and `ops.mi_histograms(impl='pallas')`, under
     CUDA's sync debug mode 'error': no host sync, bit-equal to the float-
     alpha call; `MIHistograms`' dx and dy on the K10 route vs the plain
     forward; K10's time by its two launches; the materialized route's time
     (two soft_quantize maps and a bmm) as context;
 14. one MI registration step at 64^3 (the field at +-2 voxels) on the card
     (K4, K10) and on the CPU (plain forms), both on the kernel route
     (`volumes_fused(impl='pallas')`): losses within rtol 1e-5, the field
     gradient within 1e-4 of its largest magnitude;
 15. MI registration at 128^3 (moving/fixed blob pair, field [1, 128^3, 3]
     from zero, clamp +-3, `MutualInformation(nb_bins=16)`, Adam 1e-2),
     10 steps: finite, falling losses, launches exactly K10 10 (by the
     'tiled' body) and K4 10,
     no host sync in a step, median step ms, pairs/s, peak memory, a
     profile of 3 steps, and the same steps through `MI.volumes` (twin).

A kernel's, plain version's or library call's ms is its device time: the
durations of the device events torch.profiler records over 20 calls,
summed, over 20 (the host's launch time is not in it; "one kernel call"
lines print the CUDA-event time of a call, which is; where the profiler
records no event in three tries, CUDA events around the 20 calls, and a
line before says so). Each kernel's bound
is the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the H100's peak for their type
(float32 outside the tensor cores: 67 TFLOP/s); its `library_ms` is one
PyTorch call computing the same function, timed here and used nowhere in
the port.

Prints one line per check, then a JSON line of the kernels, and last
`{"ok": true, "device": {...}}`. Any failed check exits non-zero; so does a
machine without a CUDA device. Run with --phases, a kernel's fields that
no phase of the run measured are null, and both JSON lines carry the
phases that ran.
"""

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import training
from neurite_tpu_torch.ops import (_build, blur, blur_cuda, dice_red, lc_cuda,
                                   mi_hist, mi_hist_cuda, pool, pool_cuda,
                                   warp_cuda)
from neurite_tpu_torch.utils import core, spatial

VOL = 128
NB_LABELS = 4
POOL_SHAPES = [(1, 128, 128, 128, 16), (1, 64, 64, 64, 32), (1, 32, 32, 32, 64)]
LC_POOL_SHAPES = [(1, 160, 160, 160, 8), (1, 80, 80, 80, 16)]   # config #3
L2_BYTES = 50e6     # the H100's L2: a call that moves less stays there
TRAIN_STEPS = 10
WARMUP_STEPS = 3
SYNTH_LABELS = 16
CHECK_VOL = 64      # the synthesis check against the plain CPU path
PROFILE_STEPS = 3
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# name: (source, TPU kernel it replaces, the phase that checks and times it,
# the phase whose path run counts its launches)
KERNELS = {
    'pool2_fwd': ('neurite_tpu_torch/ops/csrc/pool.cu',
                  'neurite_tpu/ops/pool_pallas.py:182', '3', '6'),
    'pool2_bwd': ('neurite_tpu_torch/ops/csrc/pool.cu',
                  'neurite_tpu/ops/pool_pallas.py:199', '3', '6'),
    'dice_sums': ('neurite_tpu_torch/ops/csrc/dice_red.cu',
                  'neurite_tpu/ops/dice_red.py:60', '4', '6'),
    'interpn': ('neurite_tpu_torch/ops/csrc/interpn.cu',
                'neurite_tpu/ops/pallas_warp.py:114 and :302', '7', '9'),
    'blur': ('neurite_tpu_torch/ops/csrc/blur.cu',
             'neurite_tpu/ops/blur.py:118', '8', '9'),
    'lc_fwd': ('neurite_tpu_torch/ops/csrc/lc.cu',
               'neurite_tpu/ops/pallas_lc2.py:230 and '
               'neurite_tpu/ops/pallas_lc.py:188', '10', '12'),
    'lc_dk': ('neurite_tpu_torch/ops/csrc/lc.cu',
              'neurite_tpu/ops/pallas_lc2.py:263 and '
              'neurite_tpu/ops/pallas_lc.py:220', '10', '12'),
    'lc_dx': ('neurite_tpu_torch/ops/csrc/lc.cu',
              'neurite_tpu/ops/pallas_lc.py:252', '10', '12'),
    'mi_hist': ('neurite_tpu_torch/ops/csrc/mi_hist.cu',
                'neurite_tpu/ops/mi_hist.py:90', '13', '15'),
}
MEASURED = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
PHASES = ('1', '2', '3', '4', '5', '6', '7', '8', '9a', '9', '10', '11', '12',
          '13', '14', '15')
LC_VOL = 160        # config #3's volume
LC_CHECK_VOL = 64   # its float32 step, kernels vs plain
LC_KS = (3, 3, 3)
MI_BINS = 16        # the registration path's MutualInformation(nb_bins=16)
REG_CHECK_VOL = 64  # its step on the card vs the plain CPU path
REG_LR = 1e-2


class Checks:
    """Collects pass/fail per check so every phase reports before exit."""

    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail=''):
        print(f'  [{"ok" if ok else "FAIL"}] {name} {detail}', flush=True)
        if not ok:
            self.failed.append(name)


def device_events(prof):
    """(device ms, count, name) of each kernel, copy and set that a
    torch.profiler run recorded, summed by name. Annotations (such as
    `Optimizer.step#Adam.step`) span kernels already counted: left out."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, 'device_type', '')).endswith('CUDA') \
                or getattr(e, 'is_user_annotation', False) \
                or re.fullmatch(r'[\w.]+#[\w.]+', e.key):
            continue
        dev = getattr(e, 'self_device_time_total',
                      getattr(e, 'self_cuda_time_total', 0))
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    return rows


def events_by_name(fn, reps=20, warmup=3):
    """{device event name: (ms, events) of one fn() call}: the durations
    and the count of the events torch.profiler records over `reps` calls,
    summed by name, over reps; the count is None where the profiler
    recorded nothing."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler now and then records no event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_events(prof)
        if rows:
            return {name: (ms / reps, n / reps) for ms, n, name in rows}
    # none in three tries: CUDA events around the reps (the host's launch
    # time between the calls is then in it)
    print('  (the profiler recorded no event in three tries: the next time '
          'is by CUDA events around 20 calls)', flush=True)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return {'all launches (CUDA events; no profiler events)':
            (a.elapsed_time(b) / reps, None)}


def time_by_name(fn, reps=20, warmup=3):
    """{device event name: ms of one fn() call} (see events_by_name)."""
    return {k: ms for k, (ms, _) in events_by_name(fn, reps, warmup).items()}


def time_ms(fn, reps=20, warmup=3):
    """Device time of one fn() call in ms: the durations of the device
    events torch.profiler records over `reps` calls, summed, over reps.
    The host's time between launches is not in it (see call_ms)."""
    return sum(time_by_name(fn, reps, warmup).values())


def clocks_under(fn, seconds=1.):
    """(median SM clock MHz, median power W) that nvidia-smi samples every
    50 ms while fn() runs back to back for about `seconds`; None where it
    gives no sample. The sampler is stopped before this returns."""
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '50'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            rows.append([float(v) for v in line.split(',')[:2]])
        except ValueError:
            continue
    if not rows:
        return None
    return tuple(statistics.median(r[k] for r in rows) for k in (0, 1))


def call_ms(fn, reps=20, warmup=3):
    """Median ms of one fn() call by CUDA events around it: the device time,
    or the host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops=0.):
    """(least ms, 'bytes' or 'operations'): the larger of bytes over the
    memory rate and float32 operations over the non-tensor-core peak."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOP_PER_S
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def add_bound(r, nbytes, flops=0.):
    """Add one call's bound to kernel record r (a step's calls sum); its
    `bound_by` is the kind that sets the larger part of the sum."""
    t, by = bound_ms(nbytes, flops)
    r['bound_ms'] += t
    share = r.setdefault('_bound_share', {})
    share[by] = share.get(by, 0.) + t
    r['bound_by'] = max(share, key=share.get)


def bit_equal(a, b):
    """Same shape and dtype, NaN at the same places, all other bits equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a[~na].view(ity), b[~nb].view(ity))


def max_abs_err(a, b):
    keep = ~(torch.isnan(a) | torch.isnan(b))
    d = (a.float() - b.float())[keep].abs()
    return float(d.max()) if d.numel() else 0.


def rel_err(a, b):
    """max |a - b| over max |b|, both where neither is NaN (0 if nowhere)."""
    keep = ~(torch.isnan(a) | torch.isnan(b))
    if not bool(keep.any()):
        return 0.
    return max_abs_err(a, b) / max(float(b[keep].abs().max()), 1e-30)


def phase_device():
    print('== 1. device', flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this smoke test needs one GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'  torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} '
          f'count {torch.cuda.device_count()}', flush=True)
    return card


def phase_build():
    print('== 2. build', flush=True)
    lib = _build.library()
    print(f'  built {lib.path} in {lib.build_seconds:.3f} s', flush=True)
    for line in lib.compiler_log.splitlines():
        if 'Compiling entry' in line or 'Used' in line or 'spill' in line:
            print('  nvcc: ' + line.strip())
    return lib.build_seconds


def misaligned(x):
    """x copied into a contiguous view whose data pointer is one element
    past a 16-byte boundary: the kernels' scalar bodies take it."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


def pool_input(shape, dtype, gen):
    """Halves (many tied maxima; +0.0 turns -0.0 into +0.0 so that
    "bit-equal" does not hinge on which signed zero a max returns) with a
    NaN in the window (0, 1, 1, 2) of channel 1, and a cotangent."""
    x = torch.round(torch.randn(shape, generator=gen, device='cuda')
                    * 2) / 2 + 0.
    x[0, 2, 3, 4, 1] = float('nan')
    out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2, shape[4])
    g = torch.randn(out, generator=gen, device='cuda').to(dtype)
    return x.to(dtype).contiguous(), g


def phase_pool(checks, res):
    print('== 3. pool K1/K2 vs plain', flush=True)
    w = (2, 2, 2)
    gen = torch.Generator(device='cuda').manual_seed(3)
    # (shape, layout, the K1 body it must take, its role): the flagship's
    # and config #5's three levels, config #3's two, then the scalar body at
    # C = 7 and on misaligned views of the flagship's levels (K1's earlier
    # body, timed beside the vec body in this call)
    cases = ([(s, 'contiguous', 'vec', 'flagship') for s in POOL_SHAPES]
             + [(s, 'contiguous', 'vec', 'config #3') for s in LC_POOL_SHAPES]
             + [((1, 32, 32, 32, 7), 'contiguous', 'scalar', 'C = 7')]
             + [(s, 'misaligned', 'scalar', 'flagship, misaligned')
                for s in POOL_SHAPES])
    k1_steps = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, layout, want, role in cases:
            x, g = pool_input(shape, dtype, gen)
            if layout == 'misaligned':
                x = misaligned(x)
            _build.launches.clear()
            yk = pool_cuda.pool2_fwd(x)
            vec_launches = _build.launches['pool2_fwd_vec']
            body = pool_cuda.plan(x.shape, x.dtype,
                                  (x.data_ptr(), yk.data_ptr())).body
            yp = pool._max_pool_tiled_fwd(x, w)
            dk = pool_cuda.pool2_bwd(x, g)
            dp = pool._max_pool_tiled_bwd(x, yp, g, w)
            torch.cuda.synchronize()
            tag = f'{str(dtype)[6:]} {shape} {layout}'
            nan_win = bool(torch.isnan(yk[0, 1, 1, 2, 1]))
            checks.check(f'pool fwd {tag}', bit_equal(yk, yp) and nan_win
                         and body == want and vec_launches == (body == 'vec'),
                         f'body {body!r} (expected {want!r}, counted '
                         f'pool2_fwd_vec {vec_launches}); nan window kept: '
                         f'{nan_win}')
            n_g = int((dk[0, 2:4, 2:4, 4:6, 1] == g[0, 1, 1, 2, 1]).sum())
            checks.check(f'pool bwd {tag}', bit_equal(dk, dp)
                         and n_g == 8, f'nan window taps given g: {n_g}/8')
            n, isz = x.numel(), x.element_size()
            nbytes = {'pool2_fwd': (n + n // 8) * isz,
                      'pool2_bwd': (2 * n + n // 8) * isz}
            k1_ms = time_ms(lambda: pool_cuda.pool2_fwd(x))
            resident = 'yes' if nbytes['pool2_fwd'] < L2_BYTES else 'no'
            print(f'  pool2_fwd {tag}: {body} body {k1_ms:.4f} ms, bound '
                  f'{bound_ms(nbytes["pool2_fwd"])[0]:.4f} ms (bytes '
                  f'{nbytes["pool2_fwd"]}; L2-resident back to back: '
                  f'{resident})', flush=True)
            if dtype == torch.bfloat16 and role.startswith('flagship'):
                k1_steps[role] = k1_steps.get(role, 0.) + k1_ms
            if role != 'flagship':
                continue
            t = {'pool2_fwd': (k1_ms,
                               time_ms(lambda: pool._max_pool_tiled_fwd(x, w))),
                 'pool2_bwd': (time_ms(lambda: pool_cuda.pool2_bwd(x, g)),
                               time_ms(lambda: pool._max_pool_tiled_bwd(
                                   x, yp, g, w)))}
            # yardsticks on the channels-first view (a view, no copy)
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            _, idx = torch.nn.functional.max_pool3d(xc, 2, return_indices=True)
            lib = {'pool2_fwd': time_ms(
                       lambda: torch.nn.functional.max_pool3d(xc, 2)),
                   'pool2_bwd': time_ms(
                       lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                           gc, xc, [2, 2, 2], [2, 2, 2], [0, 0, 0], [1, 1, 1],
                           False, idx))}
            calls = {'pool2_fwd': call_ms(lambda: pool_cuda.pool2_fwd(x)),
                     'pool2_bwd': call_ms(lambda: pool_cuda.pool2_bwd(x, g))}
            for name, (k_ms, p_ms) in t.items():
                err = max_abs_err(yk, yp) if name == 'pool2_fwd' \
                    else max_abs_err(dk, dp)
                r = res[name]
                r['max_abs_err'] = max(r['max_abs_err'], err)
                if dtype == torch.bfloat16:  # the training step's type
                    r['ms'] += k_ms
                    r['plain_ms'] += p_ms
                    r['library_ms'] += lib[name]
                    add_bound(r, nbytes[name])
                print(f'  {name} {tag}: kernel {k_ms:.4f} ms, plain '
                      f'{p_ms:.4f} ms, library {lib[name]:.4f} ms, bound '
                      f'{bound_ms(nbytes[name])[0]:.4f} ms; one kernel call '
                      f'{calls[name]:.4f} ms', flush=True)
    print('  K1 over the flagship\'s three bf16 levels: '
          + ', '.join(f'{role} {ms:.4f} ms' for role, ms in k1_steps.items())
          + ' (the misaligned views take the scalar body)', flush=True)


def phase_dice(checks, res):
    print('== 4. Dice sums K3 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(4)
    # (shape, layout, the K3 body it must take): the flagship's L = 4 (the
    # path), config #5's L = 16, L = 3 and 299 (scalar), 300 (vec: a
    # multiple of 4), and the flagship's shape on misaligned views (the
    # earlier two-launch body, each launch timed by name)
    cases = [((1, VOL ** 3, NB_LABELS), 'contiguous', 'vec'),
             ((1, VOL ** 3, SYNTH_LABELS), 'contiguous', 'vec'),
             ((2, 1000, 3), 'contiguous', 'scalar'),
             ((3, 17, 299), 'contiguous', 'scalar'),
             ((3, 17, 300), 'contiguous', 'vec'),
             ((1, VOL ** 3, NB_LABELS), 'misaligned', 'scalar')]
    for shape, layout, want in cases:
        x = torch.softmax(torch.randn(shape, generator=gen, device='cuda'), -1)
        lab = torch.randint(0, shape[2], shape[:2], generator=gen,
                            device='cuda')
        y = torch.nn.functional.one_hot(lab, shape[2]).float()
        if layout == 'misaligned':
            x, y = misaligned(x), misaligned(y)
        body = dice_red.plan(*shape, (x.data_ptr(), y.data_ptr())).body
        _build.launches.clear()
        k = dice_red.dice_sums_cuda(x, y)
        vec_launches = _build.launches['dice_sums_vec']
        again = dice_red.dice_sums_cuda(x, y)
        p = dice_red._dice_sums_plain(x, y)
        torch.cuda.synchronize()
        tag = f'{shape} {layout}'
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=0.) for a, b in zip(k, p))
        err = max(max_abs_err(a, b) for a, b in zip(k, p))
        rel = max(rel_err(a, b) for a, b in zip(k, p))
        same = all(torch.equal(a, b) for a, b in zip(k, again))
        checks.check(f'dice sums {tag}', ok and same and body == want
                     and vec_launches == (body == 'vec'),
                     f'body {body!r} (expected {want!r}, counted '
                     f'dice_sums_vec {vec_launches}); max abs err {err:.6g}, '
                     f'over the largest sum {rel:.3g} (each sum within rtol '
                     f'1e-5); two calls bit-equal: {same}')
        events = events_by_name(lambda: dice_red.dice_sums_cuda(x, y))
        counts = [n for _, n in events.values()]
        per_call = None if None in counts else sum(counts)
        if body == 'vec':
            # a count the profiler did not record is reported, not failed
            checks.check(f'dice sums {tag} device launches a call',
                         per_call in (1, None),
                         'not measured (no profiler events)'
                         if per_call is None else f'{per_call:g} (1)')
        k_ms = sum(ms for ms, _ in events.values())
        nbytes = (2 * x.numel() + 3 * shape[0] * shape[2]) * 4
        bound = bound_ms(nbytes, 6 * x.numel())[0]
        print(f'  dice_sums {tag}: {body} body {k_ms:.4f} ms, bound '
              f'{bound:.4f} ms, device launches a call {per_call}; by name: '
              + ', '.join(f'{name[:40]} {ms:.4f} ms'
                          for name, (ms, _) in events.items()), flush=True)
        if shape != (1, VOL ** 3, NB_LABELS) or layout != 'contiguous':
            continue
        p_ms = time_ms(lambda: dice_red._dice_sums_plain(x, y))
        res['dice_sums'].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                library_ms=None)
        # x and y read once, three [1, L] sums written; a multiply-add a sum
        add_bound(res['dice_sums'], nbytes, 6 * x.numel())
        c_ms = call_ms(lambda: dice_red.dice_sums_cuda(x, y))
        print(f'  dice_sums {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} '
              f'ms; one kernel call {c_ms:.4f} ms', flush=True)


def flagship_inputs():
    """bench.py's inputs: numpy default_rng(0) normal image, random labels."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, VOL, VOL, VOL, 1)).astype(np.float32)
    lab = rng.integers(0, NB_LABELS, size=(1, VOL, VOL, VOL))
    x = torch.from_numpy(x).cuda()
    y = torch.nn.functional.one_hot(torch.from_numpy(lab).cuda(),
                                    NB_LABELS).float()
    return x, y


def flagship(dtype=None, pool_impl='auto'):
    return nt.models.unet(
        nb_features=16, input_shape=(VOL, VOL, VOL, 1), nb_levels=4,
        conv_size=3, nb_labels=NB_LABELS, feat_mult=2, nb_conv_per_level=2,
        dtype=dtype, pool_impl=pool_impl,
        generator=torch.Generator().manual_seed(0), device='cuda')


def phase_parity(checks, x, y):
    print('== 5. flagship f32 step: kernels vs plain', flush=True)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for impl in ('kernel', 'plain'):
            model = flagship(pool_impl=impl)
            with torch.no_grad():
                pred = model(x, training=False)
            state = training.create_train_state(model, training.adam(1e-3))
            loss_fn = nt.losses.SoftDice(check_input_limits=False,
                                         use_kernel=impl).loss
            step = training.make_train_step(loss_fn)
            state, m = step(state, (x, y),
                            torch.Generator(device='cuda').manual_seed(1))
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            runs[impl] = (pred, float(m['loss']), grads)
            del model, state
        (pk, lk, gk), (pp, lp, gp) = runs['kernel'], runs['plain']
        shape_ok = tuple(pk.shape) == (1, VOL, VOL, VOL, NB_LABELS)
        finite = bool(torch.isfinite(pk).all())
        sums = float((pk.sum(-1) - 1).abs().max())
        checks.check('flagship prediction', shape_ok and finite and sums < 1e-5,
                     f'shape {tuple(pk.shape)}, finite {finite}, '
                     f'max |sum-1| {sums:.3g}')
        checks.check('flagship prediction kernel == plain',
                     bool(torch.equal(pk, pp)),
                     f'max abs diff {max_abs_err(pk, pp):.3g}')
        checks.check('flagship f32 loss', abs(lk - lp) <= 1e-5 * abs(lp),
                     f'kernel {lk!r} plain {lp!r} (rtol 1e-5)')
        worst = max(float((gk[n] - gp[n]).abs().max() / gp[n].abs().max())
                    for n in gp)
        checks.check('flagship f32 grads', worst <= 1e-4,
                     f'{len(gp)} tensors, worst max|diff|/max|g| {worst:.3g} '
                     f'(limit 1e-4)')
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def phase_train(checks, res, x, y):
    print(f'== 6. flagship bf16 training, {TRAIN_STEPS} steps', flush=True)
    model = flagship(dtype=torch.bfloat16)
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    gen = torch.Generator(device='cuda').manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, (x, y), gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m['loss'])
    counts = dict(_build.launches)
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    checks.check('training losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    want = {'pool2_fwd': 3 * TRAIN_STEPS, 'pool2_bwd': 3 * TRAIN_STEPS,
            'dice_sums': TRAIN_STEPS}
    for name, n in want.items():
        got = counts.get(name, 0)
        checks.check(f'launches {name}', got == n and got > 0,
                     f'{got} (expected {n})')
        res[name]['launches'] = got
    check_vec_bodies(checks, 'flagship', counts)
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  step ms (median of steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}): '
          f'{step_ms:.3f}; all: '
          + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  vol/s {1e3 / step_ms:.3f}; peak memory '
          f'{peak} B ({peak / 2 ** 30:.3f} GiB)', flush=True)
    try:
        report_profile('flagship step',
                       lambda i: step(state, (x, y), gen), TRAIN_STEPS)
    except Exception as e:  # noqa: BLE001  (a reading, not a check)
        print(f'  flagship profile not measured: {type(e).__name__}: {e}')


def check_vec_bodies(checks, path, counts):
    """Every K1 and K3 launch of a path's run by its 'vec' body."""
    for name in ('pool2_fwd', 'dice_sums'):
        if name in counts:
            got = counts.get(f'{name}_vec', 0)
            checks.check(f'{path} launches {name}_vec', got == counts[name],
                         f'{got} (expected {counts[name]}, every {name} '
                         f'launch)')


def smooth_field(shape, amp, gen):
    """A smooth [1, *shape, 3] displacement field with max |value| = amp:
    normal noise at 1/8 resolution, upsampled trilinearly."""
    low = torch.randn((1, 3, *[max(s // 8, 2) for s in shape]), generator=gen,
                      device='cuda')
    f = torch.nn.functional.interpolate(low, size=shape, mode='trilinear',
                                        align_corners=True)
    f = f.permute(0, 2, 3, 4, 1).contiguous()
    return f * (amp / f.abs().max())


def grid_sample_call(vol, loc, method):
    """F.grid_sample on `vol` [B, D, H, W, C] at voxel coordinates `loc`
    [B, *out, 3]: the layout permutation is made here, outside the timed
    call it returns."""
    shape = torch.tensor(vol.shape[1:4], dtype=torch.float32, device='cuda')
    g = (loc / (shape - 1) * 2 - 1).flip(-1).contiguous()    # (x, y, z)
    v = vol.permute(0, 4, 1, 2, 3).contiguous()
    mode = 'bilinear' if method == 'linear' else 'nearest'
    return lambda: torch.nn.functional.grid_sample(
        v, g, mode=mode, padding_mode='border', align_corners=True)


def phase_interpn(checks, res):
    print('== 7. interpolation K4 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(7)
    r = res['interpn']
    v64 = (64,) * 3
    field = smooth_field(v64, 8., gen)
    grid = core.grid_points(v64, 'cuda')[None]
    vol3 = torch.randn((1, *v64, 3), generator=gen, device='cuda')
    v128 = (VOL,) * 3
    lab = torch.randint(0, SYNTH_LABELS, (1, *v128, 1), generator=gen,
                        device='cuda').float()
    # every point on a half-integer or integer: the ties of round-half-even
    loc128 = torch.round(2 * (core.grid_points(v128, 'cuda')[None]
                              + smooth_field(v128, 8., gen))) / 2
    cases = [  # (name, vol, loc, method, fill, calls per synthesis step)
        ('64^3 C=3 linear, +-8 field (v2 regime)', vol3, grid + field,
         'linear', None, 5),
        ('64^3 C=3 linear, +-8 field + 20 shift (v1 regime)', vol3,
         grid + field + 20., 'linear', None, 0),
        ('128^3 C=1 nearest, fill 0, half-integer ties', lab, loc128,
         'nearest', 0., 1),
    ]
    for name, vol, loc, method, fill, per_step in cases:
        k = warp_cuda.interpn3d(vol, loc, method, fill)
        p = core.interpn_plain(vol, loc, method, fill, batched=True)
        torch.cuda.synchronize()
        err = max_abs_err(k, p)
        if method == 'nearest':
            ok = bit_equal(k, p)
            filled = float((k == 0).float().mean())
            checks.check(f'interpn {name}', ok,
                         f'bit-equal {ok}; filled share {filled:.4f}')
        else:
            ok = err <= 1e-5
            checks.check(f'interpn {name}', ok,
                         f'max abs err {err:.3g} (atol 1e-5); bit-equal '
                         f'{bit_equal(k, p)}')
        k_ms = time_ms(lambda: warp_cuda.interpn3d(vol, loc, method, fill))
        p_ms = time_ms(lambda: core.interpn_plain(vol, loc, method, fill,
                                                  batched=True))
        l_ms = time_ms(grid_sample_call(vol, loc, method))
        nbytes = (vol.numel() + loc.numel() + k.numel()) * 4
        b_ms, _ = bound_ms(nbytes)
        c_ms = call_ms(lambda: warp_cuda.interpn3d(vol, loc, method, fill))
        print(f'  interpn {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
              f'grid_sample {l_ms:.4f} ms, bound {b_ms:.4f} ms (bytes); one '
              f'kernel call {c_ms:.4f} ms', flush=True)
        r['max_abs_err'] = max(r['max_abs_err'], err)
        for _ in range(per_step):   # a synthesis step's calls sum
            r['ms'] += k_ms
            r['plain_ms'] += p_ms
            r['library_ms'] += l_ms
            add_bound(r, nbytes)

    # the gradient: K4's autograd function against plain autograd, 32^3
    v32 = (32,) * 3
    vol = torch.randn((1, *v32, 3), generator=gen, device='cuda')
    loc = core.grid_points(v32, 'cuda')[None] + smooth_field(v32, 4., gen)
    g = torch.randn((1, *v32, 3), generator=gen, device='cuda')
    grads = []
    for fn in (lambda v, lc: warp_cuda.interpn3d(v, lc, 'linear', None),
               lambda v, lc: core.interpn_plain(v, lc, 'linear', None,
                                                batched=True)):
        v, lc = vol.clone().requires_grad_(), loc.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(v, lc), (v, lc), g))
    torch.cuda.synchronize()
    errs = [max_abs_err(a, b) for a, b in zip(*grads)]
    checks.check('interpn gradient 32^3 (dvol, dloc)', max(errs) <= 1e-5,
                 f'max abs err {errs[0]:.3g}, {errs[1]:.3g} (atol 1e-5)')


def blur_pass_flops(shape, a, width):
    """Operations one SAME pass of x [N, *spatial] along spatial axis `a`
    needs: a multiply-add for each tap that falls inside the axis (taps in
    the zero padding need no work; a 165-tap window on a 128-voxel axis
    keeps about 112 of its taps per output)."""
    n, *sp = shape
    r, i = width // 2, np.arange(sp[a])
    taps = int((np.minimum(i + r, sp[a] - 1) - np.maximum(i - r, 0)
                + 1).sum())
    return 2 * n * (int(np.prod(sp)) // sp[a]) * taps


def blur_flops(shape, widths):
    """Operations of a separable SAME blur: its three passes'."""
    return sum(blur_pass_flops(shape, a, w) for a, w in enumerate(widths))


def blur_body(fn):
    """(result, K6 body that ran: 'whole' or 'halo') of fn(), one K6
    launch, read from the launch counts."""
    before = _build.launches['blur_whole']
    out = fn()
    return out, 'whole' if _build.launches['blur_whole'] > before else 'halo'


# K6 beyond the path: (shape, axis, taps, body `blur_cuda.plan` gives)
BLUR_RAGGED = [
    ((2, 20, 33, 45), 1, 165, 'whole'),   # 165 taps on a 20-voxel axis
    ((1, 37, 5, 6), 1, 7, 'whole'),       # L and post (30) not of 8 or 32
    ((3, 7, 5, 29), 3, 41, 'whole'),      # post 1, pre 105, L 29
    ((2, 6, 5, 11), 2, 1, 'whole'),       # one tap
    ((1, 4096, 4, 4), 1, 165, 'halo'),    # a long axis: 64-row tiles
    ((1, 400, 8, 40), 1, 1001, 'halo'),   # taps in chunks, post 320
    ((1, 4, 4, 300), 3, 6143, 'halo'),    # taps in chunks, post 1
]


def phase_blur(checks, res):
    print('== 8. blur K6 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(8)
    r = res['blur']
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False   # the plain convs in float32
    try:
        cases = [  # (shape, sigma, taps, calls per synthesis step)
            ((3, 64, 64, 64), 16 / 2.355, 41, 2),
            ((1, VOL, VOL, VOL), 64 / 2.355, 165, 1),
            ((1, VOL, VOL, VOL), 1., 7, 1),
        ]
        for shape, sigma, width, per_step in cases:
            x = torch.randn(shape, generator=gen, device='cuda')
            k1 = core.gaussian_kernel(sigma, windowsize=width, device='cuda')
            ks = [k1, k1, k1]
            yk = blur.blur3d(x, ks)
            yp = blur._plain(x, ks)
            torch.cuda.synchronize()
            err = max_abs_err(yk, yp)
            tol = 1e-5 * float(yp.abs().max())
            tag = f'{list(shape)} {width} taps'
            checks.check(f'blur fwd {tag}', err <= tol,
                         f'max abs err {err:.3g} (limit {tol:.3g})')

            # backward: dx by K6 with flipped taps, taps by plain torch,
            # against autograd through the plain convs
            g = torch.randn(shape, generator=gen, device='cuda')
            grads = []
            for fn in (blur.blur3d, blur._plain):
                xi = x.clone().requires_grad_()
                ki = [k1.clone().requires_grad_() for _ in range(3)]
                grads.append(torch.autograd.grad(fn(xi, ki), [xi, *ki], g))
            torch.cuda.synchronize()
            (dxk, *dkk), (dxp, *dkp) = grads
            ex = max_abs_err(dxk, dxp) / float(dxp.abs().max())
            ek = max(max_abs_err(a, b) / float(b.abs().max())
                     for a, b in zip(dkk, dkp))
            checks.check(f'blur bwd {tag}', ex <= 1e-5 and ek <= 1e-4,
                         f'dx {ex:.3g} (limit 1e-5), taps {ek:.3g} (limit '
                         f'1e-4), relative to the largest magnitude')

            k_ms = time_ms(lambda: blur.blur3d(x, ks))
            p_ms = time_ms(lambda: blur._plain(x, ks))
            xc = x[:, None]
            if width <= 7:   # one conv3d with the outer-product kernel
                w3 = (k1[:, None, None] * k1[None, :, None]
                      * k1[None, None, :])[None, None]
                l_ms = time_ms(lambda: torch.nn.functional.conv3d(
                    xc, w3, padding=width // 2))
                lib = 'one conv3d'
            else:            # three per-axis conv3d calls
                ws = [k1.reshape(1, 1, -1, 1, 1), k1.reshape(1, 1, 1, -1, 1),
                      k1.reshape(1, 1, 1, 1, -1)]
                pads = [(width // 2, 0, 0), (0, width // 2, 0),
                        (0, 0, width // 2)]

                def three(xc=xc, ws=ws, pads=pads):
                    y = xc
                    for w, p in zip(ws, pads):
                        y = torch.nn.functional.conv3d(y, w, padding=p)
                    return y
                l_ms = time_ms(three)
                lib = 'three conv3d calls'
            nbytes = 2 * x.numel() * 4 + 3 * width * 4
            flops = blur_flops(shape, (width,) * 3)
            b_ms, by = bound_ms(nbytes, flops)
            c_ms = call_ms(lambda: blur.blur3d(x, ks))
            print(f'  blur {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, '
                  f'{lib} {l_ms:.4f} ms, bound {b_ms:.4f} ms ({by}); one '
                  f'kernel call (3 launches) {c_ms:.4f} ms', flush=True)
            # each axis pass alone: its ms, its own bound, the body that ran
            for axis in (1, 2, 3):
                (ya, body), yb = (blur_body(lambda: blur_cuda.blur_axis(
                    x, k1, axis)), core.conv_axis(x, k1, axis - 1))
                torch.cuda.synchronize()
                ea = max_abs_err(ya, yb)
                ta = 1e-5 * float(yb.abs().max())
                checks.check(f'blur pass {tag} axis {axis}',
                             ea <= ta and body == 'whole',
                             f'max abs err {ea:.3g} (limit {ta:.3g}), body '
                             f'{body} (whole expected)')
                a_ms = time_ms(lambda: blur_cuda.blur_axis(x, k1, axis))
                ba_ms, ba_by = bound_ms(
                    2 * x.numel() * 4 + width * 4,
                    blur_pass_flops(shape, axis - 1, width))
                print(f'  blur pass {tag} axis {axis} ({body}): kernel '
                      f'{a_ms:.4f} ms, bound {ba_ms:.4f} ms ({ba_by}), '
                      f'{ba_ms / a_ms:.1%} of it', flush=True)
                if width == 165 and axis == 1:
                    clk = clocks_under(lambda: blur_cuda.blur_axis(
                        x, k1, axis))
                    print(f'  SM clock and power under that pass back to '
                          f'back (nvidia-smi, median): {clk} (MHz, W)',
                          flush=True)
            r['max_abs_err'] = max(r['max_abs_err'], err)
            for _ in range(per_step):   # a synthesis step's calls sum
                r['ms'] += k_ms
                r['plain_ms'] += p_ms
                r['library_ms'] += l_ms
                add_bound(r, nbytes, flops)

        # shapes beyond the path: ragged lengths and columns, one tap, a
        # window wider than its axis, the halo tiles and the taps in chunks
        for shape, axis, width, want in BLUR_RAGGED:
            x = torch.randn(shape, generator=gen, device='cuda')
            k1 = torch.rand(width, generator=gen, device='cuda') + .1
            (yk, body), yp = (blur_body(lambda: blur_cuda.blur_axis(
                x, k1, axis)), core.conv_axis(x, k1, axis - 1))
            torch.cuda.synchronize()
            err = max_abs_err(yk, yp)
            tol = 1e-5 * float(yp.abs().max())
            checks.check(f'blur pass {list(shape)} axis {axis} {width} taps',
                         err <= tol and body == want,
                         f'max abs err {err:.3g} (limit {tol:.3g}), body '
                         f'{body} ({want} expected, '
                         f'{blur_cuda.plan(shape, axis, width)})')
    finally:
        torch.backends.cudnn.allow_tf32 = flags


def synth_model(vol, device):
    """bench.py's synth_rate generator: every knob at its default."""
    return nt.models.labels_to_image_new(
        labels_in=range(SYNTH_LABELS), out_shape=(vol,) * 3, one_hot=True,
        device=device)


def to_device(obj, device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def phase_synth_check(checks):
    print(f'== 9a. synthesis at {CHECK_VOL}^3: kernels vs the plain CPU path',
          flush=True)
    lab = torch.from_numpy(np.random.default_rng(1).integers(
        0, SYNTH_LABELS, size=(1, *(CHECK_VOL,) * 3, 1)))
    gpu, cpu = synth_model(CHECK_VOL, 'cuda'), synth_model(CHECK_VOL, 'cpu')
    for m in (gpu, cpu):
        m.returns = [(k, True) for k, _ in m.returns]
    # the raw draws (Perlin noise and taps included) made once; each device
    # blurs them into its fields and runs the rest of the path
    draws = gpu.draw(lab.shape, torch.Generator(device='cuda').manual_seed(5))
    with torch.no_grad():
        og = gpu.apply(lab.cuda(), gpu.perlin(draws))
        oc = cpu.apply(lab, cpu.perlin(to_device(draws, 'cpu')))
    torch.cuda.synchronize()
    og = {k: v.cpu() for k, v in og.items()}
    rel = {k: max_abs_err(og[k], oc[k]) / float(oc[k].abs().max())
           for k in ('vel', 'bias')}
    e_def = max_abs_err(og['def'], oc['def'])
    bad = og['map'].argmax(-1) != oc['map'].argmax(-1)
    mism = float(bad.float().mean())
    # a label flipped by a nearest tie changes its voxel's intensity, and
    # the image blur (7 taps, radius 3) its neighbours': compared elsewhere
    near = torch.nn.functional.max_pool3d(bad[:, None].float(), 7, stride=1,
                                          padding=3)[:, 0] > 0
    kept = float((~near).float().mean())
    e_img = max_abs_err(og['image'][~near], oc['image'][~near])
    ok = (max(rel.values()) <= 1e-5 and e_def <= 1e-4 and mism <= 1e-3
          and kept >= .5 and e_img <= 1e-4)
    checks.check('synthesis kernels vs plain CPU', ok,
                 f'vel {rel["vel"]:.3g} and bias {rel["bias"]:.3g} max abs '
                 f'err over max (1e-5); def max abs err {e_def:.3g} (1e-4); '
                 f'map mismatch share {mism:.3g} (1e-3, nearest ties); image '
                 f'max abs err {e_img:.3g} (1e-4) on the {kept:.4f} of voxels '
                 f'farther than 3 from a mismatch')


def phase_synth_train(checks, res):
    print(f'== 9. config #5: synthesis -> bf16 UNet step, {TRAIN_STEPS} '
          f'steps at {VOL}^3', flush=True)
    lab = torch.from_numpy(np.random.default_rng(0).integers(
        0, SYNTH_LABELS, size=(1, VOL, VOL, VOL, 1))).cuda()
    gen_model = synth_model(VOL, 'cuda')
    model = nt.models.unet(
        nb_features=16, input_shape=(VOL, VOL, VOL, 1), nb_levels=4,
        conv_size=3, nb_labels=SYNTH_LABELS, feat_mult=2, nb_conv_per_level=2,
        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
        device='cuda')
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    gen = torch.Generator(device='cuda').manual_seed(1)

    def one_step(i, events=None):
        if events:
            events[0].record()
        with torch.no_grad():
            out = gen_model(lab, training.step_generator(0, i, 'cuda'))
        if events:
            events[1].record()
        return out, step(state, (out['image'], out['map']), gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, times, synth_ms, outs = [], [], [], []
    for i in range(TRAIN_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        out, (state, m) = one_step(i, ev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        synth_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(m['loss'])
        if i == TRAIN_STEPS - 1:
            outs = out
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    checks.check('config #5 losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    mp, img = outs['map'], outs['image']
    onehot = (tuple(mp.shape) == (1, VOL, VOL, VOL, SYNTH_LABELS)
              and bool(((mp == 0) | (mp == 1)).all())
              and bool((mp.sum(-1) == 1).all()))
    checks.check('config #5 map one-hot', onehot, f'shape {tuple(mp.shape)}')
    img_ok = (tuple(img.shape) == (1, VOL, VOL, VOL, 1)
              and bool(torch.isfinite(img).all())
              and float(img.min()) >= 0 and float(img.max()) <= 1)
    checks.check('config #5 image finite in [0, 1]', img_ok,
                 f'shape {tuple(img.shape)}')
    per_step = {'interpn': 6, 'blur': 12, 'blur_whole': 12, 'pool2_fwd': 3,
                'pool2_bwd': 3, 'dice_sums': 1}
    for name, n in per_step.items():
        got, want = counts.get(name, 0), n * TRAIN_STEPS
        checks.check(f'config #5 launches {name}', got == want and got > 0,
                     f'{got} (expected {n} per step)')
        if name in ('interpn', 'blur'):
            res[name]['launches'] = got
    check_vec_bodies(checks, 'config #5', counts)
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    s_ms = statistics.median(synth_ms[WARMUP_STEPS:])
    print(f'  synthesis ms (CUDA events, median of steps {WARMUP_STEPS + 1}-'
          f'{TRAIN_STEPS}): {s_ms:.3f}; all: '
          + ' '.join(f'{t:.2f}' for t in synth_ms))
    print(f'  step ms (synthesis + train step, median of steps '
          f'{WARMUP_STEPS + 1}-{TRAIN_STEPS}): {step_ms:.3f}; all: '
          + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  vol/s {1e3 / step_ms:.3f}; peak memory {peak} B '
          f'({peak / 2 ** 30:.3f} GiB)', flush=True)

    # the synthesis waits for the host nowhere: CUDA's sync debug mode
    # raises on any call that synchronises the host with the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with torch.no_grad():
            gen_model(lab, training.step_generator(0, TRAIN_STEPS, 'cuda'))
        synced = ''
    except RuntimeError as e:
        synced = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    checks.check('config #5 synthesis without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")

    # where the time goes: profiles of the synthesis alone and of whole
    # steps (readings, not checks)
    def synth_only(i):
        with torch.no_grad():
            gen_model(lab, training.step_generator(0, i, 'cuda'))

    for label, fn in (('synthesis', synth_only), ('synthesis + step',
                                                  one_step)):
        try:
            report_profile(label, fn, TRAIN_STEPS)
        except Exception as e:  # noqa: BLE001
            print(f'  {label} profile not measured: {type(e).__name__}: {e}')


def lc_inputs(gen, batch, vol, chans, filters, dtype):
    """Normal draws on the card: x [B, vol^3, C] and transposed weights
    [O, 27*C, vol^3] in `dtype`, and a float32 cotangent g [B, vol^3, O]."""
    sp = (vol,) * 3
    x = torch.randn((batch, *sp, chans), generator=gen, device='cuda')
    k = torch.randn((filters, 27 * chans, vol ** 3), generator=gen,
                    device='cuda')
    g = torch.randn((batch, *sp, filters), generator=gen, device='cuda')
    return x.to(dtype), k.to(dtype), g


def lc_calls(x, k, g, keras):
    """(name, kernel call, plain call) of K7, K8 and K9 on x, the weights k
    ([V, TC, O] if keras, else [O, TC, V]) and g. With keras, K9 rounds
    each product to the weights' dtype (the v1 semantics)."""
    kv, shape = lc_cuda._weight_view(k, keras), tuple(x.shape)
    return [
        ('lc_fwd', lambda: lc_cuda.fwd_cuda(x, kv, LC_KS, 'same'),
         lambda: lc_cuda.fwd_plain(x, kv, LC_KS, 'same')),
        ('lc_dk', lambda: lc_cuda.dk_cuda(g, x, LC_KS, 'same', k.dtype, keras),
         lambda: lc_cuda.dk_plain(g, x, LC_KS, 'same', k.dtype, keras)),
        ('lc_dx', lambda: lc_cuda.dx_cuda(g, kv, LC_KS, 'same', shape,
                                          x.dtype, keras),
         lambda: lc_cuda.dx_plain(g, kv, LC_KS, 'same', shape, x.dtype,
                                  keras)),
    ]


def lc_live_weights(spatial, filters, chans):
    """Weights of a 'same' 3x3x3 LC conv that multiply an input inside the
    volume: along an axis of length s the taps reach 3s - 2 inputs. The
    others multiply the zero padding, so the forward and dx need neither
    their bytes nor their work (dk still writes them)."""
    return math.prod(3 * s - 2 for s in spatial) * filters * chans


def lc_bound(name, x, k, g):
    """Bytes and float32 operations K7, K8 or K9 needs at these inputs."""
    batch, chans, filters = x.shape[0], x.shape[-1], k.shape[0]
    live = lc_live_weights(x.shape[1:4], filters, chans)
    xb, gb, ksz = x.numel() * x.element_size(), g.numel() * 4, k.element_size()
    if name == 'lc_fwd':   # read live weights and x, write y (f32)
        return live * ksz + xb + gb, 2 * live * batch
    if name == 'lc_dk':    # read g and x, write every weight
        return k.numel() * ksz + gb + xb, live * (2 * batch - 1)
    return live * ksz + gb + xb, 2 * live * batch   # dx: read weights, g


def body_run(name, kern):
    """(result, body that ran: 'row' or 'voxel') of kern(), one launch of
    kernel `name` ('lc_fwd', 'lc_dk' or 'lc_dx'), read from the launch
    counts."""
    before = _build.launches[name + '_row']
    out = kern()
    return out, 'row' if _build.launches[name + '_row'] > before else 'voxel'


def phase_lc(checks, res):
    print('== 10. LC K7/K8/K9 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(10)
    # the head's shapes: bf16 (the step's types), then float32; equal, each
    # through its row body
    for dtype in (torch.bfloat16, torch.float32):
        x, k, g = lc_inputs(gen, 1, LC_VOL, 4, 1, dtype)
        if dtype == torch.bfloat16:
            # the card's read rate for the weights' bytes: a bandwidth probe
            # beside K7 and K9, not a library call (none is an LC conv)
            read_ms = time_ms(lambda: k.sum(dtype=torch.float32))
            kb = k.numel() * k.element_size()
            print(f'  read ceiling probe (bandwidth, not library_ms): '
                  f'w.sum(dtype=float32) at {list(k.shape)} bf16: '
                  f'{read_ms:.4f} ms = {kb / read_ms / 1e9:.3f} TB/s',
                  flush=True)
        for name, kern, plain in lc_calls(x, k, g, False):
            (a, body), b = body_run(name, kern), plain()
            torch.cuda.synchronize()
            err = max_abs_err(a, b)
            tag = f'{str(dtype)[6:]} x {list(x.shape)} w {list(k.shape)}'
            checks.check(f'{name} {tag}', bit_equal(a, b) and body == 'row',
                         f'equal {bool(torch.equal(a, b))}, max abs err '
                         f'{err:.3g}, body {body} (row expected)')
            r = res[name]
            r['max_abs_err'] = max(r['max_abs_err'], err)
            del a, b
            if dtype != torch.bfloat16:
                continue
            r['ms'], r['plain_ms'] = time_ms(kern), time_ms(plain)
            r['library_ms'] = None   # no single PyTorch call is an LC conv
            nbytes, flops = lc_bound(name, x, k, g)
            add_bound(r, nbytes, flops)
            c_ms = call_ms(kern)
            print(f'  {name} {tag}: kernel {r["ms"]:.4f} ms, plain '
                  f'{r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
                  f'({r["bound_by"]}; {nbytes} B, {flops} flop); one kernel '
                  f'call {c_ms:.4f} ms', flush=True)
            if name in ('lc_fwd', 'lc_dx'):
                live = lc_live_weights(x.shape[1:4], 1, 4) * k.element_size()
                print(f'  {name} reads the live weights at '
                      f'{live / r["ms"] / 1e9:.3f} TB/s; read probe '
                      f'{read_ms:.4f} ms', flush=True)
            if name == 'lc_fwd':
                # a second reading in the same process: the spread of
                # K7's time on one card
                print(f'  lc_fwd second reading: {time_ms(kern):.4f} ms',
                      flush=True)
            if name == 'lc_dk':
                # the card's write rate for dk's bytes: a bandwidth probe,
                # not a library call (no PyTorch call is an LC dk)
                p_ms = time_ms(lambda: torch.empty_like(k).zero_())
                nb = k.numel() * k.element_size()
                print(f'  write ceiling probe (bandwidth, not library_ms): '
                      f'torch.empty_like(dk).zero_() at {list(k.shape)} '
                      f'{str(k.dtype)[6:]}: {p_ms:.4f} ms = '
                      f'{nb / p_ms / 1e9:.3f} TB/s; K8 at '
                      f'{nb / r["ms"] / 1e9:.3f} TB/s of dk', flush=True)
        del x, k, g
    # 2 filters, batch 3, both weight layouts: the strides, the filter loop
    # and the batch fold (each by its one-voxel body); equal
    for dtype in (torch.bfloat16, torch.float32):
        x, k, g = lc_inputs(gen, 3, 32, 4, 2, dtype)
        for keras in (False, True):
            kk = k.permute(2, 1, 0).contiguous() if keras else k
            for name, kern, plain in lc_calls(x, kk, g, keras):
                (a, body), b = body_run(name, kern), plain()
                torch.cuda.synchronize()
                err = max_abs_err(a, b)
                checks.check(
                    f'{name} {str(dtype)[6:]} 32^3 O=2 B=3 '
                    f'{"keras" if keras else "transposed"}',
                    bit_equal(a, b) and body == 'voxel',
                    f'equal {bool(torch.equal(a, b))}, max abs err '
                    f'{err:.3g}, body {body} (voxel expected)')
                res[name]['max_abs_err'] = max(res[name]['max_abs_err'], err)
    # off the head's shape, batch 1: W = 19 (a thread's voxels would cross
    # rows: the one-voxel bodies); W = 24, V = 16*17*24 = 6528 (the row
    # bodies, V a multiple of 8 voxels but not of 8 x 256: a ragged last
    # block, and warps that span two rows); 'valid' at [16, 17, 18], out
    # [14, 15, 16] (K7's and K8's row bodies without padding; K9's row body
    # takes 'same' only); 32^3 with 2 filters (the row bodies' filter
    # loops); equal
    for sp, padding, O, want in (((15, 17, 19), 'same', 1, 'voxel'),
                                 ((16, 17, 24), 'same', 1, 'row'),
                                 ((16, 17, 18), 'valid', 1, 'row'),
                                 ((32, 32, 32), 'same', 2, 'row')):
        out = [s - 2 for s in sp] if padding == 'valid' else list(sp)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, *sp, 4), generator=gen,
                            device='cuda').to(dtype)
            k = torch.randn((O, 108, math.prod(out)), generator=gen,
                            device='cuda').to(dtype)
            g = torch.randn((1, *out, O), generator=gen, device='cuda')
            shape = tuple(x.shape)
            for name, kern, plain in (
                    ('lc_fwd', lambda: lc_cuda.fwd_cuda(x, k, LC_KS, padding),
                     lambda: lc_cuda.fwd_plain(x, k, LC_KS, padding)),
                    ('lc_dk', lambda: lc_cuda.dk_cuda(g, x, LC_KS, padding,
                                                      dtype),
                     lambda: lc_cuda.dk_plain(g, x, LC_KS, padding, dtype)),
                    ('lc_dx', lambda: lc_cuda.dx_cuda(g, k, LC_KS, padding,
                                                      shape, dtype),
                     lambda: lc_cuda.dx_plain(g, k, LC_KS, padding, shape,
                                              dtype))):
                expect = 'voxel' if name == 'lc_dx' and padding == 'valid' \
                    else want
                (a, body), b = body_run(name, kern), plain()
                torch.cuda.synchronize()
                checks.check(f'{name} {str(dtype)[6:]} x {list(x.shape)} '
                             f'O={O} {padding}',
                             bit_equal(a, b) and body == expect,
                             f'equal {bool(torch.equal(a, b))}, max abs err '
                             f'{max_abs_err(a, b):.3g}, body {body} '
                             f'({expect} expected)')

    # the keras-layout v1 entry point through autograd, at the head's shape
    sp, V = (LC_VOL,) * 3, LC_VOL ** 3
    xf = torch.randn((V, 4), generator=gen, device='cuda').bfloat16()
    k2 = torch.randn((V, 108), generator=gen, device='cuda').bfloat16()
    gf = torch.randn((V, 1), generator=gen, device='cuda')
    xr, kr = xf.clone().requires_grad_(), k2.clone().requires_grad_()
    rows = sum(_build.launches[n + '_row'] for n in ('lc_fwd', 'lc_dk',
                                                      'lc_dx'))
    y = lc_cuda.lc3d_pallas(xr, kr, sp, LC_KS)
    dx, dk = torch.autograd.grad(y, (xr, kr), gf)
    rows = sum(_build.launches[n + '_row'] for n in ('lc_fwd', 'lc_dk',
                                                      'lc_dx')) - rows
    checks.check('lc3d_pallas (keras, v1) bodies', rows == 0,
                 f'{rows} row-body launches (0 expected: the keras strides '
                 f'take the one-voxel bodies)')
    x5, g5 = xf.reshape(1, *sp, 4), gf.reshape(1, *sp, 1)
    kv = lc_cuda._weight_view(k2, True)
    want = (lc_cuda.fwd_plain(x5, kv, LC_KS, 'same').reshape(V, 1),
            lc_cuda.dx_plain(g5, kv, LC_KS, 'same', tuple(x5.shape),
                             torch.bfloat16, True).reshape(V, 4),
            lc_cuda.dk_plain(g5, x5, LC_KS, 'same', torch.bfloat16,
                             True).reshape(V, 108))
    torch.cuda.synchronize()
    for what, a, b, name in zip(('y', 'dx', 'dk'), (y.detach(), dx, dk), want,
                                ('lc_fwd', 'lc_dx', 'lc_dk')):
        err = max_abs_err(a, b)
        checks.check(f'lc3d_pallas (keras, v1) bf16 [{V}, 4] {what}',
                     bit_equal(a, b), f'max abs err {err:.3g}')
        res[name]['max_abs_err'] = max(res[name]['max_abs_err'], err)
    # the keras-layout kernels' times at the head (Pallas rows 9-11; no
    # layer routes the step to them)
    times = [f'{name} {time_ms(kern):.4f} ms'
             for name, kern, _ in lc_calls(x5, k2, g5, True)]
    print(f'  keras-layout kernels (one-voxel bodies) at [{V}, 4] bf16: '
          + ', '.join(times), flush=True)


class EncDecLC(torch.nn.Module):
    """Config #3 (`bench.py:335-372`): the UNet trunk feeding a
    LocallyConnected3D head. Attribute names follow the flax tree
    (`ne.models.unet` drops its name, so flax calls the trunk UNet_0).
    impl='plain' takes the plain pool and LC forms on the card."""

    def __init__(self, size, dtype, impl='auto'):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        sp = (size,) * 3
        self.UNet_0 = nt.models.unet(
            nb_features=8, input_shape=(*sp, 1), nb_levels=3, conv_size=3,
            nb_labels=4, feat_mult=2, final_pred_activation='linear',
            dtype=dtype, conv_impl='auto',
            pool_impl='plain' if impl == 'plain' else 'kernel',
            generator=gen, device='cuda')
        self.lc = nt.layers.LocallyConnected3D(
            filters=1, kernel_size=3, padding='same', input_shape=(*sp, 4),
            param_dtype=dtype or torch.float32, impl=impl, generator=gen,
            device='cuda')

    def forward(self, x, training=None, generator=None):
        return self.lc(self.UNet_0(x, training=training, generator=generator))


def config3_inputs(size):
    """bench.py's config #3 batch: x and y normal draws of one rng."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, size, size, size, 1)).astype(np.float32)
    y = rng.normal(size=(1, size, size, size, 1)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def mse(y_true, y_pred):
    return torch.mean((y_true - y_pred.float()) ** 2)


def phase_lc_check(checks):
    print(f'== 11. config #3 f32 step at {LC_CHECK_VOL}^3: kernels vs plain',
          flush=True)
    x, y = config3_inputs(LC_CHECK_VOL)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for impl in ('auto', 'plain'):
            model = EncDecLC(LC_CHECK_VOL, None, impl)
            state = training.create_train_state(model, training.adam(1e-4))
            _build.launches.clear()
            state, m = training.make_train_step(mse)(state, (x, y))
            runs[impl] = (float(m['loss']), dict(_build.launches),
                          {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()})
            del model, state
        (lk, nk, gk), (lp, np_, gp) = runs['auto'], runs['plain']
        checks.check('config #3 f32 launches', all(
            nk.get(n, 0) == c for n, c in (('lc_fwd', 1), ('lc_fwd_row', 1),
                                           ('lc_dk', 1), ('lc_dk_row', 1),
                                           ('lc_dx', 1), ('lc_dx_row', 1),
                                           ('pool2_fwd', 2),
                                           ('pool2_bwd', 2)))
            and not np_, f'kernels {nk}, plain {np_}')
        checks.check('config #3 f32 loss', abs(lk - lp) <= 1e-5 * abs(lp),
                     f'kernels {lk!r} plain {lp!r} (rtol 1e-5)')
        worst = max(float((gk[n] - gp[n]).abs().max() / gp[n].abs().max())
                    for n in gp)
        checks.check('config #3 f32 grads', worst <= 1e-4,
                     f'{len(gp)} tensors, worst max|diff|/max|g| {worst:.3g} '
                     f'(limit 1e-4); all equal '
                     f'{all(torch.equal(gk[n], gp[n]) for n in gp)}')
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def phase_lc_train(checks, res):
    print(f'== 12. config #3: UNet -> LocallyConnected3D head, bf16, '
          f'{TRAIN_STEPS} steps at {LC_VOL}^3', flush=True)
    t0 = time.perf_counter()
    model = EncDecLC(LC_VOL, torch.bfloat16)
    init_s = time.perf_counter() - t0
    n_par = sum(p.numel() for p in model.parameters())
    print(f'  model built in {init_s:.3f} s (weights drawn on the CPU, then '
          f'moved): {n_par} parameters, head kernel '
          f'{list(model.lc.kernel.shape)} {model.lc.kernel.dtype}')
    x, y = config3_inputs(LC_VOL)
    state = training.create_train_state(model, training.adam(1e-4))
    step = training.make_train_step(mse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, (x, y))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m['loss'])
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    checks.check('config #3 losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    moments = state.optimizer.state[model.lc.kernel]['exp_avg'].dtype
    checks.check('config #3 head moments in the parameter dtype',
                 moments == torch.bfloat16, str(moments))
    per_step = {'pool2_fwd': 2, 'pool2_bwd': 2, 'lc_fwd': 1, 'lc_fwd_row': 1,
                'lc_dk': 1, 'lc_dk_row': 1, 'lc_dx': 1, 'lc_dx_row': 1}
    for name, n in per_step.items():
        got, want = counts.get(name, 0), n * TRAIN_STEPS
        checks.check(f'config #3 launches {name}', got == want and got > 0,
                     f'{got} (expected {n} per step)')
        if name in ('lc_fwd', 'lc_dk', 'lc_dx'):
            res[name]['launches'] = got
    check_vec_bodies(checks, 'config #3', counts)
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  step ms (median of steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}): '
          f'{step_ms:.3f}; all: ' + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  vol/s {1e3 / step_ms:.3f}; peak memory {peak} B '
          f'({peak / 2 ** 30:.3f} GiB)', flush=True)
    try:
        report_profile('config #3 step', lambda i: step(state, (x, y)),
                       TRAIN_STEPS)
    except Exception as e:  # noqa: BLE001  (a reading, not a check)
        print(f'  config #3 profile not measured: {type(e).__name__}: {e}')


def make_pair(size, seed=0):
    """The registration pair: a 3-D version of
    `examples/deformable_registration.py:25-37` (blobs at 0.45 and 0.55 of
    the size, widths size*0.8 and size*1.2, 0.02 normal noise), values near
    [0, 1] as the default MI alpha assumes; [1, size^3, 1] float32 numpy."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing='ij'), -1)
    moving = np.exp(-((grid - size * 0.45) ** 2).sum(-1) / (size * 0.8))
    fixed = np.exp(-((grid - size * 0.55) ** 2).sum(-1) / (size * 1.2))
    moving = moving + 0.02 * rng.normal(size=moving.shape)
    fixed = fixed + 0.02 * rng.normal(size=fixed.shape)
    return (moving.astype(np.float32)[None, ..., None],
            fixed.astype(np.float32)[None, ..., None])


def registration_loss(mi, moving, fixed, field, fused=True, impl='auto'):
    """`benchmarks/mi_context.py:42-50`: warp `moving` by the field clamped
    to +-3 voxels, minus the mean MI against `fixed` (`volumes_fused`, or
    the materialized `volumes` twin)."""
    warped = spatial.batch_transform(moving, torch.clamp(field, -3., 3.),
                                     impl='window', max_disp=3.0)
    if fused:
        return -mi.volumes_fused(warped, fixed, impl=impl).mean()
    return -mi.volumes(warped, fixed).mean()


def mi_flops(n_vox, nb_bins):
    """Float32 operations of the fused MI histograms: per voxel 2 B^2 for
    the joint histogram, 2 B for the marginals and, per map and bin, a
    subtract, a square, a scale and an exp."""
    return n_vox * (2 * nb_bins ** 2 + 2 * nb_bins + 2 * 4 * nb_bins)


def phase_mi(checks, res):
    print('== 13. MI histograms K10 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(13)
    r = res['mi_hist']
    alpha = nt.metrics.MutualInformation(nb_bins=MI_BINS).soft_bin_alpha
    alpha8 = nt.metrics.MutualInformation(nb_bins=8).soft_bin_alpha
    moving, fixed = (torch.from_numpy(a).cuda().reshape(1, -1)
                     for a in make_pair(VOL))
    n = VOL ** 3

    def rand(shape, lo=0., hi=1.):
        return core.uniform(gen, shape, lo, hi, 'cuda')

    def centers(v, nb=MI_BINS):
        return core.linspace(v.min(), v.max(), nb)

    unit = torch.linspace(0., 1., MI_BINS, device='cuda')
    nan_x = moving.clone()
    nan_x[0, 12345] = float('nan')
    x2, y2 = rand((2, 1000)), rand((2, 1000))
    xr, yr = rand((1, n + 37)), rand((1, n + 37))
    xc, yc = rand((1, n), -1., 2.), rand((1, n), -1., 2.)
    cases = [  # (name, x, y, cx, cy, alpha, min_clip, max_clip)
        (f'path [1, {VOL}^3] B=16, centers from the data', moving, fixed,
         centers(moving), centers(fixed), alpha, -np.inf, np.inf),
        ('[2, 1000] B=16', x2, y2, unit, unit, alpha, -np.inf, np.inf),
        (f'[1, {VOL}^3+37] B=16', xr, yr, unit, unit, alpha, -np.inf, np.inf),
        (f'[1, {VOL}^3] B=8, clip [0, 1], inputs in [-1, 2]', xc, yc,
         torch.linspace(0., 1., 8, device='cuda'),
         torch.linspace(0., 1., 8, device='cuda'), alpha8, 0., 1.),
        (f'path [1, {VOL}^3] B=16, one NaN voxel', nan_x, fixed,
         unit, unit, alpha, -np.inf, np.inf),
    ]
    # past one 64-bin chunk: 2 x 2 pairs of chunks, 65 (a chunk of one bin)
    # and 128; 16 x 16 at 1024 bins on [1, 32^3], with 15 blocks a row (the
    # scratch bound of mi_hist_cuda._launch_blocks)
    x64, y64 = rand((1, 64 ** 3)), rand((1, 64 ** 3))
    x32, y32 = rand((1, 32 ** 3)), rand((1, 32 ** 3))
    for nb, xs, ys, tag in ((5, x64, y64, '64^3'), (17, x64, y64, '64^3'),
                            (65, x64, y64, '64^3'), (128, x64, y64, '64^3'),
                            (1024, x32, y32, '32^3')):
        c = torch.linspace(0., 1., nb, device='cuda')
        cases.append((f'[1, {tag}] B={nb}', xs, ys, c, c,
                      nt.metrics.MutualInformation(nb_bins=nb).soft_bin_alpha,
                      -np.inf, np.inf))
    for i, (name, x, y, cx, cy, a, lo, hi) in enumerate(cases):
        before = _build.launches['mi_hist_tiled']
        k = mi_hist_cuda.mi_histograms_cuda(x, y, cx, cy, a, lo, hi)
        body = 'tiled' if _build.launches['mi_hist_tiled'] > before else '-'
        k2 = mi_hist_cuda.mi_histograms_cuda(x, y, cx, cy, a, lo, hi)
        p = mi_hist._mi_histograms_plain(x, y, cx, cy, a, lo, hi)
        torch.cuda.synchronize()
        rel = max(rel_err(u, w) for u, w in zip(k, p))
        nan_ok = all(torch.equal(torch.isnan(u), torch.isnan(w))
                     for u, w in zip(k, p))
        same = all(bit_equal(u, u2) for u, u2 in zip(k, k2))
        n_nan = sum(int(torch.isnan(u).sum()) for u in k)
        checks.check(f'mi_hist {name}',
                     rel <= 1e-5 and nan_ok and same and body == 'tiled',
                     f'max abs err / max |plain| {rel:.3g} (1e-5), NaN where '
                     f'plain has it {nan_ok} ({n_nan} NaN), two calls '
                     f'bit-equal {same}, body {body} '
                     f'({mi_hist_cuda.plan(cx.numel())})')
        if i == 0:
            r['max_abs_err'] = max(max_abs_err(u, w) for u, w in zip(k, p))

    # alpha as a CUDA 0-d tensor: read by the kernel, no host sync, the
    # float call's bits (the wrapper, and the entry point's K10 route)
    at = torch.tensor(alpha, dtype=torch.float32, device='cuda')
    want = mi_hist_cuda.mi_histograms_cuda(moving, fixed, unit, unit, alpha)
    torch.cuda.synchronize()
    err = ''
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = (mi_hist_cuda.mi_histograms_cuda(moving, fixed, unit, unit, at),
               nt.ops.mi_histograms(moving, fixed, unit, at, impl='pallas'))
    except RuntimeError as e:
        got, err = (), f'; {e}'
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = bool(got) and all(bit_equal(u, w) for out in got
                             for u, w in zip(out, want))
    checks.check('mi_hist alpha as a CUDA 0-d tensor', same,
                 f'no host sync {not err}, bit-equal to the float alpha '
                 f'{same}{err}')

    # MIHistograms' dx and dy on the K10 route against the plain forward
    x, y, cx, cy = moving, fixed, centers(moving), centers(fixed)
    w = [torch.randn(s, generator=gen, device='cuda')
         for s in ((1, MI_BINS, MI_BINS), (1, MI_BINS), (1, MI_BINS))]
    grads = []
    for impl in ('pallas', 'plain'):
        xi, yi = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = nt.ops.mi_histograms(xi, yi, cx, alpha, impl=impl,
                                   bin_centers_y=cy)
        grads.append(torch.autograd.grad(
            sum((wi * o).sum() for wi, o in zip(w, out)), (xi, yi)))
    torch.cuda.synchronize()
    rel = max(rel_err(a, b) for a, b in zip(*grads))
    checks.check('mi_hist backward (dx, dy) K10 route vs plain', rel <= 1e-5,
                 f'max abs err / max |g| {rel:.3g} (1e-5)')

    # times at the path's shape, and by K10's two launches
    parts = time_by_name(lambda: mi_hist_cuda.mi_histograms_cuda(
        x, y, cx, cy, alpha))
    k_ms = sum(parts.values())
    clk = clocks_under(lambda: mi_hist_cuda.mi_histograms_cuda(
        x, y, cx, cy, alpha))
    print(f'  SM clock and power under K10 back to back (nvidia-smi, '
          f'median): {clk} (MHz, W)', flush=True)
    print('  mi_hist launches: ' + '; '.join(
        f'{name.split("::")[-1].split("(")[0]} {ms:.4f} ms'
        for name, ms in parts.items()),
        flush=True)
    p_ms = time_ms(lambda: mi_hist._mi_histograms_plain(x, y, cx, cy, alpha))

    def materialized():   # MutualInformation.maps' route: two maps, a bmm
        xq = core.soft_quantize(x, cx, None, alpha)
        yq = core.soft_quantize(y, cy, None, alpha)
        return torch.bmm(xq.transpose(1, 2), yq)
    m_ms = time_ms(materialized)
    c_ms = call_ms(lambda: mi_hist_cuda.mi_histograms_cuda(
        x, y, cx, cy, alpha))
    nbytes = (2 * n + 2 * MI_BINS + MI_BINS ** 2 + 2 * MI_BINS) * 4
    flops = mi_flops(n, MI_BINS)
    r.update(ms=k_ms, plain_ms=p_ms, library_ms=None)
    add_bound(r, nbytes, flops)
    print(f'  mi_hist [1, {VOL}^3] B={MI_BINS}: kernel {k_ms:.4f} ms, plain '
          f'{p_ms:.4f} ms, bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}; '
          f'{nbytes} B, {flops} flop); one kernel call {c_ms:.4f} ms',
          flush=True)
    print(f'  materialized route (two soft_quantize maps [1, {VOL}^3, '
          f'{MI_BINS}] and one bmm, no marginals): {m_ms:.4f} ms',
          flush=True)


def phase_reg_check(checks):
    print(f'== 14. MI registration step at {REG_CHECK_VOL}^3: kernels vs '
          f'the plain CPU path', flush=True)
    moving, fixed = make_pair(REG_CHECK_VOL)
    field0 = np.random.default_rng(1).uniform(
        -2., 2., size=(1, *(REG_CHECK_VOL,) * 3, 3)).astype(np.float32)
    mi = nt.metrics.MutualInformation(nb_bins=MI_BINS,
                                      check_input_limits=False)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ('cuda', 'cpu'):
            m, f = torch.from_numpy(moving).to(dev), torch.from_numpy(
                fixed).to(dev)
            field = torch.from_numpy(field0).to(dev).requires_grad_()
            _build.launches.clear()
            # the kernel route on both devices: K10 on the card, the plain
            # forward on the CPU, one backward ('auto' would take the jnp
            # route on the CPU, whose centers' gradient differs)
            loss = registration_loss(mi, m, f, field, impl='pallas')
            loss.backward()
            runs[dev] = (float(loss.detach()), field.grad.cpu(),
                         dict(_build.launches))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    (lk, gk, nk), (lp, gp, np_) = runs['cuda'], runs['cpu']
    checks.check('MI registration launches', nk.get('mi_hist') == 1
                 and nk.get('mi_hist_tiled') == 1
                 and nk.get('interpn') == 1 and not np_,
                 f'card {nk}, CPU {np_}')
    checks.check('MI registration loss card vs CPU',
                 abs(lk - lp) <= 1e-5 * abs(lp),
                 f'card {lk!r} CPU {lp!r} (rtol 1e-5)')
    rel = rel_err(gk, gp)
    checks.check('MI registration field gradient card vs CPU', rel <= 1e-4,
                 f'max abs err / max |g| {rel:.3g} (1e-4)')


def phase_reg_train(checks, res):
    print(f'== 15. MI registration at {VOL}^3: {TRAIN_STEPS} Adam steps of '
          f'the field', flush=True)
    moving, fixed = (torch.from_numpy(a).cuda() for a in make_pair(VOL))
    mi = nt.metrics.MutualInformation(nb_bins=MI_BINS,
                                      check_input_limits=False)

    def make_step(fused):
        field = torch.zeros((1, VOL, VOL, VOL, 3), device='cuda',
                            requires_grad=True)
        opt = torch.optim.Adam([field], lr=REG_LR)

        def step(i=None):
            opt.zero_grad(set_to_none=True)
            loss = registration_loss(mi, moving, fixed, field, fused)
            loss.backward()
            opt.step()
            return loss.detach()
        return step

    def run(step):
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return [float(v) for v in losses], times

    step = make_step(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, times = run(step)
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    checks.check('MI registration losses finite and falling',
                 all(np.isfinite(losses)) and losses[-1] < losses[0],
                 ' '.join(f'{v:.6f}' for v in losses))
    for name in ('mi_hist', 'mi_hist_tiled', 'interpn'):
        got = counts.get(name, 0)
        checks.check(f'MI registration launches {name}',
                     got == TRAIN_STEPS, f'{got} (expected 1 per step)')
    res['mi_hist']['launches'] = counts.get('mi_hist', 0)
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  step ms (median of steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}): '
          f'{step_ms:.3f}; all: ' + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  pairs/s {1e3 / step_ms:.3f}; peak memory {peak} B '
          f'({peak / 2 ** 30:.3f} GiB)', flush=True)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        step()
        synced = ''
    except RuntimeError as e:
        synced = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    checks.check('MI registration step without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")

    # where the time goes (readings, not checks): a profile of whole steps,
    # then the device ms of the step's parts: the warp forward and its
    # plain autograd backward, the MI loss forward and backward on a fixed
    # warped volume, Adam on the field
    field = torch.zeros((1, VOL, VOL, VOL, 3), device='cuda',
                        requires_grad=True)
    field.grad = torch.zeros_like(field)
    g = torch.randn((1, VOL, VOL, VOL, 1), device='cuda') * 1e-3
    warped = spatial.batch_transform(moving, field).detach()
    opt = torch.optim.Adam([field], lr=REG_LR)

    def mi_part():
        w = warped.clone().requires_grad_()
        return torch.autograd.grad(-mi.volumes_fused(w, fixed).mean(), w)
    parts = {
        'warp fwd+bwd': lambda: torch.autograd.grad(
            spatial.batch_transform(moving, torch.clamp(field, -3., 3.)),
            field, g),
        'MI loss fwd+bwd': mi_part,
        'Adam': opt.step,
    }
    try:
        report_profile('MI registration step', step, TRAIN_STEPS)
        print('  step parts, device ms: ' + '; '.join(
            f'{k} {time_ms(fn):.4f}' for k, fn in parts.items()), flush=True)
    except Exception as e:  # noqa: BLE001
        print(f'  registration profile not measured: {type(e).__name__}: '
              f'{e}')

    # the twin: the same steps with the materialized maps (MI.volumes)
    twin_losses, twin_times = run(make_step(False))
    twin_ms = 1e3 * statistics.median(twin_times[WARMUP_STEPS:])
    print(f'  twin through MI.volumes: step ms (median of steps '
          f'{WARMUP_STEPS + 1}-{TRAIN_STEPS}) {twin_ms:.3f}; all: '
          + ' '.join(f'{1e3 * t:.2f}' for t in twin_times)
          + '; losses ' + ' '.join(f'{v:.6f}' for v in twin_losses),
          flush=True)


def report_profile(label, fn, first):
    """Wall time, device busy time and idle share of PROFILE_STEPS calls
    fn(first), fn(first + 1), ..., and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            fn(first + i)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows = device_events(prof)
    busy = sum(ms for ms, _, _ in rows)
    n = sum(c for _, c, _ in rows)
    print(f'  profile, {label}, {PROFILE_STEPS} calls: wall {wall:.3f} ms, '
          f'device busy {busy:.3f} ms, {n // PROFILE_STEPS} device events '
          f'per call, idle share {1 - busy / wall:.4f}')
    for ms, c, key in sorted(rows, reverse=True)[:25]:
        print(f'    {ms / PROFILE_STEPS:9.4f} ms/call {c // PROFILE_STEPS:5d}'
              f'/call  {key[:90]}')


def parse_phases(argv):
    """The phases named by --phases (a comma list; all when it is absent).
    Phase 1 runs whatever is named: it finds the card."""
    ap = argparse.ArgumentParser(
        description='Smoke test of neurite_tpu_torch on one NVIDIA GPU.')
    ap.add_argument('--phases', default=','.join(PHASES),
                    help='comma list of phases to run, of '
                         + ','.join(PHASES) + ' (default: all)')
    names = [p.strip() for p in ap.parse_args(argv).phases.split(',')
             if p.strip()]
    bad = [p for p in names if p not in PHASES]
    if bad or not names:
        ap.error(f'unknown phases {bad}: choose from {",".join(PHASES)}')
    return set(names)


def main(argv=None):
    run = parse_phases(argv)
    card = phase_device()
    checks = Checks()
    res = {n: {'name': n, 'route': 'cuda', 'source': src, 'replaces': rep,
               'launches': 0, 'max_abs_err': 0., 'ms': 0., 'plain_ms': 0.,
               'bound_ms': 0., 'bound_by': None, 'library_ms': 0.}
           for n, (src, rep, _, _) in KERNELS.items()}
    build = f'{phase_build():.3f} s' if '2' in run else 'not run (phase 2)'
    phases = {
        '3': lambda: phase_pool(checks, res),
        '4': lambda: phase_dice(checks, res),
        '5': lambda: phase_parity(checks, *flagship_inputs()),
        '6': lambda: phase_train(checks, res, *flagship_inputs()),
        '7': lambda: phase_interpn(checks, res),
        '8': lambda: phase_blur(checks, res),
        '9a': lambda: phase_synth_check(checks),
        '9': lambda: phase_synth_train(checks, res),
        '10': lambda: phase_lc(checks, res),
        '11': lambda: phase_lc_check(checks),
        '12': lambda: phase_lc_train(checks, res),
        '13': lambda: phase_mi(checks, res),
        '14': lambda: phase_reg_check(checks),
        '15': lambda: phase_reg_train(checks, res),
    }
    for name, fn in phases.items():
        if name in run:
            fn()
    # a field that no phase of this run measured is null, not its start value
    for n, (_, _, measure, count) in KERNELS.items():
        if measure not in run:
            res[n].update(dict.fromkeys(MEASURED))
        if count not in run:
            res[n]['launches'] = None
    ran = ",".join(p for p in PHASES if p in run)
    print(f'phases run: {ran}'
          + ('' if len(run) == len(PHASES) else
             ' (a subset: the kernels line holds null for what they did not '
             'measure, and the run does not stand for the whole smoke test)'))
    print(f'card: {card}; kernel build {build}; each kernel\'s ms, '
          f'plain_ms, library_ms and bound_ms sum its calls of one step: the '
          f'three bf16 pool shapes, 5 linear 64^3 and 1 nearest 128^3 '
          f'interpolations, 2 blurs of [3, 64^3] (41 taps) and one each of '
          f'[1, 128^3] (165 and 7 taps; library: three conv3d calls but for '
          f'7 taps), one LC call each at the config #3 head (bf16), one MI '
          f'histogram call at [1, 128^3] with 16 bins; K1-K3 launches are '
          f'the flagship run\'s, K4 and K6 config #5\'s, K7-K9 config #3\'s, '
          f'K10 the MI registration run\'s')
    subset = {} if len(run) == len(PHASES) else {'phases': ran}
    print(json.dumps({'kernels': [{k: v for k, v in r.items()
                                   if not k.startswith('_')}
                                  for r in res.values()], **subset}))
    if checks.failed:
        print(f'FAILED: {checks.failed}', flush=True)
        sys.exit(1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}, **subset}))


if __name__ == '__main__':
    main()
