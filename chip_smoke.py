"""
Smoke test of the PyTorch/CUDA port (`neurite_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the flagship 3-D UNet training step
(nb_features=16, nb_levels=4, feat_mult=2, nb_conv_per_level=2, conv_size=3,
nb_labels=4, 128^3, batch 1, SoftDice, Adam 1e-3), through its public entry
points, and checks every hand-written kernel on that path against its plain
PyTorch version. Phases:

  1. device: the card, its power limit, the torch and CUDA versions;
  2. build: nvcc builds the kernels (`neurite_tpu_torch/ops/csrc`);
  3. pool: K1/K2 vs the plain pool at the step's three pool shapes, float32
     and bfloat16, on half-quantized inputs (ties) with a NaN window: forward
     and dx must be bit-equal (NaN positions equal, every other bit equal);
  4. Dice: K3 vs the plain sums at (1, 128^3, 4), rtol 1e-5 (another
     summation order);
  5. one float32 step through the kernels and one through the plain versions
     from the same weights (TF32 off, deterministic cuDNN): losses within
     rtol 1e-5, each gradient within 1e-4 of its largest magnitude (the Dice
     sums' order is the only difference);
  6. 10 bfloat16 training steps: finite losses, launch counts of K1, K2 and
     K3 exactly those of 10 steps, median step time, vol/s, peak memory.

Prints one line per check, then a JSON line of the kernels, and last
`{"ok": true, "device": {...}}`. Any failed check exits non-zero; so does a
machine without a CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import training
from neurite_tpu_torch.ops import _build, dice_red, pool, pool_cuda

VOL = 128
NB_LABELS = 4
POOL_SHAPES = [(1, 128, 128, 128, 16), (1, 64, 64, 64, 32), (1, 32, 32, 32, 64)]
TRAIN_STEPS = 10
WARMUP_STEPS = 3

KERNELS = {
    'pool2_fwd': ('neurite_tpu_torch/ops/csrc/pool.cu',
                  'neurite_tpu/ops/pool_pallas.py:182'),
    'pool2_bwd': ('neurite_tpu_torch/ops/csrc/pool.cu',
                  'neurite_tpu/ops/pool_pallas.py:199'),
    'dice_sums': ('neurite_tpu_torch/ops/csrc/dice_red.cu',
                  'neurite_tpu/ops/dice_red.py:60'),
}


class Checks:
    """Collects pass/fail per check so every phase reports before exit."""

    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail=''):
        print(f'  [{"ok" if ok else "FAIL"}] {name} {detail}', flush=True)
        if not ok:
            self.failed.append(name)


def time_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, by CUDA events around each call."""
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


def phase_pool(checks, res):
    print('== 3. pool K1/K2 vs plain', flush=True)
    w = (2, 2, 2)
    gen = torch.Generator(device='cuda').manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in POOL_SHAPES:
            # halves: many tied maxima; +0.0 turns -0.0 into +0.0 so that
            # "bit-equal" does not hinge on which signed zero a max returns
            x = torch.round(torch.randn(shape, generator=gen, device='cuda')
                            * 2) / 2 + 0.
            x[0, 2, 3, 4, 1] = float('nan')
            x = x.to(dtype).contiguous()
            out = (shape[0], shape[1] // 2, shape[2] // 2, shape[3] // 2,
                   shape[4])
            g = torch.randn(out, generator=gen, device='cuda').to(dtype)
            yk = pool_cuda.pool2_fwd(x)
            yp = pool._max_pool_tiled_fwd(x, w)
            dk = pool_cuda.pool2_bwd(x, g)
            dp = pool._max_pool_tiled_bwd(x, yp, g, w)
            torch.cuda.synchronize()
            tag = f'{str(dtype)[6:]} {shape}'
            nan_win = bool(torch.isnan(yk[0, 1, 1, 2, 1]))
            checks.check(f'pool fwd {tag}', bit_equal(yk, yp)
                         and nan_win, f'nan window kept: {nan_win}')
            n_g = int((dk[0, 2:4, 2:4, 4:6, 1] == g[0, 1, 1, 2, 1]).sum())
            checks.check(f'pool bwd {tag}', bit_equal(dk, dp)
                         and n_g == 8, f'nan window taps given g: {n_g}/8')
            t = {'pool2_fwd': (time_ms(lambda: pool_cuda.pool2_fwd(x)),
                               time_ms(lambda: pool._max_pool_tiled_fwd(x, w))),
                 'pool2_bwd': (time_ms(lambda: pool_cuda.pool2_bwd(x, g)),
                               time_ms(lambda: pool._max_pool_tiled_bwd(
                                   x, yp, g, w)))}
            for name, (k_ms, p_ms) in t.items():
                err = max_abs_err(yk, yp) if name == 'pool2_fwd' \
                    else max_abs_err(dk, dp)
                r = res[name]
                r['max_abs_err'] = max(r['max_abs_err'], err)
                if dtype == torch.bfloat16:  # the training step's type
                    r['ms'] += k_ms
                    r['plain_ms'] += p_ms
                print(f'  {name} {tag}: kernel {k_ms:.4f} ms, plain '
                      f'{p_ms:.4f} ms', flush=True)


def phase_dice(checks, res):
    print('== 4. Dice sums K3 vs plain', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(4)
    shape = (1, VOL ** 3, NB_LABELS)
    x = torch.softmax(torch.randn(shape, generator=gen, device='cuda'), -1)
    lab = torch.randint(0, NB_LABELS, shape[:2], generator=gen, device='cuda')
    y = torch.nn.functional.one_hot(lab, NB_LABELS).float()
    k = dice_red.dice_sums_cuda(x, y)
    p = dice_red._dice_sums_plain(x, y)
    torch.cuda.synchronize()
    ok = all(torch.allclose(a, b, rtol=1e-5, atol=0.) for a, b in zip(k, p))
    err = max(max_abs_err(a, b) for a, b in zip(k, p))
    rel = max(float(((a - b).abs() / b.abs()).max()) for a, b in zip(k, p))
    checks.check(f'dice sums {shape}', ok, f'max abs err {err:.6g}, '
                 f'max rel err {rel:.3g} (rtol 1e-5)')
    k_ms = time_ms(lambda: dice_red.dice_sums_cuda(x, y))
    p_ms = time_ms(lambda: dice_red._dice_sums_plain(x, y))
    res['dice_sums'].update(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
    print(f'  dice_sums {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms',
          flush=True)


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
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  step ms (median of steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}): '
          f'{step_ms:.3f}; all: '
          + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  vol/s {1e3 / step_ms:.3f}; peak memory '
          f'{peak} B ({peak / 2 ** 30:.3f} GiB)', flush=True)


def main():
    card = phase_device()
    checks = Checks()
    res = {n: {'name': n, 'route': 'cuda', 'source': src, 'replaces': rep,
               'launches': 0, 'max_abs_err': 0., 'ms': 0., 'plain_ms': 0.}
           for n, (src, rep) in KERNELS.items()}
    build_s = phase_build()
    phase_pool(checks, res)
    phase_dice(checks, res)
    x, y = flagship_inputs()
    phase_parity(checks, x, y)
    phase_train(checks, res, x, y)
    print(f'card: {card}; kernel build {build_s:.3f} s; pool ms are the sums '
          f'over the three bf16 pool shapes of one step')
    print(json.dumps({'kernels': list(res.values())}))
    if checks.failed:
        print(f'FAILED: {checks.failed}', flush=True)
        sys.exit(1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
