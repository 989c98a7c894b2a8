"""
Smoke test of the PyTorch/CUDA port (`neurite_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases 1,2,24,25   # only the phases named

Drives the port's paths through their public entry points: the
flagship 3-D UNet training step (nb_features=16, nb_levels=4, feat_mult=2,
nb_conv_per_level=2, conv_size=3, nb_labels=4, 128^3, batch 1, SoftDice,
Adam 1e-3), the config #5 synthesis -> UNet training step, the config #3
UNet -> LocallyConnected3D head training step, the MI registration step
(`benchmarks/mi_context.py:32-62`), the SynthStrip training step (v1
synthesis -> FreeSurfer's mri_synthstrip UNet), the config #4 conv VAE
training step (`bench.py:376-389`), config #4's sparse-imputation VAE step
(`benchmarks/vae_sparse.py`), and the flagship with space_to_depth=2 and
with remat=True (with checkpoints and the checked step), whole-volume
patch inference of a 256^3 scan through the flagship (the serve path), an
EncoderNet training step, and the flagship trained from FreeSurfer-style
volumes on disk (`generators.vol_seg` -> `prefetch_to_device` ->
`training.fit`) beside the threaded feed of `bench.py:292-339`, the
flagship trained data-parallel over ranks (`parallel.create_mesh`,
`shard_batch`, `make_sharded_train_step`) and the z-sharded halo ops of
`parallel` at config #3's and config #5's widths, the whole flagship and
config #3's model partitioned along z over ranks
(`make_sharded_train_step` on a 'space' mesh), and the six
`examples_torch` scripts; and counts every hand-written kernel's launches
and bodies on them exactly, each path's launch counts set to 0 just before
it and read just after. Every path that trains steps through
`training.adam`, so each also checks K11's launches (Adam): exactly
`adam_per_step`'s a step, one for each run of up to 64 leaves of one
dtype, by the 'vec' body unless a leaf's length is ragged; a plain twin
launches those and nothing else.

Each on-card job has one home. The kernels against their plain versions
are the card tests, which import no JAX (phase 33 runs them here):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_*_cuda.py

The four paths with a cell (the flagship's step, config #3's, SynthStrip's
and the serve path) are timed by the benchmark, `python3 h100bench/run.py
--workload <cell>`; their phases here (6, 12, 17, 24) check losses,
launches and syncs and time nothing. The paths without a cell keep their
timings here. The phases, in the order they run (phase 1 runs whatever
--phases names; 3, 4, 7, 8, 10, 13 and 32, the kernels' checks, are the
card tests `tests/test_torch_{pool,dice,warp,blur,lc,mi,adam}_cuda.py`):

  1. device: the card, its power limit, the torch and CUDA versions;
  2. build: nvcc builds the kernels (`neurite_tpu_torch/ops/csrc`);
 33. the card tests (`tests/test_torch_*_cuda.py`, `pytest -m cuda`) in
     this process: every kernel against its plain version at its paths'
     shapes, its bodies and its launch counts; any failed case fails the
     phase;
  5. one float32 step through the kernels and one through the plain versions
     from the same weights (TF32 off, deterministic cuDNN): losses within
     rtol 1e-5, each gradient within 1e-4 of its largest magnitude (the Dice
     sums' order is the only difference);
  6. 10 bfloat16 training steps: finite losses, launch counts of K1, K2,
     K3 and K11 (Adam, one launch a step) exactly those of 10 steps, every
     K1, K3 and K11 launch by its 'vec' body;
  9. config #5 (bench.py's synth_rate): `labels_to_image_new(labels_in=
     range(16), out_shape=(128,)*3, one_hot=True)` feeding the bf16 UNet
     (nb_labels=16) for 10 steps of synthesis then train step; finite
     losses, one-hot maps, launch counts of K1-K4 and K6 exactly those of 10
     steps (each K6 launch by the 'whole' body, each K1, K3 and K4 launch
     by its 'vec' body); synthesis ms, step ms,
     vol/s, peak memory; no host sync in the synthesis (CUDA's sync debug
     mode); the synthesis through the kernels against the plain CPU path on
     the same raw draws at 64^3 (every K4 and K6 call of the path: the
     Perlin blurs, the squarings, the label warp and the image blur);
     profiles of 3 synthesis calls and of 3 steps (device time by kernel,
     idle share);
 11. one float32 config #3 step at 64^3 through the kernels and one through
     the plain versions from the same weights (TF32 off, deterministic
     cuDNN): losses within rtol 1e-5, each gradient within 1e-4 of its
     largest magnitude; K7, K8 and K9 each once, by its row body;
 12. config #3 (`bench.py:335-372`): the UNet trunk (nb_features=8,
     nb_levels=3, feat_mult=2, linear output, bf16 compute) feeding
     LocallyConnected3D(filters=1, kernel_size=3, 'same', bf16 weights
     [1, 108, 160^3]), MSE, Adam 1e-4, 160^3, 10 steps: finite losses,
     launch counts of K1, K2, K7-K9 and K11 (2 a step: the trunk's float32
     group and the head's bfloat16 one) exactly those of 10 steps, each of
     K7-K9 by its row body every step (`lc_fwd_row`, `lc_dk_row`,
     `lc_dx_row`), each K1 and K11 launch by its 'vec' body;
 14. one MI registration step at 64^3 (the field at +-2 voxels) on the card
     (K4, K10) and on the CPU (plain forms), both on the kernel route
     (`volumes_fused(impl='pallas')`): losses within rtol 1e-5, the field
     gradient within 1e-4 of its largest magnitude;
 15. MI registration at 128^3 (moving/fixed blob pair, field [1, 128^3, 3]
     from zero, clamp +-3, `MutualInformation(nb_bins=16)`, Adam 1e-2),
     10 steps: finite, falling losses, launches exactly K10 10 (by the
     'tiled' body) and K4 10 (by the 'vec' body),
     no host sync in a step, median step ms, pairs/s, peak memory, a
     profile of 3 steps, and the same steps through `MI.volumes` (twin);
 16. SynthStrip at 64^3 (the 7-level UNet's pools go down to 1^3): the v1
     synthesis (`labels_to_image(one_hot=False)`, 16 labels, 1-11 the
     brain) through the kernels vs the plain CPU path from one set of raw
     draws (velocity and bias fields within 1e-5 of their maximum, the
     deformation within 1e-4, the map's mismatch share at most 1e-3 for
     nearest ties, the image within 1e-4 away from mismatches); then one
     f32 `SynthStrip` step through the kernels (K1, K2 6 each, K4 6, K6 3)
     and one through their plain versions (`impl='plain'`) from the same
     weights and draws (TF32 off, deterministic cuDNN): losses within rtol
     1e-5, each gradient within 1e-4 of its largest magnitude;
 17. SynthStrip (`SynthStrip(inshape=(128,)*3, labels_in=range(16),
     labels_out={1..11: 1}, nb_unet_features=[16, 32, 64, 64, 64, 64, 64],
     nb_unet_conv_per_level=2)`, 2,566,145 parameters, f32), the sigmoid
     soft Dice of `examples/synthstrip_training.py:32-39`, Adam 1e-3, 10
     steps at 128^3, the synthesis drawn anew each step: finite losses,
     launch counts of K1, K2, K4 and K6 exactly those of 10 steps, each K1
     and K4 launch by the 'vec' body and each K6 launch by the 'whole' body
     that their choosers pick; no host sync in the synthesis;
 18. one f32 config #4 step at 64^3 (enc_size (4, 4, 4, 16)) through the
     kernels (K1, K2 3 each) and one through the plain pools from the same
     weights and one `SampleNormalLogVar` draw: losses within rtol 1e-5,
     gradients within 1e-4 of their largest magnitude;
 19. config #4 (`ae(nb_features=8, input_shape=(128,)*3+(1,), nb_levels=4,
     conv_size=3, nb_labels=1, enc_size=(8, 8, 8, 16), ae_type='conv',
     do_vae=True, feat_mult=2, final_pred_activation='linear', bf16)`,
     228,593 parameters), MSE against the f32 input, Adam 1e-4, 10 steps:
     finite losses, launch counts of K1 and K2 exactly those of 10 steps,
     each K1 launch by the 'vec' body (bf16 channels 8, 16, 32); median
     step ms, vol/s, peak memory, a profile of 3 steps (idle share);
 20. `SpatiallySparse_Dense` at D = 32^3, d = 32 with a bias, on the card
     against the CPU from the same weights: the encode through its
     one-shot and its chunked branch (`sparse._ENCODE_CHUNK_ELEMS`
     patched) and the decode, values and gradients within 1e-5 of their
     largest magnitude (float32 products of 32^3 terms in another order);
     TF32 off for them; one f32 sparse VAE step at 16^3, d = 16 and at
     32^3, d = 32 on each device from the same weights and noise: loss
     within rtol 1e-5 (1 + max |lv| / 2) (the sample exp(lv / 2) noise
     turns the log-variance's rounding into that relative error), every
     gradient within 1e-4 of its largest magnitude;
 21. config #4's sparse VAE (`benchmarks/vae_sparse.py:33-60`: [1, 128^3,
     1] default_rng(1) noise, every 8th z-slice observed,
     SpatiallySparse_Dense d = 128 encode -> Dense mu and logvar ->
     SampleNormalLogVar -> shared-weight decode, MSE on the observed
     voxels, Adam 1e-4, f32), 10 steps. The initial weights' encode solves
     its masked normal equations (relative residual within 1e-4, latent
     and log-variance finite); the first loss is finite unless exp(lv / 2)
     overflows float32, which the benchmark's initial weights make it do
     at this size (the JAX package's loss is NaN from 64^3 on), so the
     steps after it run on NaN weights; the layer alone, encode -> decode
     without the sampler, has a finite loss and finite gradients at full
     size; step 1 from the initial weights and a fresh Adam state, timed
     apart 4 times (median ms of the last 3, vol/s, beside the step's
     bound from its
     FLOPs (30 D d^2) and bytes); then 10 steps: no host sync in a step
     (CUDA's sync debug mode), median step ms of the NaN steps, peak
     memory, a profile of 3 steps (idle share);
 22. the flagship with space_to_depth=2: one f32 step at 64^3 through the
     kernels and one through the plain pools and Dice from the same
     weights (as phase 5: losses within rtol 1e-5, gradients within 1e-4
     of their largest magnitude); 10 bf16 steps at 128^3: finite losses,
     launches exactly K1 3, K2 3, K3 1 a step (pools at 64^3*16, 32^3*32,
     16^3*64, Dice at [1, 128^3, 4]), every K1 and K3 launch by its 'vec'
     body; median step ms, vol/s, peak memory, a profile of 3 steps;
 23. the flagship with remat=True at 128^3: one f32 step against one with
     remat=False from the same weights (TF32 off, deterministic cuDNN):
     loss and gradients within rtol 1e-6; 10 bf16 steps each with and
     without remat: launches exactly K1 6 (the pools sit inside the
     recomputed encoder, as in JAX), K2 3, K3 1 a step with remat, median
     step ms, and the peak memory lower with remat; a checkpoint round trip
     (2 steps, save, restore into a fresh state, 2 steps) bit-equal to 4
     steps; the checked step (`make_checked_train_step`, SoftDice with
     check_input_limits='checkify'): no host sync in a clean step, which
     reports no error, and `throw()` raising JAX's message for a Dice
     input scaled outside [0, 1]; its finite flags on the card flag NaN
     and both infinities in f32 and bf16 and no large finite value;
 24. the serve path: the bf16 flagship (weights from seed 0, eval mode)
     over a [256^3, 1] default_rng(0) volume in 27 patches of 128^3 at
     stride 64. On the card (`utils.seg.predict_volume_device`, overlap
     mean accumulated in bf16): launches exactly K1 81 a volume, all by
     its 'vec' body, and no other kernel; the prediction [256^3, 4] bf16,
     finite, its labels' probabilities summing to 1 within 2e-2; no host
     sync; bit-equal to the same
     run with pool_impl='plain' (which launches nothing); with stride =
     patch size `quilt_device` of `patch_gen` returns the volume bit for
     bit; `quilt_device` of the 27 predictions in f32 within 1e-6
     relative of the host `tiling.quilt(agg='mean')` (float64), the bf16
     run's accumulation within 2^-6 of that quilt. Host-driven
     (`utils.seg.predict_volumes`, one patch at a time to the card, the
     host nan-median quilt): wall time once and the quilt's share, labels
     finite in [0, 4). Then a 32^3 volume in 16^3 patches at stride 8
     through a 2-level f32 UNet, card vs CPU, within 1e-5 relative;
 25. one EncoderNet training step (nb_features=16, nb_levels=4,
     feat_mult=2, max-pool route, f32, CCE, Adam 1e-3) at 64^3 on the card
     and on the CPU from the same weights (TF32 off, deterministic cuDNN):
     loss within rtol 1e-5, gradients within 1e-4 of their largest
     magnitude, launches exactly K1 3 ('vec') and K2 3 on the card;
     HyperConv3D (per-sample kernels (3, 2, 3), stride 2, 'same', ELU)
     forward within 1e-5 and its three gradients within 1e-4 relative,
     card vs CPU; MeanStream and CovStream over 5 batches, outputs and
     statistics card vs CPU within 1e-5 relative;
 26. the flagship from disk: 8 subjects written by `io.save_volfile` (set-
     up, untimed: a uint8 160^3 `norm.mgz` and an int32 `aseg.mgz` of
     labels 0, 2, 3, 41 each, default_rng(0), gzip level 9) feed
     `generators.vol_seg(ext='.mgz', vol_proc(crop=16, rescale=1/255),
     volcrop(16), relabel, nb_labels_reshape=4)`: float16 x [1, 128^3, 1]
     and one-hot y [1, 128^3, 4], through `prefetch_to_device(size=2)`
     into `training.fit` of the bf16 flagship (seed 0, SoftDice, Adam
     1e-3). The feed's one-hot and relabel run the C++ host ops built from
     the port's source (`io/native.py`); the generator's ms a batch on the
     host alone; a batch's H2D ms on a copy stream from pinned memory; a
     checked run of 6 steps (deterministic cuDNN): each consumed device
     batch bit-equal to its host copy after its step, and every loss,
     step 0's among them, bit-equal to a run of a fresh model from the same
     weights on synchronous `.to('cuda')` puts of the same batches; the
     producer thread ended after `close()`; 10 steps from disk: finite
     losses, launches exactly K1 3, K2 3, K3 1, K11 1 a step (K1, K3 and
     K11 by their 'vec' bodies) and no other kernel, median step ms, peak
     memory, a
     profile of 3 steps (idle share), and the same step on one resident
     batch beside it;
 27. the threaded feed: 8 volumes of 128^3 float32 `.npz` (`vol_data`) ->
     `VolumeDataset.batches(1, num_workers=4)`, one warm batch then 24
     timed (host_vols_per_sec); one [1, 128^3] batch put 3 times through
     `prefetch_to_device`'s pinned copy and 3 times by a pageable
     `torch.from_numpy(b).to('cuda')`, each ended by a synchronise
     (put_mbps); `prefetch_to_device` over `batches(1, epochs=1,
     num_workers=4)` yields the 8 batches in order, each bit-equal to the
     serial `batches(1, epochs=1)`;
 28. the data-parallel flagship (`parallel`; each rank a process on the
     one card, started by torch.multiprocessing with spawn over a free
     localhost port, loading the kernels phase 2 built): (a) in this
     process, a 1 x 1 mesh over a 1-rank NCCL group: 3 f32 steps of
     `make_sharded_train_step` bit-equal to 3 plain steps from the same
     weights, losses and parameters (TF32 off, deterministic cuDNN); (b)
     a 'data' mesh of 2 gloo ranks, global batch 2 (bench.py's draws),
     one item a rank: one f32 step (TF32 off, deterministic cuDNN), each
     rank's loss within rtol 1e-5 and each averaged gradient within 1e-4
     of its largest magnitude of the single-process step on the batch of
     2, the ranks' parameters bit-equal to one another and within 2 lr +
     1e-6 of the single-process step's (Adam's first update is lr * g /
     (|g| + eps), about lr for any g, so a near-zero gradient whose sign
     the sums' order flips moves its parameter 2 lr the other way; the
     count of entries off by more than 1e-6 is printed); then 10 bf16
     steps: finite losses, launches exactly K1 3, K2 3, K3 1 a step on
     each rank, all 'vec', the median step ms of each rank (both ranks at
     once on the card), the gradient all-reduce alone (the same buffer
     and group, median of 10) and its share of the step, peak memory;
 29. the halo ops on a 1 x 2 'space' mesh of 2 gloo ranks on the card
     (halos through host memory, counted: 6 exchanges forward and 1
     backward a rank), each on the rank's z block against the unsharded
     op on the same card: `sharded_lc(impl='pallas')` at config #3's head
     (x [1, 160^3, 4] bf16, kernel [1, 108, 160, 160^2] bf16): forward
     (K7) and dk (K8) bit-equal, dx (K9) bit-equal off the block's edge
     rows and within 2^-7 of its largest magnitude on them (two bf16
     roundings where the returned halo gradient adds), an Adam step on
     the z block bit-equal to the unsharded step's block with moments of
     the block's shape; `sharded_bounded_warp` (K4) at [1, 64^3, 3]
     linear under a smooth +-8 voxel field (max_disp 8: a halo of 9 of
     32 rows; within 1e-5) and [1, 128^3, 1] nearest with fill 0
     (bit-equal); `sharded_separable_blur` (K6) at [3, 64^3] with 41 taps
     and [1, 128^3] with 7 (bit-equal), 165 taps on a 64-row block
     raising; `sharded_dice_sums` (K3) at [1, 128^3, 4] within rtol 1e-5,
     two calls bit-equal; `sharded_conv` at a flagship conv (3^3, 16 ->
     16, 128^3) within 1e-5 of max |y| (TF32 off); launches exactly K7,
     K8, K9 1, K4 2, K6 6, K3 1 a rank; each op's host ms a rank (both
     ranks at once) beside the unsharded op's on one rank alone.
 30. the flagship and config #3 partitioned along z over a 1 x 2 'space'
     mesh of 2 gloo ranks on the card (`make_sharded_train_step`): the
     flagship's f32 step against the unsharded one, 10 bf16 steps of each
     with exact launches, gathers and host-staged halo exchanges a rank,
     the head's K7-K9 bit-equal on the block to the unsharded kernels on
     the gathered inputs; step ms and peak memory a rank beside the
     unsharded step's;
 31. the six `examples_torch` scripts on the card, with
     `tests/test_examples.py`'s checks of what each returns.

A step's ms is the host's time to a synchronise; the step parts of phase
15 are device times from torch.profiler (CUDA events where it records
nothing), and a path's bound reads the benchmark's rates
(`h100bench/peaks.json`). Prints one line per check and last `{"ok": true,
"device": {...}}`; any failed check exits non-zero, and so does a machine
without a CUDA device. Run with --phases, the last line names the phases
that ran.
"""

import argparse
import glob
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import neurite_tpu_torch as nt
from neurite_tpu_torch import training
from neurite_tpu_torch.layers import sparse
from neurite_tpu_torch.models.ae import Dense
from neurite_tpu_torch.models.unet import Conv
from neurite_tpu_torch.io import tiling
from neurite_tpu_torch.ops import (_build, adam, blur, dice_red, lc_cuda,
                                   pool_cuda)
from neurite_tpu_torch.utils import core, seg, spatial

REPO = os.path.dirname(os.path.abspath(__file__))
VOL = 128
NB_LABELS = 4
TRAIN_STEPS = 10
WARMUP_STEPS = 3
SYNTH_LABELS = 16
CHECK_VOL = 64      # the synthesis check against the plain CPU path
PROFILE_STEPS = 3
PHASES = ('1', '2', '33', '5', '6', '9a', '9', '11', '12', '14', '15', '16',
          '17', '18', '19', '20', '21', '22', '23', '24', '25', '26', '27',
          '28', '29', '30', '31')
# the kernel phases that became card tests: the test file holding each
CARD_TESTS = {'3': 'tests/test_torch_pool_cuda.py',
              '4': 'tests/test_torch_dice_cuda.py',
              '7': 'tests/test_torch_warp_cuda.py',
              '8': 'tests/test_torch_blur_cuda.py',
              '10': 'tests/test_torch_lc_cuda.py',
              '13': 'tests/test_torch_mi_cuda.py',
              '32': 'tests/test_torch_adam_cuda.py'}
LC_VOL = 160        # config #3's volume
LC_CHECK_VOL = 64   # its float32 step, kernels vs plain
LC_KS = (3, 3, 3)
MI_BINS = 16        # the registration path's MutualInformation(nb_bins=16)
REG_CHECK_VOL = 64  # its step on the card vs the plain CPU path
REG_LR = 1e-2
# SynthStrip: FreeSurfer's mri_synthstrip StripModel widths through the JAX
# builder's knobs; the brain is labels 1-11 of 16
SYNTHSTRIP = dict(labels_in=range(16), labels_out={l: 1 for l in range(1, 12)},
                  nb_unet_features=[16, 32, 64, 64, 64, 64, 64],
                  nb_unet_conv_per_level=2)
STRIP_CHECK_VOL = 64    # its step kernels vs plain: the pools go down to 1^3
VAE_CHECK_VOL = 64      # config #4's f32 step, kernels vs plain
# config #4's sparse VAE (`benchmarks/vae_sparse.py`): d = 128 at 128^3,
# Adam 1e-4; checked card vs CPU at 32^3 with d = 32
SPARSE_LATENT = 128
SPARSE_LR = 1e-4
SPARSE_CHECK_VOL = 32
SPARSE_CHECK_LATENT = 32
SPARSE_STEP_CHECKS = ((16, 16), (32, 32))   # its whole step, card vs CPU
SPARSE_FIRST_STEPS = 3     # step 1 from the initial weights, timed apart
                           # after one more as a warm-up
S2D_CHECK_VOL = 64      # the space_to_depth flagship's f32 step, kernels vs plain
# the serve path: a conformed 256^3 scan through the flagship in 128^3
# patches at stride 64 (a 3^3 grid); checked card vs CPU at 32^3 with 16^3
# patches at stride 8 through a 2-level f32 UNet
SERVE_VOL = 256
SERVE_PATCH = 128
SERVE_STRIDE = 64
SERVE_CHECK = (32, 16, 8)
CLASSIFY_VOL = 64       # the EncoderNet step, card vs CPU
STREAM_BATCHES = (2, 3, 1, 4, 2)
# the flagship from disk: FreeSurfer-style subjects (a uint8 norm.mgz and an
# int32 aseg.mgz of unknown, left WM, left cortex and right WM), 160^3
# cropped by 16 a side to the flagship's 128^3
DISK_SUBJECTS = 8
DISK_VOL = 160
DISK_CROP = 16
DISK_LABELS = [0, 2, 3, 41]
DISK_CHECK_STEPS = 6
DISK_HOST_BATCHES = 5
# the threaded feed (`bench.py:292-339`): 8 volumes of 128^3 float32 .npz
FEED_VOLS = 8
FEED_WORKERS = 4
FEED_BATCHES = 24
FEED_PUTS = 3
# the ranks of phases 28, 29 and 30, processes on the one card
DP_RANKS = 2
HALO_RANKS = 2
SPACE_RANKS = 2
# config #3's head split over 'space' by JAX's specs (P(None, None,
# 'space') on the [O, TC, V] kernel, P('space') on the bias)
LC_SPECS = {"['lc']['kernel']": (None, None, 'space'),
            "['lc']['bias']": ('space',)}


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


def time_ms(fn, reps=20, warmup=3):
    """Device time of one fn() call in ms: the durations of the device
    events torch.profiler records over `reps` calls, summed, over reps (the
    host's time between launches is not in it); where the profiler records
    no event in three tries, CUDA events around the reps, which hold it."""
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
            return sum(ms for ms, _, _ in rows) / reps
    print('  (the profiler recorded no event in three tries: the next time '
          'is by CUDA events around 20 calls)', flush=True)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes, flops=0.):
    """(least ms, 'bytes' or 'operations'): the larger of bytes over the
    memory rate and float32 operations over the non-tensor-core peak, both
    the benchmark's (`h100bench/peaks.json`)."""
    with open(os.path.join(REPO, 'h100bench', 'peaks.json')) as f:
        peaks = json.load(f)
    t_bytes = 1e3 * nbytes / peaks['hbm_bytes_per_s']
    t_ops = 1e3 * flops / peaks['f32_flop_per_s']
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bit_equal(a, b):
    """Same shape and dtype, NaN at the same places, all other bits equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
           torch.float16: torch.int16}[a.dtype]
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


def no_host_sync(fn):
    """'' when fn() runs under CUDA's sync debug mode 'error' without a
    host sync, else the first line of the error it raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
        return ''
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode('default')


def timed_steps(step, state, args, n=TRAIN_STEPS):
    """n calls state, m = step(state, *args), each ended by a synchronise,
    from zeroed launch counts and peak memory: (state, losses, seconds a
    step, launch counts, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m['loss'])
    counts = dict(_build.launches)
    return (state, [float(v) for v in losses], times, counts,
            torch.cuda.max_memory_allocated())


def report_steps(label, times, peak):
    """Print the median step ms of steps after the warm-up, vol/s and the
    peak memory; return the median ms."""
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  {label}: step ms (median of steps {WARMUP_STEPS + 1}-'
          f'{len(times)}) {step_ms:.3f}; all: '
          + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  {label}: vol/s {1e3 / step_ms:.3f}; peak memory {peak} B '
          f'({peak / 2 ** 30:.3f} GiB)', flush=True)
    return step_ms


def exact_f32():
    """TF32 off and deterministic cuDNN, for steps compared bit for bit or
    within float32 tolerances; returns the flags to restore."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return flags


def restore_flags(flags):
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


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


def flagship_inputs(vol=VOL):
    """bench.py's inputs: numpy default_rng(0) normal image, random labels."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, vol, vol, vol, 1)).astype(np.float32)
    lab = rng.integers(0, NB_LABELS, size=(1, vol, vol, vol))
    x = torch.from_numpy(x).cuda()
    y = torch.nn.functional.one_hot(torch.from_numpy(lab).cuda(),
                                    NB_LABELS).float()
    return x, y


def flagship(dtype=None, pool_impl='auto', vol=VOL, seed=0, **kw):
    """The flagship UNet (weights from `seed`); `kw` sets space_to_depth
    or remat."""
    return nt.models.unet(
        nb_features=16, input_shape=(vol, vol, vol, 1), nb_levels=4,
        conv_size=3, nb_labels=NB_LABELS, feat_mult=2, nb_conv_per_level=2,
        dtype=dtype, pool_impl=pool_impl,
        generator=torch.Generator().manual_seed(seed), device='cuda', **kw)


def phase_card_tests(checks):
    import pytest
    print('== 33. the kernels\' card tests', flush=True)
    files = sorted(glob.glob(os.path.join(REPO, 'tests',
                                          'test_torch_*_cuda.py')))
    rc = pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-q',
                      '-m', 'cuda', *files])
    checks.check('card tests pass', bool(files) and rc == 0,
                 f'exit code {int(rc)}, {len(files)} files')


def phase_parity(checks, x, y):
    print('== 5. flagship f32 step: kernels vs plain', flush=True)
    flags = exact_f32()
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
        restore_flags(flags)


def phase_train(checks, x, y):
    print(f'== 6. flagship bf16 training, {TRAIN_STEPS} steps', flush=True)
    model = flagship(dtype=torch.bfloat16)
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    gen = torch.Generator(device='cuda').manual_seed(1)
    state, losses, _, counts, _ = timed_steps(step, state, ((x, y), gen))
    checks.check('training losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    check_step_counts(checks, 'flagship', counts,
                      {'pool2_fwd': 3, 'pool2_bwd': 3, 'dice_sums': 1},
                      TRAIN_STEPS)
    check_vec_bodies(checks, 'flagship', counts)
    check_adam_counts(checks, 'flagship', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)


def check_vec_bodies(checks, path, counts):
    """Every K1, K3 and K4 launch of a path's run by its 'vec' body."""
    for name in ('pool2_fwd', 'dice_sums', 'interpn'):
        if name in counts:
            got = counts.get(f'{name}_vec', 0)
            checks.check(f'{path} launches {name}_vec', got == counts[name],
                         f'{got} (expected {counts[name]}, every {name} '
                         f'launch)')


def adam_per_step(optimizer):
    """K11's launches a step of `optimizer` (an `ops.adam.Adam`) over the
    parameters that hold a gradient, as `adam.adam_cuda` groups them: one
    for each run of up to adam.MAX_TENSORS non-empty tensors of one group
    and dtype, counted 'adam_vec' where every length in it is a multiple
    of a 16-byte vector's width (the caching allocator starts each tensor
    512-byte aligned), else 'adam_scalar'."""
    out = {'adam': 0, 'adam_vec': 0, 'adam_scalar': 0}
    for group in optimizer.param_groups:
        by_dtype = {}
        for p in group['params']:
            if p.grad is not None and p.numel():
                by_dtype.setdefault(p.dtype, []).append(p)
        for ps in by_dtype.values():
            width = 16 // ps[0].element_size()
            for at in range(0, len(ps), adam.MAX_TENSORS):
                part = ps[at:at + adam.MAX_TENSORS]
                out['adam'] += 1
                out['adam_vec' if all(p.numel() % width == 0 for p in part)
                    else 'adam_scalar'] += 1
    return out


def check_adam_counts(checks, path, counts, want, steps):
    """K11's launches in a path run's counts exactly `want` (launches a
    step, `adam_per_step`'s) times `steps`, a body counter that `want`
    gives 0 among them."""
    got = {k: counts.get(k, 0) for k in want}
    total = {k: n * steps for k, n in want.items()}
    checks.check(f'{path} launches adam', got == total and got['adam'] > 0,
                 f'{got} (expected {want} a step)')


def smooth_field(shape, amp, gen):
    """A smooth [1, *shape, 3] displacement field with max |value| = amp:
    normal noise at 1/8 resolution, upsampled trilinearly."""
    low = torch.randn((1, 3, *[max(s // 8, 2) for s in shape]), generator=gen,
                      device='cuda')
    f = torch.nn.functional.interpolate(low, size=shape, mode='trilinear',
                                        align_corners=True)
    f = f.permute(0, 2, 3, 4, 1).contiguous()
    return f * (amp / f.abs().max())


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


def phase_synth_train(checks):
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
    check_step_counts(checks, 'config #5', counts,
                      {'interpn': 6, 'blur': 12, 'blur_whole': 12,
                       'pool2_fwd': 3, 'pool2_bwd': 3, 'dice_sums': 1},
                      TRAIN_STEPS)
    check_vec_bodies(checks, 'config #5', counts)
    check_adam_counts(checks, 'config #5', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)
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
    def synth_last():
        with torch.no_grad():
            gen_model(lab, training.step_generator(0, TRAIN_STEPS, 'cuda'))
    synced = no_host_sync(synth_last)
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


def config3(size, dtype, impl='auto'):
    """Config #3 (`bench.py:335-372`) at size^3 through the port's
    `nt.models.UNetLC`: `nt.models.unet_lc` with bench.py's settings, in
    `dtype` (None: float32). impl='plain' builds its twin from the same
    draws: the same trunk and head over the plain pool and LC forms."""
    sp = (size,) * 3
    param_dtype = dtype or torch.float32
    if impl != 'plain':
        return nt.models.unet_lc(input_shape=(*sp, 1), dtype=dtype,
                                 param_dtype=param_dtype, device='cuda')
    gen = torch.Generator().manual_seed(0)
    trunk = nt.models.unet(
        nb_features=8, input_shape=(*sp, 1), nb_levels=3, conv_size=3,
        nb_labels=4, feat_mult=2, final_pred_activation='linear',
        dtype=dtype, pool_impl='plain', generator=gen, device='cuda')
    head = nt.layers.LocallyConnected3D(
        filters=1, kernel_size=3, padding='same', input_shape=(*sp, 4),
        param_dtype=param_dtype, impl='plain', generator=gen, device='cuda')
    return nt.models.UNetLC(trunk, head)


def config3_inputs(size):
    """bench.py's config #3 batch: x and y normal draws of one rng."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, size, size, size, 1)).astype(np.float32)
    y = rng.normal(size=(1, size, size, size, 1)).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def mse(y_true, y_pred):
    return torch.mean((y_true - y_pred.float()) ** 2)


def plain_vs_kernels(checks, path, make, step_args, launches):
    """One float32 step of make(impl) through the kernels ('auto') and
    through their plain versions ('plain') from the same weights and the
    same draws (TF32 off, deterministic cuDNN): the losses within rtol
    1e-5, every gradient within 1e-4 of its largest magnitude, the kernel
    run's launches `launches`, and each run's K11 launches (both step
    through `training.adam`) exactly `adam_per_step`'s, the plain run's no
    others."""
    flags = exact_f32()
    try:
        runs = {}
        for impl in ('auto', 'plain'):
            model, loss_fn = make(impl)
            state = training.create_train_state(model, training.adam(1e-3))
            _build.launches.clear()
            state, m = training.make_train_step(loss_fn)(state, *step_args())
            runs[impl] = (float(m['loss']), dict(_build.launches),
                          {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()})
            want = {k: n for k, n in adam_per_step(state.optimizer).items()
                    if n}
            del model, state
        (lk, nk, gk), (lp, np_, gp) = runs['auto'], runs['plain']
        checks.check(f'{path} f32 launches', all(
            nk.get(n, 0) == c for n, c in {**launches, **want}.items())
            and np_ == want,
            f'kernels {nk}, plain {np_} (K11 a step: {want})')
        checks.check(f'{path} f32 loss', abs(lk - lp) <= 1e-5 * abs(lp),
                     f'kernels {lk!r} plain {lp!r} (rtol 1e-5)')
        worst = max(float((gk[n] - gp[n]).abs().max() / gp[n].abs().max())
                    for n in gp)
        checks.check(f'{path} f32 grads', worst <= 1e-4,
                     f'{len(gp)} tensors, worst max|diff|/max|g| {worst:.3g} '
                     f'(limit 1e-4); all equal '
                     f'{all(torch.equal(gk[n], gp[n]) for n in gp)}')
    finally:
        restore_flags(flags)


def phase_lc_check(checks):
    print(f'== 11. config #3 f32 step at {LC_CHECK_VOL}^3: kernels vs plain',
          flush=True)
    x, y = config3_inputs(LC_CHECK_VOL)
    plain_vs_kernels(
        checks, 'config #3',
        lambda impl: (config3(LC_CHECK_VOL, None, impl), mse),
        lambda: ((x, y),),
        {'lc_fwd': 1, 'lc_fwd_row': 1, 'lc_dk': 1, 'lc_dk_row': 1,
         'lc_dx': 1, 'lc_dx_row': 1, 'pool2_fwd': 2, 'pool2_bwd': 2})


def phase_lc_train(checks):
    print(f'== 12. config #3: UNet -> LocallyConnected3D head, bf16, '
          f'{TRAIN_STEPS} steps at {LC_VOL}^3', flush=True)
    model = config3(LC_VOL, torch.bfloat16)
    print(f'  {sum(p.numel() for p in model.parameters())} parameters, head '
          f'kernel {list(model.lc.kernel.shape)} {model.lc.kernel.dtype}')
    x, y = config3_inputs(LC_VOL)
    state = training.create_train_state(model, training.adam(1e-4))
    step = training.make_train_step(mse)
    state, losses, _, counts, _ = timed_steps(step, state, ((x, y),))
    checks.check('config #3 losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    moments = state.optimizer.state[model.lc.kernel]['exp_avg'].dtype
    checks.check('config #3 head moments in the parameter dtype',
                 moments == torch.bfloat16, str(moments))
    check_step_counts(checks, 'config #3', counts,
                      {'pool2_fwd': 2, 'pool2_bwd': 2, 'lc_fwd': 1,
                       'lc_fwd_row': 1, 'lc_dk': 1, 'lc_dk_row': 1,
                       'lc_dx': 1, 'lc_dx_row': 1, 'adam': 2, 'adam_vec': 2},
                      TRAIN_STEPS)
    check_vec_bodies(checks, 'config #3', counts)


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


def phase_reg_train(checks):
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
    for name in ('mi_hist', 'mi_hist_tiled', 'interpn', 'interpn_vec'):
        got = counts.get(name, 0)
        checks.check(f'MI registration launches {name}',
                     got == TRAIN_STEPS, f'{got} (expected 1 per step)')
    step_ms = 1e3 * statistics.median(times[WARMUP_STEPS:])
    print(f'  step ms (median of steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}): '
          f'{step_ms:.3f}; all: ' + ' '.join(f'{1e3 * t:.2f}' for t in times))
    print(f'  pairs/s {1e3 / step_ms:.3f}; peak memory {peak} B '
          f'({peak / 2 ** 30:.3f} GiB)', flush=True)

    synced = no_host_sync(step)
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


###############################################################################
# SynthStrip (phases 16, 17) and the config #4 VAE (phases 18, 19)
###############################################################################

def synthstrip(vol, impl='auto'):
    """FreeSurfer's mri_synthstrip StripModel widths (nb_features=16,
    nb_levels=7, feat_mult=2, max_features=64, 2 convs a level), 16
    generation labels, 1-11 the brain; weights from seed 0."""
    return nt.models.SynthStrip(
        inshape=(vol,) * 3, impl=impl,
        generator=torch.Generator().manual_seed(0), device='cuda',
        **SYNTHSTRIP)


def strip_loss(_, out):
    """`examples/synthstrip_training.py:32-39`: sigmoid soft Dice of channel
    0 (the prediction) against channel 1 (the synthesized brain mask),
    summed over every axis but the batch."""
    pred, truth = out[..., :1], out[..., 1:]
    p = torch.sigmoid(pred)
    axes = tuple(range(1, out.ndim))
    top = 2 * (p * truth).sum(axes)
    bot = (p * p).sum(axes) + (truth * truth).sum(axes)
    return -(top / bot.clamp_min(1e-7)).mean()


def strip_labels(vol, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, SYNTH_LABELS, size=(1, vol, vol, vol, 1))).cuda()


def vae(vol, dtype=None, pool_impl='auto'):
    """bench.py's config #4 (`bench.py:378-384`); at a volume other than
    128^3 the latent keeps its place: enc_size (vol / 16,)^3 + (16,), half
    the encoder's output."""
    return nt.models.ae(
        nb_features=8, input_shape=(vol,) * 3 + (1,), nb_levels=4,
        conv_size=3, nb_labels=1, enc_size=(vol // 16,) * 3 + (16,),
        ae_type='conv', do_vae=True, feat_mult=2, single_model=True,
        final_pred_activation='linear', dtype=dtype, pool_impl=pool_impl,
        generator=torch.Generator().manual_seed(0), device='cuda')


def vae_input(vol):
    """bench.py's vae_rate input: default_rng(0) normal [1, vol^3, 1]."""
    x = np.random.default_rng(0).normal(size=(1, vol, vol, vol, 1))
    return torch.from_numpy(x.astype(np.float32)).cuda()


def check_step_counts(checks, path, counts, per_step, steps, unit='step'):
    for name, n in per_step.items():
        got, want = counts.get(name, 0), n * steps
        checks.check(f'{path} launches {name}', got == want and got > 0,
                     f'{got} (expected {n} per {unit})')


def phase_strip_check(checks):
    vol = STRIP_CHECK_VOL
    print(f'== 16. SynthStrip at {vol}^3: the v1 synthesis through the '
          f'kernels vs the plain CPU path; one f32 step, kernels vs plain',
          flush=True)
    lab = strip_labels(vol, 1).cpu()
    kw = dict(in_label_list=SYNTHSTRIP['labels_in'],
              out_label_list=SYNTHSTRIP['labels_out'], one_hot=False,
              return_vel=True, return_def=True)
    gpu = nt.models.labels_to_image((vol,) * 3, device='cuda', **kw)
    cpu = nt.models.labels_to_image((vol,) * 3, device='cpu', **kw)
    # the raw draws made once; each device sums its Perlin fields and runs
    # the rest of the path (K4 and K6 on the card, plain on the CPU)
    draws = gpu.draw(lab.shape, torch.Generator(device='cuda').manual_seed(5))
    with torch.no_grad():
        fg = gpu.perlin(draws, lab.shape)
        fc = cpu.perlin(to_device(draws, 'cpu'), lab.shape)
        og = gpu.apply(lab.cuda(), fg)
        oc = cpu.apply(lab, fc)
    torch.cuda.synchronize()
    og = {k: v.cpu() for k, v in og.items()}
    rel = {k: max_abs_err(fg[k].cpu(), fc[k]) / float(fc[k].abs().max())
           for k in ('vel', 'bias')}
    e_def = max_abs_err(og['def'], oc['def'])
    bad = (og['map'] != oc['map'])[..., 0]
    mism = float(bad.float().mean())
    # a flipped label changes its voxel's intensity, and the image blur (7
    # taps, radius 3) its neighbours': compared elsewhere
    near = torch.nn.functional.max_pool3d(bad[:, None].float(), 7, stride=1,
                                          padding=3)[:, 0] > 0
    kept = float((~near).float().mean())
    e_img = max_abs_err(og['image'][~near], oc['image'][~near])
    ok = (max(rel.values()) <= 1e-5 and e_def <= 1e-4 and mism <= 1e-3
          and kept >= .5 and e_img <= 1e-4)
    checks.check('SynthStrip synthesis kernels vs plain CPU', ok,
                 f'vel {rel["vel"]:.3g} and bias {rel["bias"]:.3g} max abs '
                 f'err over max (1e-5); def max abs err {e_def:.3g} (1e-4); '
                 f'map mismatch share {mism:.3g} (1e-3, nearest ties); image '
                 f'max abs err {e_img:.3g} (1e-4) on the {kept:.4f} of voxels '
                 f'farther than 3 from a mismatch')
    lab = lab.cuda()
    plain_vs_kernels(
        checks, 'SynthStrip', lambda impl: (synthstrip(vol, impl), strip_loss),
        lambda: ((lab, lab), training.step_generator(0, 0, 'cuda')),
        {'pool2_fwd': 6, 'pool2_bwd': 6, 'interpn': 6, 'blur': 3})


def phase_strip_train(checks):
    print(f'== 17. SynthStrip: v1 synthesis -> f32 UNet (mri_synthstrip '
          f'widths, 7 levels), {TRAIN_STEPS} steps at {VOL}^3', flush=True)
    lab = strip_labels(VOL, 0)
    model = synthstrip(VOL)
    n_par = sum(p.numel() for p in model.parameters())
    checks.check('SynthStrip parameters', n_par == 2566145,
                 f'{n_par} (FreeSurfer StripModel: 2566145)')
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(strip_loss)
    _build.launches.clear()
    losses = []
    for i in range(TRAIN_STEPS):
        state, m = step(state, (lab, lab),
                        training.step_generator(0, i, 'cuda'))
        losses.append(float(m['loss']))
    counts = dict(_build.launches)
    checks.check('SynthStrip losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    check_step_counts(checks, 'SynthStrip', counts,
                      {'pool2_fwd': 6, 'pool2_fwd_vec': 6, 'pool2_bwd': 6,
                       'interpn': 6, 'interpn_vec': 6, 'blur': 3,
                       'blur_whole': 3}, TRAIN_STEPS)
    check_adam_counts(checks, 'SynthStrip', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)

    def synth():
        with torch.no_grad():
            return model.gen(lab, training.step_generator(0, TRAIN_STEPS,
                                                          'cuda'))
    synced = no_host_sync(synth)
    checks.check('SynthStrip synthesis without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")


def phase_vae_check(checks):
    vol = VAE_CHECK_VOL
    print(f'== 18. config #4 VAE f32 step at {vol}^3: kernels vs plain',
          flush=True)
    x = vae_input(vol)
    plain_vs_kernels(
        checks, 'config #4',
        lambda impl: (vae(vol, pool_impl=impl), mse),
        lambda: ((x, x), torch.Generator(device='cuda').manual_seed(1)),
        {'pool2_fwd': 3, 'pool2_bwd': 3})


def phase_vae_train(checks):
    print(f'== 19. config #4: conv VAE (bf16 encoder), {TRAIN_STEPS} steps '
          f'at {VOL}^3', flush=True)
    model = vae(VOL, torch.bfloat16)
    n_par = sum(p.numel() for p in model.parameters())
    checks.check('config #4 parameters', n_par == 228593,
                 f'{n_par} (bench.py vae_rate: 228593)')
    for size, c in ((VOL, 8), (VOL // 2, 16), (VOL // 4, 32)):
        body = pool_cuda.plan((1, size, size, size, c), torch.bfloat16,
                              (0, 0)).body
        print(f'  pool2_fwd at [1, {size}^3, {c}] bf16: pool_cuda.plan picks '
              f'{body!r}')
    x = vae_input(VOL)
    state = training.create_train_state(model, training.adam(1e-4))
    step = training.make_train_step(mse)
    gen = torch.Generator(device='cuda').manual_seed(1)
    state, losses, times, counts, peak = timed_steps(step, state,
                                                     ((x, x), gen))
    checks.check('config #4 losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    check_step_counts(checks, 'config #4', counts,
                      {'pool2_fwd': 3, 'pool2_fwd_vec': 3, 'pool2_bwd': 3},
                      TRAIN_STEPS)
    check_adam_counts(checks, 'config #4', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)
    report_steps('config #4', times, peak)
    try:
        report_profile('config #4 step', lambda i: step(state, (x, x), gen),
                       TRAIN_STEPS)
    except Exception as e:  # noqa: BLE001  (a reading, not a check)
        print(f'  config #4 profile not measured: {type(e).__name__}: {e}')


###############################################################################
# config #4's sparse-imputation VAE (phases 20, 21), the flagship with
# space_to_depth (22) and with remat, checkpoints and the checked step (23)
###############################################################################

class SparseVAE(torch.nn.Module):
    """`benchmarks/vae_sparse.py:33-46`'s SparseVAE from the port's public
    layers: SpatiallySparse_Dense encode (the masked normal-equations
    solve), Dense mu and logvar, SampleNormalLogVar, the shared-weight
    decode. The sparse layer's weights are drawn on `device` from seed 0,
    the Dense ones on the CPU from seed 1. `noise` replaces the sampler's
    draw (to run one step on two devices)."""

    def __init__(self, size, latent, device):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(0)
        self.ssd = nt.layers.SpatiallySparse_Dense(
            (size,) * 3 + (1,), latent, generator=gen, device=device)
        gen = torch.Generator().manual_seed(1)
        self.mu = Dense(latent, latent, generator=gen).to(device)
        self.logvar = Dense(latent, latent, generator=gen).to(device)
        self.sample = nt.layers.SampleNormalLogVar()

    def forward(self, yx, training=None, generator=None, noise=None):
        z = self.ssd(list(yx))
        mu_lv = [self.mu(z), self.logvar(z)]
        zs = (self.sample(mu_lv, generator) if noise is None
              else self.sample.apply(mu_lv, noise))
        return self.ssd([zs])


def sparse_inputs(size, device):
    """`benchmarks/vae_sparse.py:51-54`: default_rng(1) normal y, and a
    mask observing every 8th z-slice."""
    y = np.random.default_rng(1).normal(size=(1, size, size, size, 1))
    mask = np.zeros((1, size, size, size, 1), np.float32)
    mask[:, ::8] = 1.
    return (torch.from_numpy(y.astype(np.float32)).to(device),
            torch.from_numpy(mask).to(device))


def sparse_loss(mask):
    """MSE on the observed voxels (`benchmarks/vae_sparse.py:59-60`)."""
    def loss(y_true, y_pred):
        return torch.sum(mask * (y_true - y_pred.reshape(y_true.shape))
                         ** 2) / torch.sum(mask)
    return loss


def sparse_step_flops(size, latent):
    """The float32 operations of one sparse VAE step, from its shapes: five
    [d, D] x [D, d]-sized products in the forward pass (M^T M and
    inv @ M^T for each of the two W, and the encode's Gram) at 2 D d^2
    each, and two of the same size each in the backward pass."""
    return 3 * 5 * 2 * size ** 3 * latent ** 2


def phase_sparse_check(checks):
    size, d = SPARSE_CHECK_VOL, SPARSE_CHECK_LATENT
    print(f'== 20. SpatiallySparse_Dense at {size}^3 with d = {d}: both '
          f'encode branches and the decode, and one f32 sparse VAE step, '
          f'card vs CPU', flush=True)
    checks.check('sparse products in float32',
                 not torch.backends.cuda.matmul.allow_tf32
                 and torch.get_float32_matmul_precision() == 'highest',
                 f'allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, '
                 f'precision {torch.get_float32_matmul_precision()!r}')
    shape = (size,) * 3 + (1,)
    gpu = nt.layers.SpatiallySparse_Dense(
        shape, d, use_bias=True,
        generator=torch.Generator(device='cuda').manual_seed(0),
        device='cuda')
    cpu = nt.layers.SpatiallySparse_Dense(shape, d, use_bias=True,
                                          device='cpu')
    cpu.load_state_dict(gpu.state_dict())
    y, mask = sparse_inputs(size, 'cpu')
    rng = np.random.default_rng(2)
    r_enc = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32))
    r_dec = torch.from_numpy(rng.normal(size=(1, *shape)).astype(np.float32))

    def run(layer, device, inputs, weight):
        layer.zero_grad()
        leaf = inputs[0].to(device).detach().requires_grad_()
        out = layer([leaf] + [t.to(device) for t in inputs[1:]])
        (out * weight.to(device)).sum().backward()
        return [out.detach().cpu(), leaf.grad.cpu()] + [
            p.grad.cpu() for p in (layer.mult_kernel, layer.bias_kernel)]

    names = ('values', 'input grad', 'mult_kernel grad', 'bias_kernel grad')
    keep = sparse._ENCODE_CHUNK_ELEMS
    try:
        for branch, limit in (('one-shot', 1 << 62), ('chunked', 0)):
            sparse._ENCODE_CHUNK_ELEMS = limit
            got = run(gpu, 'cuda', (y, mask), r_enc)
            want = run(cpu, 'cpu', (y, mask), r_enc)
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            checks.check(f'sparse encode, {branch} branch, card vs CPU',
                         max(errs) <= 1e-5, ', '.join(
                             f'{n} {e:.3g}' for n, e in zip(names, errs))
                         + ' (max abs err over max, limit 1e-5)')
    finally:
        sparse._ENCODE_CHUNK_ELEMS = keep
    got = run(gpu, 'cuda', (x,), r_dec)
    want = run(cpu, 'cpu', (x,), r_dec)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    checks.check('sparse decode, card vs CPU', max(errs) <= 1e-5, ', '.join(
        f'{n} {e:.3g}' for n, e in zip(names, errs))
        + ' (max abs err over max, limit 1e-5)')

    # one step of the sparse VAE on each device, from the same weights
    # and the same sampling noise: the loss and every gradient. The sample
    # z = mu + exp(lv / 2) noise turns a relative rounding e of the encode
    # into e (1 + |lv| / 2) of z, and the benchmark's initial log-variance
    # grows with the volume (its largest about 48 at 32^3, 190 at 64^3 in
    # the JAX package, where exp(lv / 2) overflows): so the loss is held
    # to 1e-5 (1 + max |lv| / 2)
    for size, d in SPARSE_STEP_CHECKS:
        y, mask = sparse_inputs(size, 'cpu')
        models = {dev: SparseVAE(size, d, dev) for dev in ('cuda', 'cpu')}
        models['cpu'].load_state_dict(models['cuda'].state_dict())
        noise = torch.randn((1, d),
                            generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            lv_max = float(models['cpu'].logvar(
                models['cpu'].ssd([y, mask])).abs().max())
        res = {}
        for dev, model in models.items():
            yd, md = y.to(dev), mask.to(dev)
            loss = sparse_loss(md)(yd, model((yd, md), noise=noise.to(dev)))
            loss.backward()
            res[dev] = (float(loss.detach()),
                        {n: p.grad.cpu() for n, p in model.named_parameters()})
        (lg, gg), (lc, gc) = res['cuda'], res['cpu']
        rtol = 1e-5 * (1 + lv_max / 2)
        checks.check(f'sparse VAE f32 loss at {size}^3, d = {d}, card vs CPU',
                     abs(lg - lc) <= rtol * abs(lc),
                     f'card {lg!r} CPU {lc!r}, relative difference '
                     f'{abs(lg - lc) / abs(lc):.3g} (max |lv| {lv_max:.4g}, '
                     f'rtol {rtol:.3g})')
        worst = max(rel_err(gg[n], gc[n]) for n in gc)
        checks.check(f'sparse VAE f32 grads at {size}^3, card vs CPU',
                     worst <= 1e-4, f'{len(gc)} tensors, worst '
                     f'max|diff|/max|g| {worst:.3g} (limit 1e-4)')


def phase_sparse_train(checks):
    size, d = VOL, SPARSE_LATENT
    print(f'== 21. config #4 sparse VAE (SpatiallySparse_Dense, d = {d}, '
          f'D = {size}^3), f32, {TRAIN_STEPS} steps', flush=True)
    t0 = time.perf_counter()
    model = SparseVAE(size, d, 'cuda')
    y, mask = sparse_inputs(size, 'cuda')
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f'  parameters {n_par} (mult_kernel {size ** 3} x {d}); weights '
          f'and data made in {time.perf_counter() - t0:.3f} s', flush=True)
    # the initial weights' forward: the encode solves its masked normal
    # equations, A^T m (A z - y) = 0 with A = W^T, whose A z is the decode
    # of z; and the sampler's log-variance
    with torch.no_grad():
        z = model.ssd([y, mask])
        w = model.ssd.decode_matrix()
        normal = (mask * (model.ssd([z]) - y)).reshape(1, -1) @ w.T
        resid = float(normal.norm() / ((mask * y).reshape(1, -1) @ w.T).norm())
        lv = model.logvar(z)
        lv_max = float(lv.max())
        finite = bool(torch.isfinite(z).all() & torch.isfinite(lv).all())
        del w, normal
    checks.check('sparse VAE encode solves its normal equations',
                 finite and resid <= 1e-4,
                 f'latent and log-variance finite {finite}, |A^T m (A z - y)| '
                 f'/ |A^T m y| {resid:.3g} (limit 1e-4), max |z| '
                 f'{float(z.abs().max()):.4g}')
    # the sparse layer alone, encode then decode with the sampler left
    # out: its loss and gradients at full size from the initial weights
    rec = sparse_loss(mask)(y, model.ssd([model.ssd([y, mask])]))
    names, params = zip(*model.ssd.named_parameters())
    grads = torch.autograd.grad(rec, params)
    g_max = [float(g.abs().max()) for g in grads]
    rec = float(rec.detach())
    checks.check('sparse encode -> decode loss and gradients finite',
                 bool(np.isfinite(rec)) and all(np.isfinite(g_max)),
                 f'loss {rec:.6g}; largest |gradient| '
                 + ', '.join(f'{n} {g:.4g}' for n, g in zip(names, g_max)))
    del rec, grads
    # exp(lv / 2) overflows float32 past lv / 2 = ln(max float32): the loss
    # is then not finite, as the JAX package's is from 64^3 on, and every
    # step after the first runs on NaN weights. So step 1, from the initial
    # (finite) weights and a fresh Adam state, is timed apart, repeated
    overflow = lv_max / 2 > math.log(torch.finfo(torch.float32).max)
    step = training.make_train_step(sparse_loss(mask))
    gen = torch.Generator(device='cuda').manual_seed(9)
    batch = ((y, mask), y)
    init = [p.detach().clone() for p in model.parameters()]

    def fresh_state():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
        return training.create_train_state(model, training.adam(SPARSE_LR))

    firsts = []
    for _ in range(1 + SPARSE_FIRST_STEPS):
        _, first, times, _, _ = timed_steps(step, fresh_state(), (batch, gen),
                                            1)
        firsts.append(1e3 * times[0])
    step_ms = statistics.median(firsts[1:])
    print(f'  sparse VAE step 1 from the initial weights, from a fresh state '
          f'each time: ms ' + ' '.join(f'{t:.3f}' for t in firsts)
          + f'; median of the last {SPARSE_FIRST_STEPS} {step_ms:.3f} '
          f'({1e3 / step_ms:.3f} vol/s); its loss {first[0]:.6g}', flush=True)
    state = fresh_state()
    init.clear()
    state, losses, times, counts, peak = timed_steps(step, state,
                                                     (batch, gen))
    check_adam_counts(checks, 'sparse VAE', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)
    checks.check('sparse VAE first loss finite unless the sampler overflows',
                 bool(np.isfinite(losses[0])) != overflow,
                 f'max log-variance {lv_max:.4g} (exp(lv / 2) overflows '
                 f'{overflow}); losses ' + ' '.join(f'{v:.6g}' for v in losses))
    nan_steps = ' (NaN weights from step 2)' if overflow else ''
    report_steps('sparse VAE' + nan_steps, times, peak)
    flops = sparse_step_flops(size, d)
    # the bytes a step must move: the weights, their gradient and Adam's
    # two moments read, the weights and moments written
    nbytes = 7 * 4 * n_par
    bound, by = bound_ms(nbytes, flops)
    print(f'  step bound {bound:.3f} ms ({by}: {flops / 1e12:.4f} TFLOP, '
          f'{nbytes / 1e9:.3f} GB, at the float32 and HBM rates of '
          f'h100bench/peaks.json): step 1 at {bound / step_ms:.3f} of its '
          f'bound', flush=True)
    synced = no_host_sync(lambda: step(state, batch, gen))
    checks.check('sparse VAE step without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")
    try:
        report_profile('sparse VAE step' + nan_steps,
                       lambda i: step(state, batch, gen), TRAIN_STEPS)
    except Exception as e:  # noqa: BLE001  (a reading, not a check)
        print(f'  sparse VAE profile not measured: {type(e).__name__}: {e}')


def phase_s2d(checks):
    vol = S2D_CHECK_VOL
    print(f'== 22. flagship with space_to_depth=2: one f32 step at {vol}^3, '
          f'kernels vs plain; {TRAIN_STEPS} bf16 steps at {VOL}^3',
          flush=True)
    x, y = flagship_inputs(vol)
    plain_vs_kernels(
        checks, 'flagship s2d',
        lambda impl: (flagship(pool_impl=impl, vol=vol, space_to_depth=2),
                      nt.losses.SoftDice(check_input_limits=False,
                                         use_kernel=impl).loss),
        lambda: ((x, y), None),
        {'pool2_fwd': 3, 'pool2_bwd': 3, 'dice_sums': 1})
    x, y = flagship_inputs()
    model = flagship(torch.bfloat16, space_to_depth=2)
    state = training.create_train_state(model, training.adam(1e-3))
    step = training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)
    state, losses, times, counts, peak = timed_steps(step, state, ((x, y),))
    checks.check('flagship s2d losses finite', all(np.isfinite(losses)),
                 ' '.join(f'{v:.6f}' for v in losses))
    check_step_counts(checks, 'flagship s2d', counts,
                      {'pool2_fwd': 3, 'pool2_fwd_vec': 3, 'pool2_bwd': 3,
                       'dice_sums': 1, 'dice_sums_vec': 1}, TRAIN_STEPS)
    check_adam_counts(checks, 'flagship s2d', counts,
                      adam_per_step(state.optimizer), TRAIN_STEPS)
    report_steps('flagship s2d', times, peak)
    try:
        report_profile('flagship s2d step',
                       lambda i: step(state, (x, y)), TRAIN_STEPS)
    except Exception as e:  # noqa: BLE001  (a reading, not a check)
        print(f'  flagship s2d profile not measured: {type(e).__name__}: {e}')


def state_tensors(state):
    """Every parameter, buffer and optimizer tensor of a state, by name."""
    out = {f'model/{k}': v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()['state'].items():
        out.update({f'opt/{i}/{k}': v for k, v in st.items()})
    return out


def phase_remat(checks):
    print(f'== 23. flagship with remat=True at {VOL}^3: f32 step vs '
          f'remat=False, {TRAIN_STEPS} bf16 steps, checkpoints, the checked '
          f'step', flush=True)
    x, y = flagship_inputs()
    flags = exact_f32()
    try:
        runs = {}
        for remat in (False, True):
            model = flagship(remat=remat)
            state = training.create_train_state(model, training.adam(1e-3))
            step = training.make_train_step(
                nt.losses.SoftDice(check_input_limits=False).loss)
            state, m = step(state, (x, y))
            runs[remat] = (float(m['loss']),
                           {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()})
            del model, state
    finally:
        restore_flags(flags)
    (l0, g0), (l1, g1) = runs[False], runs[True]
    worst = max(float((g1[n] - g0[n]).abs().max() / g0[n].abs().max())
                for n in g0)
    checks.check('flagship remat f32 loss', abs(l1 - l0) <= 1e-6 * abs(l0),
                 f'remat {l1!r} no remat {l0!r} (rtol 1e-6)')
    checks.check('flagship remat f32 grads', worst <= 1e-6,
                 f'{len(g0)} tensors, largest max|diff|/max|g| {worst:.3g} '
                 f'(limit 1e-6); all equal '
                 f'{all(torch.equal(g1[n], g0[n]) for n in g0)}')

    # the pools sit inside the recomputed encoder, as in JAX: K1 runs in
    # the forward pass and again in the recomputation
    loss_fn = nt.losses.SoftDice(check_input_limits=False).loss
    step = training.make_train_step(loss_fn)
    peaks, ms = {}, {}
    for remat in (False, True):
        state = training.create_train_state(
            flagship(torch.bfloat16, remat=remat), training.adam(1e-3))
        state, losses, times, counts, peaks[remat] = timed_steps(
            step, state, ((x, y),))
        label = 'flagship remat' if remat else 'flagship no remat'
        checks.check(f'{label} losses finite', all(np.isfinite(losses)),
                     ' '.join(f'{v:.6f}' for v in losses))
        ms[remat] = report_steps(label, times, peaks[remat])
        if remat:
            check_step_counts(checks, label, counts,
                              {'pool2_fwd': 6, 'pool2_fwd_vec': 6,
                               'pool2_bwd': 3, 'dice_sums': 1,
                               'dice_sums_vec': 1}, TRAIN_STEPS)
            check_adam_counts(checks, label, counts,
                              adam_per_step(state.optimizer), TRAIN_STEPS)
            try:
                report_profile('flagship remat step',
                               lambda i: step(state, (x, y)), TRAIN_STEPS)
            except Exception as e:  # noqa: BLE001  (a reading, not a check)
                print(f'  flagship remat profile not measured: '
                      f'{type(e).__name__}: {e}')
        del state
    checks.check('remat peak memory below no remat', peaks[True] < peaks[False],
                 f'{peaks[True]} B against {peaks[False]} B '
                 f'({peaks[True] / peaks[False]:.4f}); step ms '
                 f'{ms[True]:.3f} against {ms[False]:.3f}')

    # checkpoints on the card: 2 steps, save, restore into a fresh state
    # (other weights), 2 steps == 4 steps (deterministic cuDNN)
    flags = exact_f32()
    try:
        def fresh(seed):
            return training.create_train_state(
                flagship(torch.bfloat16, seed=seed, remat=True),
                training.adam(1e-3))
        ref, *_ = timed_steps(step, fresh(0), ((x, y),), 4)
        run, *_ = timed_steps(step, fresh(0), ((x, y),), 2)
        with tempfile.TemporaryDirectory() as tmp:
            training.save_checkpoint(tmp, run, extra={'next_step': 2})
            run, extra = training.restore_checkpoint(tmp, fresh(1))
        run, *_ = timed_steps(step, run, ((x, y),), 2)
    finally:
        restore_flags(flags)
    want, got = state_tensors(ref), state_tensors(run)
    same = [k for k in want if torch.equal(got[k].cpu(), want[k].cpu())]
    checks.check('checkpoint round trip on the card',
                 len(same) == len(want) == len(got) and extra == {
                     'next_step': 2} and run.step == ref.step == 4,
                 f'{len(same)} of {len(want)} tensors bit-equal to 4 steps '
                 f'without a save, extra {extra}, step {run.step}')
    del ref, run

    # the checked step: no host read inside; err.throw() is the one
    checked = training.make_checked_train_step(
        nt.losses.SoftDice(check_input_limits='checkify').loss)
    state = fresh(0)
    out = []
    synced = no_host_sync(lambda: out.append(checked(state, (x, y))))
    checks.check('checked step without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")
    msg = out[0][0].get() if out else 'not run'
    checks.check('checked step, clean: no error', msg is None, f'{msg}')
    err, _ = checked(state, (x, y * 2))
    try:
        err.throw()
        raised = 'nothing'
    except nt.checkify.CheckError as e:
        raised = str(e)
    want = 'y_true: value outside range [0.0, 1.0] (`check` failed)'
    checks.check('checked step, Dice input scaled by 2: throw() raises',
                 raised == want, f'raised {raised!r}')
    # the gradient and parameter checks' flags, one fused reduction
    t = [torch.tensor(v, device='cuda') for v in (
        [1., float('nan')], [float('inf')] * 3, [-float('inf')],
        [3e38] * 1000, [0.] * 4099)]
    flags = {str(dtype)[6:]: training._all_finite([v.to(dtype) for v in t])
             .tolist() for dtype in (torch.float32, torch.bfloat16)}
    want = [False, False, False, True, True]
    checks.check('checked step finite flags on the card',
                 all(f == want for f in flags.values()),
                 f'{flags} (NaN, inf, -inf, 3e38, zeros)')


def serve_volume(size, seed=0):
    """A [size^3, 1] float32 volume from default_rng(seed), on the host."""
    return np.random.default_rng(seed).normal(
        size=(size,) * 3 + (1,)).astype(np.float32)


def phase_serve(checks):
    vol_shape, psize = (SERVE_VOL,) * 3, (SERVE_PATCH,) * 3
    grid = tiling.grid_size(vol_shape, psize, SERVE_STRIDE)
    n_patches = math.prod(grid)
    print(f'== 24. serve: the bf16 flagship over a {SERVE_VOL}^3 volume in '
          f'{n_patches} patches of {SERVE_PATCH}^3 (stride {SERVE_STRIDE}), '
          f'on the card (predict_volume_device) and host-driven '
          f'(predict_volumes)', flush=True)
    host_vol = serve_volume(SERVE_VOL)
    vol = torch.from_numpy(host_vol).cuda()
    model = flagship(torch.bfloat16, vol=SERVE_PATCH).eval()

    def run(m=model):
        return seg.predict_volume_device(m, vol, psize, stride=SERVE_STRIDE,
                                         agg='mean')

    out = run()   # warm-up
    torch.cuda.synchronize()
    _build.launches.clear()
    out = run()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    per_vol = 3 * n_patches
    check_step_counts(checks, 'serve', counts,
                      {'pool2_fwd': per_vol, 'pool2_fwd_vec': per_vol}, 1,
                      'volume')
    checks.check('serve launches nothing else', set(counts) == {
        'pool2_fwd', 'pool2_fwd_vec'}, f'{counts}')
    sums = (out.float().sum(-1) - 1).abs().max()
    checks.check('serve prediction',
                 tuple(out.shape) == vol_shape + (NB_LABELS,)
                 and out.dtype == torch.bfloat16
                 and bool(torch.isfinite(out).all()) and float(sums) < 2e-2,
                 f'{tuple(out.shape)} {out.dtype}, max |sum - 1| '
                 f'{float(sums):.3g} (limit 2e-2: bf16 softmaxes averaged '
                 f'in bf16)')
    synced = no_host_sync(run)
    checks.check('serve volume without host sync', not synced,
                 synced or "sync debug mode 'error' raised nothing")

    # the plain pool on the card gives the kernel route's bits
    plain = flagship(torch.bfloat16, pool_impl='plain', vol=SERVE_PATCH).eval()
    _build.launches.clear()
    out_plain = run(m=plain)
    torch.cuda.synchronize()
    checks.check('serve kernel route == pool_impl plain, bit for bit',
                 bit_equal(out, out_plain) and not _build.launches,
                 f'max abs diff {max_abs_err(out, out_plain):.3g}; plain '
                 f'launches {dict(_build.launches)}')
    del plain, out_plain

    # with stride = patch size, quilt_device o patch_gen is the identity
    patches = torch.stack(list(tiling.patch_gen(vol, psize)))
    back = tiling.quilt_device(patches, psize, vol_shape)
    checks.check('quilt_device of patch_gen (stride = patch) is identity',
                 bit_equal(back, vol), f'{len(patches)} patches')
    del patches, back

    # quilt_device in f32 against the host quilt of the same predictions
    with torch.inference_mode():
        preds = torch.stack([
            model(p[None])[0].float()
            for p in tiling.patch_gen(vol, psize, SERVE_STRIDE)])
    dev = tiling.quilt_device(preds, psize, vol_shape, SERVE_STRIDE)
    host = np.stack([tiling.quilt(preds[..., c].cpu().numpy(), psize,
                                  vol_shape, SERVE_STRIDE, agg='mean')
                     for c in range(NB_LABELS)], -1)
    err = rel_err(dev.double().cpu(), torch.from_numpy(host))
    checks.check('serve quilt_device f32 vs host quilt mean', err <= 1e-6,
                 f'max |diff| / max |host| {err:.3g} (limit 1e-6)')
    # bf16 adds of up to 8 values in [0, 1], each off by half an ulp of its
    # partial sum, then a bf16 division: within 2^-6 (tests/test_torch_seg.py)
    bf16_err = rel_err(out.double().cpu(), torch.from_numpy(host))
    checks.check('serve bf16 accumulation vs the host quilt in float64',
                 bf16_err <= 2 ** -6,
                 f'max |diff| / max |host| {bf16_err:.3g} (limit 2^-6)')
    del preds, dev

    # route (b): host-driven, one patch at a time to the card, host quilt
    def patch_batches():
        for p in tiling.patch_gen(host_vol, psize, SERVE_STRIDE):
            yield torch.from_numpy(np.ascontiguousarray(p[None])).cuda()

    quilt_s = []
    host_quilt = tiling.quilt

    def timed_quilt(*a, **k):
        t0 = time.perf_counter()
        try:
            return host_quilt(*a, **k)
        finally:
            quilt_s.append(time.perf_counter() - t0)

    seg.tiling.quilt = timed_quilt
    try:
        t0 = time.perf_counter()
        labels, true = seg.predict_volumes(
            model, patch_batches(), 1, psize, SERVE_STRIDE, vol_shape,
            nan_func='nanmedian', device='cuda')
        wall = time.perf_counter() - t0
    finally:
        seg.tiling.quilt = host_quilt
    print(f'  serve host-driven (predict_volumes, nanmedian): wall '
          f'{wall:.3f} s once, of it the host quilt {sum(quilt_s):.3f} s '
          f'({sum(quilt_s) / wall:.4f})', flush=True)
    checks.check('serve host-driven labels',
                 labels.shape == vol_shape and true is None
                 and bool(np.isfinite(labels).all())
                 and labels.min() >= 0 and labels.max() < NB_LABELS,
                 f'{labels.shape}, range [{labels.min()}, {labels.max()}]')
    agree = float((labels == out.float().argmax(-1).cpu().numpy()).mean())
    print(f'  the host nan-median labels equal the card route\'s argmax at '
          f'{agree:.4f} of the voxels (another aggregation)')
    del out, vol, model

    # the card against the plain CPU path at a small size, f32
    size, patch, stride = SERVE_CHECK
    small = serve_volume(size, seed=1)
    flags = exact_f32()
    try:
        outs = {}
        for device in ('cuda', 'cpu'):
            m = nt.models.unet(
                nb_features=16, input_shape=(patch,) * 3 + (1,), nb_levels=2,
                conv_size=3, nb_labels=NB_LABELS, feat_mult=2,
                nb_conv_per_level=2, generator=torch.Generator().manual_seed(0),
                device=device)
            outs[device] = seg.predict_volume_device(
                m, torch.from_numpy(small).to(device), (patch,) * 3, stride)
    finally:
        restore_flags(flags)
    err = rel_err(outs['cuda'].cpu(), outs['cpu'])
    checks.check(f'serve at {size}^3 ({patch}^3 patches, stride {stride}), '
                 f'card vs CPU', err <= 1e-5,
                 f'max |diff| / max |cpu| {err:.3g} (limit 1e-5)')


def cce(y_true, y_pred):
    return -(y_true * torch.log(y_pred)).sum(-1).mean()


def phase_classify(checks):
    vol = CLASSIFY_VOL
    print(f'== 25. EncoderNet step at {vol}^3, HyperConv3D and the stream '
          f'layers, card vs CPU', flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, vol, vol, vol, 1)).astype(
        np.float32))
    y = torch.eye(2)[[1]]
    flags = exact_f32()
    try:
        runs = {}
        for device in ('cuda', 'cpu'):
            model = nt.models.EncoderNet(
                nb_features=16, input_shape=(vol,) * 3 + (1,), nb_levels=4,
                conv_size=3, feat_mult=2, nb_labels=2,
                generator=torch.Generator().manual_seed(0), device=device)
            state = training.create_train_state(model, training.adam(1e-3))
            _build.launches.clear()
            state, m = training.make_train_step(cce)(
                state, (x.to(device), y.to(device)))
            runs[device] = (float(m['loss']), dict(_build.launches),
                            {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()})
            if device == 'cuda':
                want = adam_per_step(state.optimizer)
            del model, state
    finally:
        restore_flags(flags)
    (lk, counts, gk), (lc, cpu_counts, gc) = runs['cuda'], runs['cpu']
    check_step_counts(checks, 'classify', counts,
                      {'pool2_fwd': 3, 'pool2_fwd_vec': 3, 'pool2_bwd': 3}, 1)
    check_adam_counts(checks, 'classify', counts, want, 1)
    checks.check('EncoderNet f32 loss, card vs CPU',
                 abs(lk - lc) <= 1e-5 * abs(lc) and not cpu_counts,
                 f'card {lk!r} CPU {lc!r} (rtol 1e-5)')
    worst = max(rel_err(gk[n], gc[n]) for n in gc)
    checks.check('EncoderNet f32 grads, card vs CPU', worst <= 1e-4,
                 f'{len(gc)} tensors, worst max|diff|/max|g| {worst:.3g} '
                 f'(limit 1e-4)')

    # HyperConv3D: per-sample kernels, stride 2, 'same' (XLA's pads)
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((2, 32, 31, 30, 4), (2, 3, 2, 3, 4, 8), (2, 8))]
    layer = nt.layers.HyperConv3D(8, (3, 2, 3), strides=2, padding='same',
                                  activation='elu')
    w = torch.from_numpy(rng.normal(size=(2, 16, 16, 15, 8)).astype(
        np.float32))
    flags = exact_f32()
    try:
        outs = {}
        for device in ('cuda', 'cpu'):
            ts = [torch.from_numpy(a).to(device).requires_grad_()
                  for a in arrays]
            out = layer(ts)
            (out * w.to(device)).sum().backward()
            outs[device] = [out.detach().cpu()] + [t.grad.cpu() for t in ts]
    finally:
        restore_flags(flags)
    errs = [rel_err(a, b) for a, b in zip(outs['cuda'], outs['cpu'])]
    checks.check('HyperConv3D forward and gradients, card vs CPU',
                 errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4,
                 f'output {errs[0]:.3g} (limit 1e-5); d x, d kernel, d bias '
                 + ', '.join(f'{e:.3g}' for e in errs[1:]) + ' (limit 1e-4)')

    # MeanStream / CovStream over 5 batches
    flags = exact_f32()
    try:
        for name in ('MeanStream', 'CovStream'):
            layers = {d: getattr(nt.layers, name)((8, 8), cap=6, device=d)
                      for d in ('cuda', 'cpu')}
            worst = 0.
            for i, b in enumerate(STREAM_BATCHES):
                xb = torch.from_numpy(np.random.default_rng(10 + i).normal(
                    size=(b, 8, 8)).astype(np.float32))
                outs = {d: l(xb.to(d), training=True).cpu()
                        for d, l in layers.items()}
                worst = max(worst, rel_err(outs['cuda'], outs['cpu']))
                for buf, t in layers['cpu'].named_buffers():
                    worst = max(worst, rel_err(
                        getattr(layers['cuda'], buf).cpu(), t))
            outs = {d: l(xb.to(d)).cpu() for d, l in layers.items()}
            worst = max(worst, rel_err(outs['cuda'], outs['cpu']))
            checks.check(f'{name} over {len(STREAM_BATCHES)} batches, card '
                         f'vs CPU', worst <= 1e-5,
                         f'outputs and statistics, worst {worst:.3g} '
                         f'(limit 1e-5)')
    finally:
        restore_flags(flags)


def write_subjects(root, n=DISK_SUBJECTS, vol=DISK_VOL):
    """n FreeSurfer-style subjects under root/norm and root/aseg: a uint8
    `norm.mgz` and an int32 `aseg.mgz` of labels DISK_LABELS, vol^3 each,
    drawn in turn from default_rng(0), written by the port's
    `io.save_volfile` (gzip level 9, as FreeSurfer's .mgz: about 25 s a
    label volume, so the files are written by a thread each, zlib releasing
    the interpreter's lock); returns the two directories."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(0)
    dirs = [os.path.join(root, d) for d in ('norm', 'aseg')]
    for d in dirs:
        os.makedirs(d)
    files = []
    for i in range(n):
        files.append((os.path.join(dirs[0], f'subj{i:02d}_norm.mgz'),
                      rng.integers(0, 256, size=(vol,) * 3, dtype=np.uint8)))
        files.append((os.path.join(dirs[1], f'subj{i:02d}_aseg.mgz'),
                      rng.choice(DISK_LABELS, size=(vol,) * 3)
                      .astype(np.int32)))
    with ThreadPoolExecutor(max_workers=2 * n) as pool:
        for f in [pool.submit(nt.io.save_volfile, *a) for a in files]:
            f.result()
    return dirs


def disk_feed(norm, aseg):
    """The reference's generator as users call it: (x [1, 128^3, 1], y [1,
    128^3, 4] one-hot), both float16, from the 160^3 subjects."""
    return nt.generators.vol_seg(
        norm, aseg, ext='.mgz',
        proc_vol_fn=lambda v: nt.dataproc.vol_proc(v, crop=DISK_CROP,
                                                   rescale=1 / 255),
        proc_seg_fn=lambda s: nt.dataproc.volcrop(s, DISK_CROP),
        relabel=DISK_LABELS, nb_labels_reshape=NB_LABELS)


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == 'prefetch_to_device' and t.is_alive()]


class StepLog:
    """fit's callback: the loss and the wall time of each step (fit reads
    the loss, which synchronises), and a check run after each step."""

    def __init__(self, after_step=None):
        self.losses, self.times = [], []
        self.after_step = after_step

    def on_batch_end(self, i, state, logs):
        self.losses.append(logs['loss'])
        self.times.append(logs['time'])
        if self.after_step is not None:
            self.after_step(i)


def disk_step():
    model = flagship(dtype=torch.bfloat16)
    state = training.create_train_state(model, training.adam(1e-3))
    return state, training.make_train_step(
        nt.losses.SoftDice(check_input_limits=False).loss)


def phase_disk(checks):
    from neurite_tpu_torch.io import native
    print(f'== 26. the flagship from disk: {DISK_SUBJECTS} subjects of '
          f'{DISK_VOL}^3 .mgz -> generators.vol_seg -> prefetch_to_device -> '
          f'training.fit (bf16, {VOL}^3 crops)', flush=True)
    t0 = time.perf_counter()
    native.library()
    print(f'  host ops: {native.SO} ready in {time.perf_counter() - t0:.3f} s '
          f'(g++ at first use)')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        norm, aseg = write_subjects(tmp)
        mib = sum(os.path.getsize(os.path.join(d, f)) for d in (norm, aseg)
                  for f in os.listdir(d)) / 2 ** 20
        print(f'  set-up: wrote {2 * DISK_SUBJECTS} .mgz files ({mib:.1f} MiB) '
              f'in {time.perf_counter() - t0:.3f} s (untimed)', flush=True)

        # the generator alone on the host: no card, no prefetch
        calls = []
        lib_of = native.library
        native.library = lambda: calls.append(1) or lib_of()
        try:
            gen = disk_feed(norm, aseg)
            next(gen)
            host_ms = []
            for _ in range(DISK_HOST_BATCHES):
                t0 = time.perf_counter()
                x_h, y_h = next(gen)
                host_ms.append(1e3 * (time.perf_counter() - t0))
            gen.close()
        finally:
            native.library = lib_of
        checks.check('disk batch shapes',
                     x_h.shape == (1, VOL, VOL, VOL, 1)
                     and y_h.shape == (1, VOL, VOL, VOL, NB_LABELS)
                     and x_h.dtype == y_h.dtype == np.float16
                     and bool((y_h.sum(-1) == 1).all()),
                     f'x {x_h.dtype}{x_h.shape}, y {y_h.dtype}{y_h.shape}')
        lib = native._lib
        checks.check('disk feed ran the native host ops',
                     bool(calls) and lib is not None
                     and lib._name == native.SO
                     and os.path.dirname(native.SO) == _build.BUILD_DIR
                     and os.path.getmtime(native.SO)
                     >= os.path.getmtime(native.SRC),
                     f'{len(calls)} native calls, library '
                     f'{getattr(lib, "_name", None)}')
        print(f'  generator on the host alone: '
              f'{statistics.median(host_ms):.3f} ms a batch (median of '
              f'{DISK_HOST_BATCHES}; all: '
              + ' '.join(f'{t:.1f}' for t in host_ms) + ')', flush=True)

        # H2D of one batch on a copy stream, from pinned memory
        stream = torch.cuda.Stream()
        pinned = [torch.from_numpy(a).pin_memory() for a in (x_h, y_h)]
        h2d = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.cuda.stream(stream):
                a.record(stream)
                dev = [p.to('cuda', non_blocking=True) for p in pinned]
                b.record(stream)
            b.synchronize()
            h2d.append(a.elapsed_time(b))
        nbytes = x_h.nbytes + y_h.nbytes
        print(f'  H2D a batch ({nbytes / 2 ** 20:.0f} MiB, pinned, copy '
              f'stream): {statistics.median(h2d[1:]):.4f} ms (median of 4 '
              f'after one), {nbytes / statistics.median(h2d[1:]) / 1e6:.1f} '
              f'GB/s', flush=True)
        del pinned, dev

        # a checked run: each consumed device batch against its host copy,
        # after its step; the losses against synchronous puts of the same
        # host batches, bit for bit (deterministic cuDNN for both)
        flags = exact_f32()
        try:
            host, device = [], []

            def keep(it):
                for batch in it:
                    host.append(tuple(a.copy() for a in batch))
                    yield batch

            def consume(it):
                for batch in it:
                    device.append(batch)
                    yield batch

            bad = []

            def compare(i):
                x, y = device[i]
                if not (x.is_cuda and y.is_cuda
                        and bit_equal(x.cpu(), torch.from_numpy(host[i][0]))
                        and bit_equal(y.cpu(), torch.from_numpy(host[i][1]))):
                    bad.append(i)
                device[i] = None

            state, step = disk_step()
            feed = nt.generators.prefetch_to_device(
                keep(disk_feed(norm, aseg)), size=2)
            log = StepLog(compare)
            training.fit(state, step, consume(feed), DISK_CHECK_STEPS,
                         callbacks=[log])
            feed.close()
            checks.check('disk batches bit-equal to their host copies',
                         not bad and len(device) == DISK_CHECK_STEPS,
                         f'{len(device)} consumed, mismatched steps {bad}')
            checks.check('disk producer thread ended after close',
                         not prefetch_threads(),
                         f'{len(prefetch_threads())} alive')
            state, step = disk_step()
            sync = StepLog()
            training.fit(state, step,
                         iter([tuple(torch.from_numpy(a).to('cuda')
                                     for a in b) for b in host]),
                         DISK_CHECK_STEPS, callbacks=[sync])
            checks.check('disk step-0 loss == a synchronous put\'s',
                         log.losses[0] == sync.losses[0],
                         f'prefetched {log.losses[0]!r} sync '
                         f'{sync.losses[0]!r}')
            checks.check('disk losses == synchronous puts\' (deterministic '
                         'cuDNN)', log.losses == sync.losses,
                         ' '.join(f'{v:.6f}' for v in log.losses))
        finally:
            restore_flags(flags)

        # a timed run of 10 steps from disk: launches, step ms, peak memory
        state, step = disk_step()
        feed = nt.generators.prefetch_to_device(disk_feed(norm, aseg), size=2)
        log = StepLog()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        training.fit(state, step, feed, TRAIN_STEPS, callbacks=[log])
        counts = dict(_build.launches)
        peak = torch.cuda.max_memory_allocated()
        checks.check('disk losses finite', all(np.isfinite(log.losses)),
                     ' '.join(f'{v:.6f}' for v in log.losses))
        check_step_counts(checks, 'disk', counts,
                          {'pool2_fwd': 3, 'pool2_fwd_vec': 3,
                           'pool2_bwd': 3, 'dice_sums': 1,
                           'dice_sums_vec': 1, 'adam': 1, 'adam_vec': 1},
                          TRAIN_STEPS)
        others = sorted(set(counts) - {'pool2_fwd', 'pool2_fwd_vec',
                                       'pool2_bwd', 'dice_sums',
                                       'dice_sums_vec', 'adam', 'adam_vec'})
        checks.check('disk runs no other kernel', not others,
                     f'other launches: {others}')
        times = np.diff([0.] + log.times).tolist()
        disk_ms = report_steps('flagship from disk', times, peak)
        try:
            idle = report_profile('flagship step from disk',
                                  lambda i: step(state, next(feed)),
                                  TRAIN_STEPS)
        except Exception as e:  # noqa: BLE001  (a reading, not a check)
            print(f'  disk profile not measured: {type(e).__name__}: {e}')
            idle = None
        feed.close()
        checks.check('disk producer thread ended after the timed run',
                     not prefetch_threads(),
                     f'{len(prefetch_threads())} alive')

        # the same model and step on one resident batch (phase 6's feed)
        x, y = (torch.from_numpy(a).cuda() for a in (x_h, y_h))
        state, losses, times, _, _ = timed_steps(step, state, ((x, y),))
        mem_ms = report_steps('flagship in memory (same call)', times, peak)
        print(f'  disk: step {disk_ms:.3f} ms from disk vs {mem_ms:.3f} in '
              f'memory; generator {statistics.median(host_ms):.3f} ms a '
              f'batch on the host; H2D {statistics.median(h2d[1:]):.4f} ms; '
              f'idle share {idle if idle is None else round(idle, 4)}; peak '
              f'{peak / 2 ** 30:.3f} GiB', flush=True)


def phase_feed(checks):
    print(f'== 27. the threaded feed: {FEED_VOLS} volumes of {VOL}^3 f32 '
          f'.npz -> VolumeDataset.batches(num_workers={FEED_WORKERS}) -> '
          f'prefetch_to_device', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for i in range(FEED_VOLS):
            np.savez_compressed(os.path.join(tmp, f'v{i:02d}.npz'),
                                vol_data=rng.normal(size=(VOL,) * 3)
                                .astype(np.float32))
        print(f'  set-up: {FEED_VOLS} .npz in {time.perf_counter() - t0:.3f} '
              f's (untimed)')
        ds = nt.generators.VolumeDataset(tmp, ext='.npz')
        it = ds.batches(1, num_workers=FEED_WORKERS)
        first = next(it)      # warm: the pool's threads start
        t0 = time.perf_counter()
        for _, _b in zip(range(FEED_BATCHES), it):
            pass
        host_vps = FEED_BATCHES / (time.perf_counter() - t0)
        it.close()
        xb = np.asarray(first, np.float32)
        rates = {}
        for name, put in (
                ('pinned (prefetch_to_device\'s copy)',
                 lambda: nt.generators.to_device(xb, 'cuda')),
                ('pageable (torch.from_numpy(b).to(cuda))',
                 lambda: torch.from_numpy(xb).to('cuda'))):
            put()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FEED_PUTS):
                d = put()
                torch.cuda.synchronize()
            rates[name] = xb.nbytes * FEED_PUTS / (time.perf_counter() - t0) / 1e6
            del d
        print(f'  feed host_vols_per_sec {host_vps:.3f} ({FEED_BATCHES} '
              f'batches of [1, {VOL}^3] after one, {FEED_WORKERS} workers)')
        for name, mbps in rates.items():
            print(f'  feed put_mbps {name}: {mbps:.1f} MB/s '
                  f'({xb.nbytes / 2 ** 20:.0f} MiB x {FEED_PUTS}, each ended '
                  f'by a synchronise)', flush=True)
        serial = list(ds.batches(1, epochs=1))
        feed = nt.generators.prefetch_to_device(
            ds.batches(1, epochs=1, num_workers=FEED_WORKERS), size=2)
        got = list(feed)
        ok = len(got) == len(serial) == FEED_VOLS and all(
            g.is_cuda and bit_equal(g.cpu(), torch.from_numpy(s))
            for g, s in zip(got, serial))
        checks.check('feed prefetched batches == the serial batches, in order',
                      ok, f'{len(got)} batches (expected {FEED_VOLS})')
        checks.check('feed producer thread ended', not prefetch_threads(),
                     f'{len(prefetch_threads())} alive')


###############################################################################
# phases 28 and 29: ranks on the one card (torch.distributed)
###############################################################################

def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, outdir, fn, args):
    """One spawned rank: the card, a process group of `world` over a
    localhost port, fn(rank, world, outdir, *args) whose JSON result goes
    to outdir/rank<r>.json. Anything it raises ends the rank non-zero."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f'tcp://localhost:{port}',
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(rank, world, outdir, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)


def spawn_ranks(fn, world, backend, outdir, *args):
    """fn on `world` ranks started by torch.multiprocessing (spawn: CUDA
    needs it), each loading the kernels phase 2 built; joins them (a rank
    that fails raises here, after the others are ended) and returns their
    results in rank order."""
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(world, free_port(), backend, outdir, fn, args),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(outdir, f'rank{r}.json')) as f:
            out.append(json.load(f))
    return out


def wall_ms(fn, reps=5, warmup=2):
    """Median host ms of fn() calls each ended by a synchronise: the time a
    rank's op takes with its exchanges through the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def dp_batch(bs=DP_RANKS, vol=VOL):
    """The global batch of the DP phase: bench.py's draws for `bs` items."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(bs, vol, vol, vol, 1)).astype(np.float32)
    lab = rng.integers(0, NB_LABELS, size=(bs, vol, vol, vol))
    return x, np.eye(NB_LABELS, dtype=np.float32)[lab]


def dice_loss():
    return nt.losses.SoftDice(check_input_limits=False).loss


def dp_rank(rank, world, outdir):
    """Phase 28 (b) on one rank of a 'data' mesh of `world` under gloo."""
    import torch.distributed as dist
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=world, device='cuda')
    x, y = dp_batch(world)
    batch = parallel.shard_batch((x, y), mesh, space_axis=None)
    out = {'backend': dist.get_backend(mesh.get_group('data'))}
    flags = exact_f32()
    try:
        state = training.create_train_state(flagship(), training.adam(1e-3))
        step = parallel.make_sharded_train_step(
            training.make_train_step(dice_loss()), mesh, space_axis=None)
        state, m = step(state, batch,
                        torch.Generator(device='cuda').manual_seed(1))
        out['f32_loss'] = float(m['loss'])
        torch.save({'grads': {n: p.grad.cpu() for n, p in
                              state.model.named_parameters()},
                    'params': {n: p.detach().cpu() for n, p in
                               state.model.named_parameters()}},
                   os.path.join(outdir, f'rank{rank}.pt'))
        del state, step
    finally:
        restore_flags(flags)

    state = training.create_train_state(flagship(dtype=torch.bfloat16),
                                        training.adam(1e-3))
    step = parallel.make_sharded_train_step(
        training.make_train_step(dice_loss()), mesh, space_axis=None)
    gen = torch.Generator(device='cuda').manual_seed(1)
    state, losses, times, counts, peak = timed_steps(step, state,
                                                     (batch, gen))
    # the all-reduce of a step alone: the same f32 gradient buffer, the
    # same group, timed as the step is
    flat = torch.cat([p.grad.reshape(-1) for p in state.model.parameters()])
    group = mesh.get_group('data')
    ar_ms = wall_ms(lambda: dist.all_reduce(flat, group=group), reps=10)
    out.update(losses=losses, step_ms=1e3 * statistics.median(
        times[WARMUP_STEPS:]), times=times, counts=counts, peak=peak,
        allreduce_ms=ar_ms, allreduce_bytes=flat.numel() * flat.element_size(),
        adam=adam_per_step(state.optimizer))
    return out


def dp_reference():
    """The single-process f32 step on the global batch: loss, gradients and
    parameters after it (TF32 off, deterministic cuDNN)."""
    x, y = dp_batch()
    flags = exact_f32()
    try:
        state = training.create_train_state(flagship(), training.adam(1e-3))
        step = training.make_train_step(dice_loss())
        state, m = step(state, (torch.from_numpy(x).cuda(),
                                torch.from_numpy(y).cuda()),
                        torch.Generator(device='cuda').manual_seed(1))
        return (float(m['loss']),
                {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                {n: p.detach().cpu() for n, p in
                 state.model.named_parameters()})
    finally:
        restore_flags(flags)


def dp_one_rank_nccl(checks):
    """Phase 28 (a): in this process, a 1 x 1 mesh over a 1-rank NCCL
    group; 3 sharded steps against 3 plain steps from the same weights."""
    import torch.distributed as dist
    from neurite_tpu_torch import parallel
    x, y = flagship_inputs()
    runs = {}
    flags = exact_f32()
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        mesh = parallel.create_mesh(data=1, device='cuda')
        backend = dist.get_backend(mesh.get_group('data'))
        for kind in ('plain', 'sharded'):
            state = training.create_train_state(flagship(),
                                                training.adam(1e-3))
            step = training.make_train_step(dice_loss())
            if kind == 'sharded':
                step = parallel.make_sharded_train_step(step, mesh,
                                                        space_axis=None)
            batch = ((x, y) if kind == 'plain' else
                     parallel.shard_batch((x, y), mesh, space_axis=None))
            losses = []
            for i in range(3):
                state, m = step(state, batch,
                                torch.Generator(device='cuda').manual_seed(i))
                losses.append(m['loss'].detach().clone())
            runs[kind] = (losses, [p.detach().clone()
                                   for p in state.model.parameters()])
            del state
    finally:
        dist.destroy_process_group()
        restore_flags(flags)
    (lp, pp), (ls, ps) = runs['plain'], runs['sharded']
    checks.check('dp 1x1 nccl mesh: losses bit-equal to the plain step',
                 all(bit_equal(a, b) for a, b in zip(lp, ls)),
                 f'backend {backend}; plain {[float(v) for v in lp]} '
                 f'sharded {[float(v) for v in ls]}')
    checks.check('dp 1x1 nccl mesh: parameters bit-equal after 3 steps',
                 all(bit_equal(a, b) for a, b in zip(pp, ps)),
                 f'{len(pp)} tensors')


def phase_dp(checks, card):
    print(f'== 28. data-parallel flagship ({card})', flush=True)
    dp_one_rank_nccl(checks)
    ref_loss, ref_grads, ref_params = dp_reference()
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(dp_rank, DP_RANKS, 'gloo', d)
        saved = [torch.load(os.path.join(d, f'rank{r}.pt'))
                 for r in range(DP_RANKS)]
    per_step = {'pool2_fwd': 3, 'pool2_bwd': 3, 'dice_sums': 1}
    for r, (out, s) in enumerate(zip(ranks, saved)):
        tag = f'dp rank {r}/{DP_RANKS} ({out["backend"]})'
        checks.check(f'{tag} f32 loss vs the global-batch step',
                     abs(out['f32_loss'] - ref_loss) <= 1e-5 * abs(ref_loss),
                     f'rank {out["f32_loss"]!r} global {ref_loss!r} '
                     f'(rtol 1e-5)')
        worst = max(float((s['grads'][n] - g).abs().max() / g.abs().max())
                    for n, g in ref_grads.items())
        checks.check(f'{tag} averaged grads vs the global-batch step',
                     worst <= 1e-4, f'{len(ref_grads)} tensors, worst '
                     f'max|diff|/max|g| {worst:.3g} (limit 1e-4)')
        # Adam's first update is lr * g / (|g| + eps), about lr for any g,
        # so a gradient near zero whose sign the sums' order flips moves
        # its parameter 2 lr the other way
        diffs = [(s['params'][n] - p).abs() for n, p in ref_params.items()]
        worst = max(float(d.max()) for d in diffs)
        moved = sum(int((d > 1e-6).sum()) for d in diffs)
        checks.check(f'{tag} parameters vs the global-batch step',
                     worst <= 2e-3 + 1e-6,
                     f'max |diff| {worst:.3g} (limit 2 lr + 1e-6), '
                     f'{moved} of {sum(d.numel() for d in diffs)} entries '
                     f'off by more than 1e-6')
        checks.check(f'{tag} bf16 losses finite',
                     all(np.isfinite(out['losses'])),
                     ' '.join(f'{v:.6f}' for v in out['losses']))
        check_step_counts(checks, f'{tag} bf16', out['counts'], per_step,
                          TRAIN_STEPS)
        check_adam_counts(checks, f'{tag} bf16', out['counts'], out['adam'],
                          TRAIN_STEPS)
        check_vec_bodies(checks, f'{tag} bf16', out['counts'])
        share = out['allreduce_ms'] / out['step_ms']
        print(f'  {tag} bf16 step ms (median of steps {WARMUP_STEPS + 1}-'
              f'{TRAIN_STEPS}) {out["step_ms"]:.3f}; all: '
              + ' '.join(f'{1e3 * t:.2f}' for t in out['times'])
              + f'; gradient all-reduce {out["allreduce_ms"]:.3f} ms '
              f'({out["allreduce_bytes"]} B), share {share:.4f}; peak '
              f'memory {out["peak"]} B ({out["peak"] / 2 ** 30:.3f} GiB); '
              f'{card}', flush=True)
    same = all(torch.equal(saved[0]['params'][n], s['params'][n])
               for s in saved[1:] for n in ref_params)
    checks.check('dp ranks\' parameters bit-equal to one another', same,
                 f'{DP_RANKS} ranks')


def halo_rank(rank, world, outdir):
    """Phase 29 on one rank of a 1 x `world` 'space' mesh under gloo: each
    sharded op on this rank's z block against the unsharded kernel on the
    same card, then times."""
    import torch.distributed as dist
    from neurite_tpu_torch import parallel
    from neurite_tpu_torch.ops import conv, warp
    from neurite_tpu_torch.parallel import mesh as pmesh
    mesh = parallel.create_mesh(data=1, space=world, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(29)
    out = {'checks': [], 'ms': {}}

    def check(name, ok, detail=''):
        out['checks'].append((f'halo rank {rank}/{world} {name}', bool(ok),
                              detail))

    def block(t, axis=1):
        n = t.shape[axis] // world
        return t.narrow(axis, rank * n, n)

    # the unsharded references, before the path run
    x = torch.randn((1, LC_VOL, LC_VOL, LC_VOL, 4), generator=gen,
                    device='cuda').to(torch.bfloat16)
    k = (0.1 * torch.randn((1, 108, LC_VOL, LC_VOL ** 2), generator=gen,
                           device='cuda')).to(torch.bfloat16)
    g = torch.randn((1, LC_VOL, LC_VOL, LC_VOL, 1), generator=gen,
                    device='cuda')
    xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
    yr = lc_cuda.lc_transposed_pallas(xr, kr.reshape(1, 108, -1), LC_KS)
    (yr * g).sum().backward()
    opt_r = torch.optim.Adam([kr], lr=1e-4)
    opt_r.step()
    warps = []
    for shape, method, fill in (((64, 64, 64), 'linear', None),
                                ((VOL, VOL, VOL), 'nearest', 0.)):
        chans = 3 if method == 'linear' else 1
        vol = torch.randn((1, *shape, chans), generator=gen, device='cuda')
        shift = smooth_field(shape, 8., gen)
        loc = core.grid_points(shape, 'cuda')[None] + shift
        warps.append((vol, shift, method, fill,
                      warp.interpn_batch(vol, loc, method, fill)))
    blurs = []
    for shape, sigma, width in (((3, 64, 64, 64), 16 / 2.355, 41),
                                ((1, VOL, VOL, VOL), 1., 7)):
        xb = torch.randn(shape, generator=gen, device='cuda')
        k1 = core.gaussian_kernel(sigma, windowsize=width, device='cuda')
        blurs.append((xb, k1, blur.blur3d(xb, [k1, k1, k1])))
    dt = torch.rand((1, VOL, VOL, VOL, NB_LABELS), generator=gen,
                    device='cuda')
    dp_ = torch.rand((1, VOL, VOL, VOL, NB_LABELS), generator=gen,
                     device='cuda')
    dice_ref = dice_red.dice_sums(dt.reshape(1, -1, NB_LABELS),
                                  dp_.reshape(1, -1, NB_LABELS))
    cx = torch.randn((1, VOL, VOL, VOL, 16), generator=gen, device='cuda')
    ck = 0.1 * torch.randn((3, 3, 3, 16, 16), generator=gen, device='cuda')
    flags = exact_f32()
    conv_ref = conv.conv_same(cx, ck)
    torch.cuda.synchronize()

    # the path run: each op once on this rank's block
    dist.barrier()
    _build.launches.clear()
    pmesh.host_staged.clear()
    xs = block(x).detach().requires_grad_()
    ks = torch.nn.Parameter(block(k, 2).detach().clone())
    ys = parallel.sharded_lc(xs, ks, LC_KS, mesh, impl='pallas')
    (ys * block(g)).sum().backward()
    opt = torch.optim.Adam([ks], lr=1e-4)
    opt.step()
    warp_out = [parallel.sharded_bounded_warp(
        block(vol), block(shift), mesh, max_disp=8., interp_method=method,
        fill_value=fill) for vol, shift, method, fill, _ in warps]
    blur_out = [parallel.sharded_separable_blur(
        block(xb).movedim(0, -1)[None], [k1] * 3, mesh)[0].movedim(-1, 0)
        for xb, k1, _ in blurs]
    dice = parallel.sharded_dice_sums(block(dt), block(dp_), mesh)
    conv_out = parallel.sharded_conv(block(cx), ck, mesh)
    torch.cuda.synchronize()
    out['counts'] = dict(_build.launches)
    out['staged'] = dict(pmesh.host_staged)
    out['backend'] = dist.get_backend(mesh.get_group('space'))
    ys = ys.detach()

    # the checks
    h = 1                                  # LC_KS's z halo
    check('sharded_lc pallas forward bit-equal to the unsharded K7',
          bit_equal(ys, block(yr)), f'max abs err '
          f'{max_abs_err(ys, block(yr)):.3g}')
    dk_ref = block(kr.grad, 2)
    check('sharded_lc pallas dk bit-equal to the unsharded K8',
          bit_equal(ks.grad, dk_ref),
          f'max abs err {max_abs_err(ks.grad, dk_ref):.3g}')
    dx_ref = block(xr.grad)
    inner = slice(h, xs.shape[1] - h)
    err = max_abs_err(xs.grad, dx_ref)
    tol = 2 ** -7 * float(dx_ref.float().abs().max())
    check('sharded_lc pallas dx vs the unsharded K9', err <= tol,
          f'max abs err {err:.3g} (limit {tol:.3g}: two bf16 roundings '
          f'where the returned halo gradient adds)')
    check('sharded_lc dx rows off the block edges bit-equal',
          bit_equal(xs.grad[:, inner], dx_ref[:, inner]))
    mom = opt.state[ks]['exp_avg']
    check('sharded_lc Adam step on the z-sharded kernel',
          bit_equal(ks.detach(), block(kr.detach(), 2))
          and tuple(mom.shape) == tuple(ks.shape),
          f'kernel block {tuple(ks.shape)} bit-equal to the unsharded '
          f'step\'s; moments {tuple(mom.shape)}')
    for (vol, shift, method, fill, ref), got in zip(warps, warp_out):
        tag = f'sharded_bounded_warp {method} {list(vol.shape)}'
        err = max_abs_err(got, block(ref))
        ok = (bit_equal(got, block(ref)) if method == 'nearest'
              else err <= 1e-5)
        check(f'{tag} vs the unsharded K4', ok,
              f'max abs err {err:.3g} ('
              + ('bit-equal' if method == 'nearest' else 'limit 1e-5')
              + f'; |shift| <= {float(shift.abs().max()):.3f}, halo 9 of '
              f'{vol.shape[1] // world} rows; bit-equal '
              f'{bit_equal(got, block(ref))})')
    for (xb, k1, ref), got in zip(blurs, blur_out):
        check(f'sharded_separable_blur {list(xb.shape)} {k1.numel()} taps '
              f'bit-equal to the unsharded K6', bit_equal(got, block(ref)),
              f'max abs err {max_abs_err(got, block(ref)):.3g}')
    try:
        parallel.sharded_separable_blur(
            block(blurs[1][0]).movedim(0, -1)[None], [core.gaussian_kernel(
                64 / 2.355, windowsize=165, device='cuda')] * 3, mesh)
        raised = ''
    except ValueError as e:
        raised = str(e)
    check('sharded_separable_blur 165 taps on a 64-row block raises',
          raised == 'halo 82 exceeds local extent 64', repr(raised))
    errs = [max_abs_err(a, b) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(dice, dice_ref)]
    again = parallel.sharded_dice_sums(block(dt), block(dp_), mesh)
    check('sharded_dice_sums vs the unsharded K3', max(errs) <= 1e-5,
          f'max rel err {max(errs):.3g} (rtol 1e-5); a second call '
          f'bit-equal: {all(bit_equal(a, b) for a, b in zip(dice, again))}')
    err = rel_err(conv_out, block(conv_ref))
    check('sharded_conv 3x3x3 16->16 vs the unsharded conv', err <= 1e-5,
          f'max |diff| / max |y| {err:.3g} (limit 1e-5)')

    # times: the sharded op on every rank at once, the unsharded on rank 0
    # alone
    ms = out['ms']
    ops = {
        'sharded_lc fwd+bwd': (
            lambda: (parallel.sharded_lc(xs, ks, LC_KS, mesh, impl='pallas')
                     * block(g)).sum().backward(),
            lambda: (lc_cuda.lc_transposed_pallas(
                xr, kr.reshape(1, 108, -1), LC_KS) * g).sum().backward()),
        'sharded_bounded_warp linear 64^3': (
            lambda: parallel.sharded_bounded_warp(
                block(warps[0][0]), block(warps[0][1]), mesh, 8.),
            lambda: spatial.batch_transform(warps[0][0], warps[0][1])),
        'sharded_separable_blur [3, 64^3] 41 taps': (
            lambda: parallel.sharded_separable_blur(
                block(blurs[0][0]).movedim(0, -1)[None], [blurs[0][1]] * 3,
                mesh),
            lambda: blur.blur3d(blurs[0][0], [blurs[0][1]] * 3)),
        'sharded_dice_sums [1, 128^3, 4]': (
            lambda: parallel.sharded_dice_sums(block(dt), block(dp_), mesh),
            lambda: dice_red.dice_sums(dt.reshape(1, -1, NB_LABELS),
                                       dp_.reshape(1, -1, NB_LABELS))),
        'sharded_conv 128^3 16->16': (
            lambda: parallel.sharded_conv(block(cx), ck, mesh),
            lambda: conv.conv_same(cx, ck)),
    }
    for name, (sharded, whole) in ops.items():
        dist.barrier()
        ms[name] = {'sharded': wall_ms(sharded)}
        dist.barrier()
        if rank == 0:
            ms[name]['unsharded'] = wall_ms(whole)
        dist.barrier()
    restore_flags(flags)
    return out


def phase_halo(checks, card):
    print(f'== 29. halo ops on a space={HALO_RANKS} mesh ({card})',
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(halo_rank, HALO_RANKS, 'gloo', d)
    want = {'lc_fwd': 1, 'lc_dk': 1, 'lc_dx': 1, 'interpn': 2, 'blur': 6,
            'dice_sums': 1}
    for r, out in enumerate(ranks):
        for name, ok, detail in out['checks']:
            checks.check(name, ok, detail)
        tag = f'halo rank {r}/{HALO_RANKS} ({out["backend"]})'
        check_step_counts(checks, tag, out['counts'], want, 1, unit='run')
        check_vec_bodies(checks, tag, out['counts'])
        staged = out['staged']
        checks.check(f'{tag} host-staged halo exchanges',
                     staged.get('halo', 0) == 6
                     and staged.get('halo_grad', 0) == 1,
                     f'{staged} (gloo moves CPU tensors only: 6 exchanges '
                     f'forward, 1 backward)')
        for name, t in out['ms'].items():
            print(f'  {tag} {name}: {t["sharded"]:.3f} ms a rank, both '
                  f'ranks at once, halos through the host'
                  + (f'; unsharded on one rank alone {t["unsharded"]:.3f} '
                     f'ms' if 'unsharded' in t else '') + f'; {card}',
                  flush=True)


def space_flagship(rank, mesh, out):
    """Phase 30 (a) on one rank: the flagship's f32 step (saved for the
    parent's comparison) and 10 bf16 steps on this rank's z block."""
    import torch.distributed as dist
    from neurite_tpu_torch import parallel
    from neurite_tpu_torch.parallel import mesh as pmesh, spatial as psp
    x, y = flagship_inputs()
    batch = parallel.shard_batch((x, y), mesh)
    del x, y
    flags = exact_f32()
    try:
        state = training.create_train_state(flagship(), training.adam(1e-3))
        step = parallel.make_sharded_train_step(
            training.make_train_step(dice_loss()), mesh)
        state, m = step(state, batch,
                        torch.Generator(device='cuda').manual_seed(1))
        out['f32_loss'] = float(m['loss'])
        out['block'] = list(batch[0].shape)
        torch.save({'grads': {n: p.grad.cpu() for n, p in
                              state.model.named_parameters()},
                    'params': {n: p.detach().cpu() for n, p in
                               state.model.named_parameters()}},
                   os.path.join(out['dir'], f'rank{rank}.pt'))
        del state, step
    finally:
        restore_flags(flags)
    model = flagship(dtype=torch.bfloat16)
    state = training.create_train_state(model, training.adam(1e-3))
    step = parallel.make_sharded_train_step(
        training.make_train_step(dice_loss()), mesh)
    gen = torch.Generator(device='cuda').manual_seed(1)
    psp.gathered.clear()
    pmesh.host_staged.clear()
    state, losses, times, counts, peak = timed_steps(step, state,
                                                     (batch, gen))
    out['a'] = dict(losses=losses, times=times, counts=counts, peak=peak,
                    step_ms=1e3 * statistics.median(times[WARMUP_STEPS:]),
                    adam=adam_per_step(state.optimizer),
                    gathered=dict(psp.gathered),
                    staged=dict(pmesh.host_staged),
                    halo_convs=sum(isinstance(m, Conv)
                                   for m in model.modules()))
    # the step's parts that the sharding adds, alone, on both ranks at once:
    # one gather of the loss pair's f32 tensor, and one exchange of a
    # level-1 conv's input block (16 bf16 channels, one row a side)
    from neurite_tpu_torch.parallel import halo
    ax = pmesh._axis(mesh, 'space')
    yb = batch[1]
    xb = torch.zeros((1, yb.shape[1], VOL, VOL, 16), dtype=torch.bfloat16,
                     device=yb.device)
    dist.barrier()
    out['a']['gather_ms'] = wall_ms(
        lambda: psp._Gather.apply(yb, 1, ax, False))
    dist.barrier()
    out['a']['exchange_ms'] = wall_ms(lambda: halo._halo(xb, 1, 1, ax))


def space_lc(rank, mesh, out):
    """Phase 30 (b) on one rank: config #3 with its head split over
    'space', the first step checked against the unsharded kernels on the
    gathered inputs, then 10 timed steps."""
    from neurite_tpu_torch import parallel
    from neurite_tpu_torch.parallel import mesh as pmesh, spatial as psp
    checks = out['checks']

    def check(name, ok, detail=''):
        checks.append((f'space rank {rank} config #3 {name}', bool(ok),
                       detail))

    ax = pmesh._axis(mesh, 'space')
    n = LC_VOL // ax.size

    def block(t, axis=1):
        return t.narrow(axis, rank * n, n)

    def whole(t, axis=1):
        with torch.no_grad():
            return psp._Gather.apply(t.contiguous(), axis, ax, False)

    x, y = config3_inputs(LC_VOL)
    batch = parallel.shard_batch((x, y), mesh)
    del x, y
    model = config3(LC_VOL, torch.bfloat16)
    lc = model.lc
    state = training.create_train_state(model, training.adam(1e-4))
    step = parallel.make_sharded_train_step(
        training.make_train_step(mse), mesh, param_specs=LC_SPECS)
    cap = {}

    def pre(mod, args):
        cap['x'] = args[0].detach().clone()
        cap['k'] = mod.kernel.detach().clone()
        cap['b'] = mod.bias.detach().clone()
        args[0].register_hook(lambda g: cap.__setitem__('dx', g.clone()))

    def post(mod, args, result):
        cap['y'] = result.detach().clone()
        result.register_hook(lambda g: cap.__setitem__('g', g.clone()))

    hooks = [lc.register_forward_pre_hook(pre), lc.register_forward_hook(post)]
    torch.cuda.synchronize()
    _build.launches.clear()
    psp.gathered.clear()
    pmesh.host_staged.clear()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    out['b_first'] = dict(counts=dict(_build.launches),
                          adam=adam_per_step(state.optimizer),
                          gathered=dict(psp.gathered),
                          staged=dict(pmesh.host_staged), loss=float(m['loss']))
    for h in hooks:
        h.remove()
    dk = lc.kernel.grad.detach().clone()
    mom = state.optimizer.state[lc.kernel]['exp_avg']
    want = (1, 108, n * LC_VOL ** 2)
    check('kernel block and moments', tuple(lc.kernel.shape) == want
          and tuple(mom.shape) == want and tuple(lc.bias.shape)
          == (n, LC_VOL, LC_VOL, 1),
          f'kernel {tuple(lc.kernel.shape)} (the [1, 108, {n}, '
          f'{LC_VOL}^2] z block of [1, 108, {LC_VOL}, {LC_VOL}^2]), '
          f'moments {tuple(mom.shape)} {mom.dtype}, bias '
          f'{tuple(lc.bias.shape)}')

    # the unsharded kernels on the gathered inputs, after the path run
    xw = whole(cap['x']).requires_grad_()
    kw = whole(cap['k'].reshape(1, 108, n, -1), 2).reshape(1, 108, -1)
    kw.requires_grad_()
    yw = lc_cuda.lc_transposed_pallas(xw, kw, LC_KS).to(xw.dtype) \
        + whole(cap['b'], 0)
    yw.backward(whole(cap['g']))
    check('head output (K7 and the bias) bit-equal to the unsharded K7',
          bit_equal(cap['y'], block(yw.detach())),
          f'max abs err {max_abs_err(cap["y"], block(yw.detach())):.3g}')
    dk_ref = kw.grad.reshape(1, 108, LC_VOL, -1).narrow(2, rank * n, n)
    dk_ref = dk_ref.reshape(dk.shape)
    check('head dk bit-equal to the unsharded K8', bit_equal(dk, dk_ref),
          f'max abs err {max_abs_err(dk, dk_ref):.3g}')
    dx, dx_ref = cap['dx'], block(xw.grad)
    err = max_abs_err(dx, dx_ref)
    tol = 2 ** -7 * float(dx_ref.float().abs().max())
    check('head dx vs the unsharded K9', err <= tol,
          f'max abs err {err:.3g} (limit {tol:.3g}: two bf16 roundings '
          f'where the returned halo gradient adds)')
    check('head dx rows off the block edges bit-equal',
          bit_equal(dx[:, 1:n - 1], dx_ref[:, 1:n - 1]))
    del xw, kw, yw, cap, dk, dk_ref, dx, dx_ref
    psp.gathered.clear()
    pmesh.host_staged.clear()
    state, losses, times, counts, peak = timed_steps(step, state, (batch,))
    out['b'] = dict(losses=losses, times=times, counts=counts, peak=peak,
                    step_ms=1e3 * statistics.median(times[WARMUP_STEPS:]),
                    adam=adam_per_step(state.optimizer),
                    gathered=dict(psp.gathered),
                    staged=dict(pmesh.host_staged),
                    halo_convs=sum(isinstance(m, Conv)
                                   for m in model.modules()))


def space_rank(rank, world, outdir):
    """Phase 30 on one rank of a 1 x `world` 'space' mesh under gloo."""
    import torch.distributed as dist
    from neurite_tpu_torch import parallel
    mesh = parallel.create_mesh(data=1, space=world, device='cuda')
    out = {'backend': dist.get_backend(mesh.get_group('space')),
           'checks': [], 'dir': outdir}
    space_flagship(rank, mesh, out)
    torch.cuda.empty_cache()
    space_lc(rank, mesh, out)
    return out


def space_reference():
    """The single-process references of phase 30: the flagship's f32 step
    (loss, gradients, parameters; TF32 off, deterministic cuDNN) and the
    peak memory of 3 unsharded bf16 flagship steps and of 3 unsharded bf16
    config #3 steps."""
    x, y = flagship_inputs()
    flags = exact_f32()
    try:
        state = training.create_train_state(flagship(), training.adam(1e-3))
        step = training.make_train_step(dice_loss())
        state, m = step(state, (x, y),
                        torch.Generator(device='cuda').manual_seed(1))
        ref = (float(m['loss']),
               {n: p.grad.cpu() for n, p in state.model.named_parameters()},
               {n: p.detach().cpu() for n, p in
                state.model.named_parameters()})
        del state, step
    finally:
        restore_flags(flags)
    peaks = {}
    state = training.create_train_state(flagship(dtype=torch.bfloat16),
                                        training.adam(1e-3))
    step = training.make_train_step(dice_loss())
    gen = torch.Generator(device='cuda').manual_seed(1)
    run = timed_steps(step, state, ((x, y), gen), n=6)
    peaks['flagship'] = run[-1]
    peaks['flagship_ms'] = 1e3 * statistics.median(run[2][WARMUP_STEPS:])
    del state, step, x, y
    torch.cuda.empty_cache()
    x, y = config3_inputs(LC_VOL)
    state = training.create_train_state(config3(LC_VOL, torch.bfloat16),
                                        training.adam(1e-4))
    step = training.make_train_step(mse)
    run = timed_steps(step, state, ((x, y),), n=6)
    peaks['config3'] = run[-1]
    peaks['config3_ms'] = 1e3 * statistics.median(run[2][WARMUP_STEPS:])
    del state, step, x, y
    torch.cuda.empty_cache()
    return ref, peaks


def phase_space(checks, card):
    print(f'== 30. whole-model spatial sharding on a space={SPACE_RANKS} mesh '
          f'({card})', flush=True)
    (ref_loss, ref_grads, ref_params), peaks = space_reference()
    with tempfile.TemporaryDirectory() as d:
        ranks = spawn_ranks(space_rank, SPACE_RANKS, 'gloo', d)
        saved = [torch.load(os.path.join(d, f'rank{r}.pt'))
                 for r in range(SPACE_RANKS)]
    for r, (out, s) in enumerate(zip(ranks, saved)):
        tag = f'space rank {r}/{SPACE_RANKS} ({out["backend"]})'
        checks.check(f'{tag} flagship f32 loss vs the unsharded step',
                     abs(out['f32_loss'] - ref_loss) <= 1e-5 * abs(ref_loss),
                     f'rank {out["f32_loss"]!r} unsharded {ref_loss!r} (rtol '
                     f'1e-5); z block {out["block"]}')
        worst = max(float((s['grads'][n] - g).abs().max() / g.abs().max())
                    for n, g in ref_grads.items())
        checks.check(f'{tag} flagship f32 grads vs the unsharded step',
                     worst <= 1e-4, f'{len(ref_grads)} tensors, worst '
                     f'max|diff|/max|g| {worst:.3g} (limit 1e-4)')
        diffs = [(s['params'][n] - p).abs() for n, p in ref_params.items()]
        worst = max(float(d.max()) for d in diffs)
        moved = sum(int((d > 1e-6).sum()) for d in diffs)
        checks.check(f'{tag} flagship parameters vs the unsharded step',
                     worst <= 2e-3 + 1e-6,
                     f'max |diff| {worst:.3g} (limit 2 lr + 1e-6), {moved} '
                     f'of {sum(d.numel() for d in diffs)} entries off by '
                     f'more than 1e-6')
        for part, per_step, path in (
                ('a', {'pool2_fwd': 3, 'pool2_bwd': 3, 'dice_sums': 1},
                 'flagship'),
                ('b', {'pool2_fwd': 2, 'pool2_bwd': 2, 'lc_fwd': 1,
                       'lc_fwd_row': 1, 'lc_dk': 1, 'lc_dk_row': 1,
                       'lc_dx': 1, 'lc_dx_row': 1}, 'config #3')):
            run = out[part]
            checks.check(f'{tag} {path} bf16 losses finite',
                         all(np.isfinite(run['losses'])),
                         ' '.join(f'{v:.6f}' for v in run['losses']))
            check_step_counts(checks, f'{tag} {path} bf16', run['counts'],
                              per_step, TRAIN_STEPS)
            check_adam_counts(checks, f'{tag} {path} bf16', run['counts'],
                              run['adam'], TRAIN_STEPS)
            checks.check(f'{tag} {path} bf16 K3 launches',
                         run['counts'].get('dice_sums', 0)
                         == per_step.get('dice_sums', 0) * TRAIN_STEPS,
                         f'{run["counts"].get("dice_sums", 0)}')
            check_vec_bodies(checks, f'{tag} {path} bf16', run['counts'])
            checks.check(f'{tag} {path} gathers: the loss pair a step',
                         run['gathered'] == {'loss': 2 * TRAIN_STEPS},
                         f'{run["gathered"]}')
            # the first conv's input needs no gradient: one exchange fewer
            # backward
            fwd = run['halo_convs'] + (part == 'b')
            staged = run['staged']
            checks.check(f'{tag} {path} host-staged halo exchanges',
                         staged == {'halo': fwd * TRAIN_STEPS,
                                    'halo_grad': (fwd - 1) * TRAIN_STEPS},
                         f'{staged} ({fwd} forward and {fwd - 1} backward '
                         f'a step; gloo moves CPU tensors only)')
            ref = 'flagship' if part == 'a' else 'config3'
            unsharded = peaks[ref]
            print(f'  {tag} {path} bf16 step ms (median of steps '
                  f'{WARMUP_STEPS + 1}-{TRAIN_STEPS}) {run["step_ms"]:.3f} a '
                  f'rank, both ranks at once, halos through the host; all: '
                  + ' '.join(f'{1e3 * t:.2f}' for t in run['times'])
                  + f'; the unsharded step in one process '
                  f'{peaks[ref + "_ms"]:.3f} ms (median of steps '
                  f'{WARMUP_STEPS + 1}-6); peak memory {run["peak"]} B '
                  f'({run["peak"] / 2 ** 30:.3f} GiB) a rank against '
                  f'{unsharded} B ({unsharded / 2 ** 30:.3f} GiB) for the '
                  f'unsharded step; {card}', flush=True)
            if part == 'a':
                print(f'  {tag} alone, both ranks at once: one loss gather '
                      f'of [1, {VOL}^3, {NB_LABELS}] f32 '
                      f'{run["gather_ms"]:.3f} ms (two a step), one halo '
                      f'exchange of a [1, {VOL // SPACE_RANKS}, {VOL}^2, 16] '
                      f'bf16 block {run["exchange_ms"]:.3f} ms (27 a step '
                      f'at four levels)', flush=True)
        first = out['b_first']
        check_step_counts(checks, f'{tag} config #3 first step',
                          first['counts'], {'pool2_fwd': 2, 'pool2_bwd': 2,
                                            'lc_fwd': 1, 'lc_dk': 1,
                                            'lc_dx': 1}, 1)
        check_adam_counts(checks, f'{tag} config #3 first step',
                          first['counts'], first['adam'], 1)
        for name, ok, detail in out['checks']:
            checks.check(name, ok, detail)
    checks.check('space ranks\' flagship parameters bit-equal to one another',
                 all(torch.equal(saved[0]['params'][n], s['params'][n])
                     for s in saved[1:] for n in ref_params),
                 f'{SPACE_RANKS} ranks')


# tests/test_examples.py's checks of each script's returned dict
EXAMPLE_CHECKS = {
    'train_unet_2d.py': lambda r: r['final_loss'] < -0.5,
    'deformable_registration.py':
        lambda r: r['mi_after'] > r['mi_before'] + 0.05,
    'multichip_training.py': lambda r: math.isfinite(r['loss']),
    'synthesis_pipeline.py': lambda r: math.isfinite(r['loss']),
    'synthstrip_training.py': lambda r: math.isfinite(r['loss']),
    'anatomical_priors_vae.py':
        lambda r: math.isfinite(r['loss']) and len(r['recon_shape']) >= 2,
}


def phase_examples(checks):
    import runpy
    print('== 31. the examples_torch scripts on the card', flush=True)
    root = os.path.join(REPO, 'examples_torch')
    for script, ok in EXAMPLE_CHECKS.items():
        t0 = time.perf_counter()
        result = runpy.run_path(os.path.join(root, script))['main']()
        torch.cuda.synchronize()
        checks.check(f'example {script}', ok(result),
                     f'{result} in {time.perf_counter() - t0:.3f} s')


def report_profile(label, fn, first):
    """Wall time, device busy time and idle share of PROFILE_STEPS calls
    fn(first), fn(first + 1), ..., and the device time by kernel; returns
    the idle share."""
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
    return 1 - busy / wall


def parse_phases(argv):
    """The phases named by --phases (a comma list; all when it is absent).
    Phase 1 runs whatever is named: it finds the card. A kernel phase that
    became a card test is refused with the test file that holds it."""
    ap = argparse.ArgumentParser(
        description='Smoke test of neurite_tpu_torch on one NVIDIA GPU.')
    ap.add_argument('--phases', default=','.join(PHASES),
                    help='comma list of phases to run, of '
                         + ','.join(PHASES) + ' (default: all)')
    names = [p.strip() for p in ap.parse_args(argv).phases.split(',')
             if p.strip()]
    moved = [p for p in names if p in CARD_TESTS]
    if moved:
        ap.error('; '.join(
            f'phase {p} is now `python -m pytest --noconftest -p '
            f'no:cacheprovider -m cuda {CARD_TESTS[p]}` (phase 33 runs '
            f'every card test)' for p in moved))
    bad = [p for p in names if p not in PHASES]
    if bad or not names:
        ap.error(f'unknown phases {bad}: choose from {",".join(PHASES)}')
    return set(names)


def main(argv=None):
    run = parse_phases(argv)
    card = phase_device()
    checks = Checks()
    build = f'{phase_build():.3f} s' if '2' in run else 'not run (phase 2)'
    phases = {
        '33': lambda: phase_card_tests(checks),
        '5': lambda: phase_parity(checks, *flagship_inputs()),
        '6': lambda: phase_train(checks, *flagship_inputs()),
        '9a': lambda: phase_synth_check(checks),
        '9': lambda: phase_synth_train(checks),
        '11': lambda: phase_lc_check(checks),
        '12': lambda: phase_lc_train(checks),
        '14': lambda: phase_reg_check(checks),
        '15': lambda: phase_reg_train(checks),
        '16': lambda: phase_strip_check(checks),
        '17': lambda: phase_strip_train(checks),
        '18': lambda: phase_vae_check(checks),
        '19': lambda: phase_vae_train(checks),
        '20': lambda: phase_sparse_check(checks),
        '21': lambda: phase_sparse_train(checks),
        '22': lambda: phase_s2d(checks),
        '23': lambda: phase_remat(checks),
        '24': lambda: phase_serve(checks),
        '25': lambda: phase_classify(checks),
        '26': lambda: phase_disk(checks),
        '27': lambda: phase_feed(checks),
        '28': lambda: phase_dp(checks, card),
        '29': lambda: phase_halo(checks, card),
        '30': lambda: phase_space(checks, card),
        '31': lambda: phase_examples(checks),
    }
    for name, fn in phases.items():
        if name in run:
            fn()
    ran = ",".join(p for p in PHASES if p in run)
    print(f'phases run: {ran}'
          + ('' if len(run) == len(PHASES) else
             ' (a subset: the run does not stand for the whole smoke test)'))
    print(f'card: {card}; kernel build {build}')
    subset = {} if len(run) == len(PHASES) else {'phases': ran}
    if checks.failed:
        print(f'FAILED: {checks.failed}', flush=True)
        sys.exit(1)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}, **subset}))


if __name__ == '__main__':
    main()
