"""
K9's keras-layout designs side by side on the card: the record behind the
'keras_row' body of `lc_dx_keras_row_kernel` in
`neurite_tpu_torch/ops/csrc/lc.cu` (Pallas row 11, `pallas_lc.py:252`).

Builds `lc.cu` together with variants of that body, and at the config #3
head's shape in the keras layout (x [1, 160^3, 4] bf16, weights
[160^3, 108] bf16, g [1, 160^3, 1] f32, products rounded to bf16: the v1
dx of `lc_cuda.lc3d_pallas`) times each against the port's two K9 bodies
on the same inputs. Every variant that computes dx must give the one-voxel
body's bits, or the script fails. The variants:

- 'voxel', 'keras_row': the port's bodies (`lc_cuda._dx_launch`); its
  keras row body owns a 16 x 8 tile of input voxels of one z-plane and
  stages, per tz, that tz's contiguous ky * kx tap quads of each output
  row the tile reaches;
- 'first design': a block of 128 consecutive input voxels staging, per
  (tz, ty) tap group, the 24-byte kx * C chunk of each output row its taps
  reach, in kz rounds of ky groups, and summing with each tap's shared
  loads inside the tap loop;
- 'row groups': the same staging with the loads of all nine groups issued
  before any store and a tz plane's taps loaded together (also at 64
  voxels a block; and its staging alone and its sums alone, diagnostics
  whose dx is not compared);
- 'tile 16x8, two indices': the port's tile as first written, two
  registers of indices a staged quad: plain, pipelined (plane tz + 1's
  loads before plane tz's sums, as the port's), its staging alone and its
  sums alone (diagnostics), blocks in z-fastest order, and loads with an
  L2 prefetch of 256 bytes (`ld.global.cg.L2::256B`);
- 'cp.async tile 16x8': the tile staged by `cp.async` 16-byte copies of
  the aligned pieces around each run, two planes in flight;
- 'keras_row at BXxBY': the port's body at other tiles.

Also K7's keras row body and a read probe (`w.sum()`) at the head, and the
keras row bodies of K7 and K9 at [1, 48^3, 4], whose 23.9 MB of weights
stay in L2 when timed back to back. Times are device times by
torch.profiler over 20 calls (`chip_smoke.time_ms`).

    python3 lc_keras_layouts.py

needs one CUDA card, `nvcc` and the repo checkout; prints the card's name
and power limit, one line per variant, and a JSON line last. Exits
non-zero if a variant's bits differ or the card is missing.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from neurite_tpu_torch.ops import _build, lc_cuda

SOURCE = r'''
#include "lc.cu"

namespace {

constexpr int kKerasQuads = kRowTaps + 1;  // quads a thread a group

// Tap groups whose quads a thread of the row-group design loads before it
// stores any: all nine of a 3 x 3 (tz, ty) head in bf16.
template <typename TK>
__host__ __device__ constexpr int keras_stage_groups() {
  return sizeof(TK) == 2 ? 9 : 3;
}

// The first design: the staging in kz rounds of ky groups (a round's loads
// issued, then stored), and each tap's shared loads inside the tap loop.
template <typename TX, typename TK>
__global__ void __launch_bounds__(128)
dx_keras_first(const float* __restrict__ gr, const TK* __restrict__ k,
               TX* __restrict__ dx, Geo g, int round_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef Quad<TK> K;
  typedef typename K::type KQ;
  const int W = (int)g.W, H = (int)g.H, D = (int)g.D, V = W * H * D;
  const int kz = (int)g.kz, ky = (int)g.ky, kx = (int)g.kx;
  const int pz = (int)g.pz, py = (int)g.py, px = (int)g.px;
  const int TC = kz * ky * kx * kChans;
  const int NB = blockDim.x, NR = NB + kx - 1, tid = threadIdx.x;
  const int u0 = blockIdx.x * NB;
  KQ* wt = reinterpret_cast<KQ*>(smem);
  float* gt = reinterpret_cast<float*>(wt + kz * ky * NR * kx);
  int prow[kKerasQuads], poff[kKerasQuads];
#pragma unroll
  for (int j = 0; j < kKerasQuads; ++j) {
    const int p = tid + j * NB;
    prow[j] = p < NR * kx ? p / kx : -1;
    poff[j] = (p / kx) * TC + (p % kx) * kChans;
  }
  for (int tz = 0; tz < kz; ++tz) {
    KQ q[kRowTaps][kKerasQuads];
    float gq[kRowTaps][2];
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
      const int vb = u0 - ((tz - pz) * H + (ty - py)) * W + px - (kx - 1);
      const int64_t base =
          (int64_t)vb * TC + (int64_t)(tz * ky + ty) * kx * kChans;
#pragma unroll
      for (int j = 0; j < kKerasQuads; ++j) {
        const int v = vb + prow[j];
        q[ty][j] = ty < ky && prow[j] >= 0 && v >= 0 && v < V
                       ? K::ldcg(k + base + poff[j])
                       : KQ{};
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = tid + i * NB, v = vb + r;
        gq[ty][i] = ty < ky && r < NR && v >= 0 && v < V ? gr[v] : 0.f;
      }
    }
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
      if (ty >= ky) break;
      const int grp = tz * ky + ty;
#pragma unroll
      for (int j = 0; j < kKerasQuads; ++j)
        if (prow[j] >= 0) wt[grp * NR * kx + tid + j * NB] = q[ty][j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tid + i * NB < NR) gt[grp * NR + tid + i * NB] = gq[ty][i];
    }
  }
  __syncthreads();
  const int u = u0 + tid;
  if (u >= V) return;
  const int ux = u % W, uy = (u / W) % H, uz = u / (W * H);
  float acc[kChans];
#pragma unroll
  for (int c = 0; c < kChans; ++c) acc[c] = 0.f;
  for (int tz = 0; tz < kz; ++tz) {
    const int vz = uz - tz + pz;
    if (vz < 0 || vz >= D) continue;
    for (int ty = 0; ty < ky; ++ty) {
      const int vy = uy - ty + py;
      if (vy < 0 || vy >= H) continue;
      const int grp = tz * ky + ty;
      for (int tx = 0; tx < kx; ++tx) {
        const int vx = ux - tx + px;
        if (vx < 0 || vx >= W) continue;
        const int r = tid + kx - 1 - tx;
        const KQ w = wt[(grp * NR + r) * kx + tx];
        const float gv = gt[grp * NR + r];
#pragma unroll
        for (int c = 0; c < kChans; ++c) {
          float p = __fmul_rn(K::chan(w, c), gv);
          if (round_q) p = to_f32(from_f32<TK>(p));
          acc[c] = __fadd_rn(acc[c], p);
        }
      }
    }
  }
  store_quad(dx + (int64_t)u * kChans, acc);
}

// The row-group design: a block of NB consecutive input voxels stages, per
// (tz, ty) tap group, the kx * C chunk of each of the NB + kx - 1 output
// rows its taps reach (24 bytes of a 216-byte run in bf16), the loads of
// nine groups issued before any is stored, and g there; then each thread
// sums from shared memory, a tz plane's taps loaded together. MODE 0: dx;
// 2: the staging alone (dx = 0); 3: the sums alone (nothing loaded from k
// or g: the shared memory as it is).
template <typename TX, typename TK, int MODE>
__global__ void __launch_bounds__(128, 5)
dx_keras_part(const float* __restrict__ gr, const TK* __restrict__ k,
              TX* __restrict__ dx, Geo g, int round_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef Quad<TK> K;
  typedef typename K::type KQ;
  constexpr int NS = keras_stage_groups<TK>();
  const int W = (int)g.W, H = (int)g.H, D = (int)g.D, V = W * H * D;
  const int kz = (int)g.kz, ky = (int)g.ky, kx = (int)g.kx;
  const int pz = (int)g.pz, py = (int)g.py, px = (int)g.px;
  const int TC = kz * ky * kx * kChans, NG = kz * ky;
  const int NB = blockDim.x, NR = NB + kx - 1, tid = threadIdx.x;
  const int u0 = blockIdx.x * NB;
  KQ* wt = reinterpret_cast<KQ*>(smem);
  float* gt = reinterpret_cast<float*>(wt + NG * NR * kx);
  if (MODE != 3) {
    int prow[kRowTaps], poff[kRowTaps];
#pragma unroll
    for (int j = 0; j < kRowTaps; ++j) {
      const int p = tid + j * NB;
      prow[j] = j < kx ? p / kx : -1;
      poff[j] = (p / kx) * TC + (p % kx) * kChans;
    }
    auto first_row = [&](int grp) {
      const int tz = grp / ky, ty = grp - tz * ky;
      return u0 - ((tz - pz) * H + (ty - py)) * W + px - (kx - 1);
    };
    for (int g0 = 0; g0 < NG; g0 += NS) {
      KQ q[NS][kRowTaps];
      float gq[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int grp = g0 + i, vb = first_row(grp);
        const int64_t base = (int64_t)vb * TC + (int64_t)grp * kx * kChans;
#pragma unroll
        for (int j = 0; j < kRowTaps; ++j) {
          const int v = vb + prow[j];
          q[i][j] = grp < NG && prow[j] >= 0 && v >= 0 && v < V
                        ? K::ldcg(k + base + poff[j])
                        : KQ{};
        }
        const int v = vb + tid;
        gq[i] = grp < NG && v >= 0 && v < V ? gr[v] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int grp = g0 + i;
        if (grp >= NG) break;
#pragma unroll
        for (int j = 0; j < kRowTaps; ++j)
          if (prow[j] >= 0) wt[grp * NR * kx + tid + j * NB] = q[i][j];
        gt[grp * NR + tid] = gq[i];
      }
    }
    const int nt = NG * (kx - 1) * (kx + 1);
    for (int t = tid; t < nt; t += NB) {
      const int grp = t / ((kx - 1) * (kx + 1)), e = t % ((kx - 1) * (kx + 1));
      const int r = NB + e / (kx + 1), tx = e % (kx + 1);
      const int v = first_row(grp) + r;
      if (v < 0 || v >= V) continue;
      if (tx < kx)
        wt[(grp * NR + r) * kx + tx] = K::ldcg(
            k + (int64_t)v * TC + (int64_t)(grp * kx + tx) * kChans);
      else
        gt[grp * NR + r] = gr[v];
    }
  }
  __syncthreads();
  const int u = u0 + tid;
  if (u >= V) return;
  float acc[kChans];
#pragma unroll
  for (int c = 0; c < kChans; ++c) acc[c] = 0.f;
  if (MODE != 2) {
    const int ux = u % W, uy = (u / W) % H, uz = u / (W * H);
    for (int tz = 0; tz < kz; ++tz) {
      const int vz = uz - tz + pz;
      if (vz < 0 || vz >= D) continue;
      KQ w[kRowTaps][kRowTaps];
      float gv[kRowTaps][kRowTaps];
#pragma unroll
      for (int ty = 0; ty < kRowTaps; ++ty) {
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          const int grp = tz * ky + ty, r = tid + kx - 1 - tx;
          const bool on = ty < ky && tx < kx;
          w[ty][tx] = on ? wt[(grp * NR + r) * kx + tx] : KQ{};
          gv[ty][tx] = on ? gt[grp * NR + r] : 0.f;
        }
      }
#pragma unroll
      for (int ty = 0; ty < kRowTaps; ++ty) {
        const int vy = uy - ty + py;
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          const int vx = ux - tx + px;
          if (ty < ky && tx < kx && vy >= 0 && vy < H && vx >= 0 && vx < W) {
#pragma unroll
            for (int c = 0; c < kChans; ++c) {
              float p = __fmul_rn(K::chan(w[ty][tx], c), gv[ty][tx]);
              if (round_q) p = to_f32(from_f32<TK>(p));
              acc[c] = __fadd_rn(acc[c], p);
            }
          }
        }
      }
    }
  }
  store_quad(dx + (int64_t)u * kChans, acc);
}

// A tile load with an L2 prefetch of the 256-byte block around it.
template <typename T>
__device__ __forceinline__ typename Quad<T>::type ld_l2_256(const T* p);
template <>
__device__ __forceinline__ uint2 ld_l2_256<bf16>(const bf16* p) {
  uint2 r;
  asm volatile("ld.global.cg.L2::256B.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}

// The tile design as first written, with two indices a quad (its halo
// row's voxel and its tap; the port's body keeps one offset): a block owns
// a BY x BX tile of input voxels of one z-plane (one a thread) and, per
// tz, stages the (BY + ky - 1) x (BX + kx - 1) output rows of plane uz -
// tz + pz that its taps reach, of each row the ky * kx contiguous tap
// quads of that tz, and g there. PIPE 1: plane tz + 1's loads issued
// before plane tz's sums. MODE 0: dx; 2: the staging alone (dx = 0); 3:
// the sums alone (nothing loaded).
// ZFAST: consecutive blocks take consecutive z-planes of one tile; PF: the
// loads prefetch 256 bytes into L2.
template <typename TX, typename TK, int BX, int BY, int PIPE, int MODE,
          int ZFAST = 0, int PF = 0>
__global__ void __launch_bounds__(BX * BY)
dx_keras_tile(const float* __restrict__ gr, const TK* __restrict__ k,
              TX* __restrict__ dx, Geo g, int round_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef Quad<TK> K;
  typedef typename K::type KQ;
  constexpr int NB = BX * BY;
  // quads a thread stages a plane, at ky = kx = 3
  constexpr int kTileQuads = ((BX + 2) * (BY + 2) * 9 + NB - 1) / NB;
  constexpr int kTileRows = ((BX + 2) * (BY + 2) + NB - 1) / NB;
  const int W = (int)g.W, H = (int)g.H, D = (int)g.D;
  const int kz = (int)g.kz, ky = (int)g.ky, kx = (int)g.kx;
  const int pz = (int)g.pz, py = (int)g.py, px = (int)g.px;
  const int NQ = ky * kx, TC = kz * NQ * kChans;
  const int HX = BX + kx - 1, HY = BY + ky - 1, NRW = HX * HY;
  const int nbx = (W + BX - 1) / BX, nby = (H + BY - 1) / BY;
  const int b = ZFAST ? (blockIdx.x % D) * nbx * nby + blockIdx.x / D
                      : blockIdx.x;
  const int bx = b % nbx, by = (b / nbx) % nby;
  const int uz = b / (nbx * nby);
  const int x0 = bx * BX, y0 = by * BY, tid = threadIdx.x;
  KQ* wt = reinterpret_cast<KQ*>(smem);                  // [NRW][NQ]
  float* gt = reinterpret_cast<float*>(wt + NRW * NQ);   // [NRW]
  // this thread's quads p = tid + j NB: halo row p / NQ, quad p % NQ; the
  // row's voxel in its plane (-1 outside the volume or past the halo)
  int prow[kTileQuads], pq[kTileQuads];
#pragma unroll
  for (int j = 0; j < kTileQuads; ++j) {
    const int p = tid + j * NB, r = p / NQ;
    const int y = y0 - (ky - 1) + py + r / HX, x = x0 - (kx - 1) + px + r % HX;
    prow[j] = p < NRW * NQ && y >= 0 && y < H && x >= 0 && x < W
                  ? y * W + x : -1;
    pq[j] = p % NQ;
  }
  int grow[kTileRows];
#pragma unroll
  for (int h = 0; h < kTileRows; ++h) {
    const int r = tid + h * NB;
    const int y = y0 - (ky - 1) + py + r / HX, x = x0 - (kx - 1) + px + r % HX;
    grow[h] = r < NRW && y >= 0 && y < H && x >= 0 && x < W ? y * W + x : -1;
  }
  const int lx = tid % BX, ly = tid / BX;
  const int ux = x0 + lx, uy = y0 + ly;
  float acc[kChans];
#pragma unroll
  for (int c = 0; c < kChans; ++c) acc[c] = 0.f;
  // the planes vz = uz - tz + pz inside the volume: tz in [t0, t1]
  const int t0 = max(0, uz + pz - D + 1), t1 = min(kz - 1, uz + pz);
  KQ q[kTileQuads];
  float gq[kTileRows];
  auto load = [&](int tz) {
    const int64_t plane = (int64_t)(uz - tz + pz) * H * W;
    const TK* col = k + (int64_t)tz * NQ * kChans;
#pragma unroll
    for (int j = 0; j < kTileQuads; ++j)
      q[j] = MODE != 3 && prow[j] >= 0
                 ? (PF ? ld_l2_256<TK>(col + (plane + prow[j]) * TC +
                                       pq[j] * kChans)
                       : K::ldcg(col + (plane + prow[j]) * TC +
                                 pq[j] * kChans))
                 : KQ{};
#pragma unroll
    for (int h = 0; h < kTileRows; ++h)
      gq[h] = MODE != 3 && grow[h] >= 0 ? gr[plane + grow[h]] : 0.f;
  };
  if (PIPE && t0 <= t1) load(t0);
  for (int tz = t0; tz <= t1; ++tz) {
    if (!PIPE) load(tz);
    __syncthreads();  // the previous plane's sums are done
#pragma unroll
    for (int j = 0; j < kTileQuads; ++j)
      if (tid + j * NB < NRW * NQ) wt[tid + j * NB] = q[j];
#pragma unroll
    for (int h = 0; h < kTileRows; ++h)
      if (tid + h * NB < NRW) gt[tid + h * NB] = gq[h];
    __syncthreads();
    if (PIPE && tz < t1) load(tz + 1);
    if (MODE == 2) continue;
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
      const int vy = uy - ty + py;
#pragma unroll
      for (int tx = 0; tx < kRowTaps; ++tx) {
        const int vx = ux - tx + px;
        if (ty < ky && tx < kx && vy >= 0 && vy < H && vx >= 0 && vx < W) {
          const int r = (ly + ky - 1 - ty) * HX + lx + kx - 1 - tx;
          const KQ w = wt[r * NQ + ty * kx + tx];
          const float gv = gt[r];
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            float p = __fmul_rn(K::chan(w, c), gv);
            if (round_q) p = to_f32(from_f32<TK>(p));
            acc[c] = __fadd_rn(acc[c], p);
          }
        }
      }
    }
  }
  if (ux < W && uy < H)
    store_quad(dx + ((int64_t)uz * H * W + (int64_t)uy * W + ux) * kChans,
               acc);
}

template <int BX, int BY, int PIPE, int MODE, int ZFAST = 0, int PF = 0>
int launch_tile(const float* gr, const bf16* k, bf16* dx, const Geo& g,
                int round_q, cudaStream_t s) {
  const int hx = BX + (int)g.kx - 1, hy = BY + (int)g.ky - 1;
  const size_t smem =
      (size_t)hx * hy * (g.ky * g.kx * g.C * sizeof(bf16) + sizeof(float));
  const unsigned blocks = (unsigned)(((g.W + BX - 1) / BX) *
                                     ((g.H + BY - 1) / BY) * g.D);
  dx_keras_tile<bf16, bf16, BX, BY, PIPE, MODE, ZFAST, PF>
      <<<blocks, BX * BY, smem, s>>>(gr, k, dx, g, round_q);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The tile design staged by cp.async, two planes in flight (double
// buffered): each halo row's run of ky * kx quads (8 * NQ bytes, starting 0
// or 8 bytes past a 16-byte boundary in bf16) is copied as the NP aligned
// 16-byte pieces around it; a piece that would pass the end of k is read
// by an 8-byte load instead.
template <int BX, int BY>
__global__ void __launch_bounds__(BX * BY)
dx_keras_tile_async(const float* __restrict__ gr, const bf16* __restrict__ k,
                    bf16* __restrict__ dx, Geo g, int round_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef Quad<bf16> K;
  typedef K::type KQ;
  constexpr int NB = BX * BY;
  constexpr int kPieces = ((BX + 2) * (BY + 2) * 5 + NB - 1) / NB;
  const int W = (int)g.W, H = (int)g.H, D = (int)g.D;
  const int kz = (int)g.kz, ky = (int)g.ky, kx = (int)g.kx;
  const int pz = (int)g.pz, py = (int)g.py, px = (int)g.px;
  const int NQ = ky * kx, TC = kz * NQ * kChans;
  const int NP = (8 * NQ + 23) / 16, RS = NP * 16;
  const int HX = BX + kx - 1, HY = BY + ky - 1, NRW = HX * HY;
  const int64_t nk = (int64_t)W * H * D * TC;
  const int nbx = (W + BX - 1) / BX, nby = (H + BY - 1) / BY;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nby;
  const int uz = blockIdx.x / (nbx * nby);
  const int x0 = bx * BX, y0 = by * BY, tid = threadIdx.x;
  const int bufsz = NRW * (RS + 4);
  // piece p = tid + j NB: halo row p / NP, piece p % NP; the row's voxel in
  // its plane (-1 outside the volume or past the halo)
  int prow[kPieces], pc[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int p = tid + j * NB, r = p / NP;
    const int y = y0 - (ky - 1) + py + r / HX, x = x0 - (kx - 1) + px + r % HX;
    prow[j] = p < NRW * NP && y >= 0 && y < H && x >= 0 && x < W
                  ? y * W + x : -1;
    pc[j] = p % NP;
  }
  auto issue = [&](int tz, unsigned char* b) {
    const int64_t plane = (int64_t)(uz - tz + pz) * H * W;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      if (prow[j] < 0) continue;
      const int p = tid + j * NB, r = p / NP;
      const int64_t e = (plane + prow[j]) * TC + tz * NQ * kChans;
      const int64_t a = (e & ~(int64_t)7) + pc[j] * 8;
      unsigned char* dst = b + r * RS + pc[j] * 16;
      if (a + 8 <= nk)
        cp_async16(dst, k + a);
      else if (a < nk)
        *reinterpret_cast<uint2*>(dst) =
            __ldcg(reinterpret_cast<const uint2*>(k + a));
    }
    float* gb = reinterpret_cast<float*>(b + NRW * RS);
    for (int r = tid; r < NRW; r += NB) {
      const int y = y0 - (ky - 1) + py + r / HX;
      const int x = x0 - (kx - 1) + px + r % HX;
      if (y >= 0 && y < H && x >= 0 && x < W)
        cp_async4(gb + r, gr + plane + y * W + x);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int lx = tid % BX, ly = tid / BX;
  const int ux = x0 + lx, uy = y0 + ly;
  float acc[kChans];
#pragma unroll
  for (int c = 0; c < kChans; ++c) acc[c] = 0.f;
  const int t0 = max(0, uz + pz - D + 1), t1 = min(kz - 1, uz + pz);
  if (t0 <= t1) issue(t0, smem);
  for (int tz = t0; tz <= t1; ++tz) {
    unsigned char* b = smem + ((tz - t0) & 1) * bufsz;
    if (tz < t1) {
      issue(tz + 1, smem + ((tz + 1 - t0) & 1) * bufsz);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int64_t plane = (int64_t)(uz - tz + pz) * H * W;
    const float* gb = reinterpret_cast<const float*>(b + NRW * RS);
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
      const int vy = uy - ty + py;
#pragma unroll
      for (int tx = 0; tx < kRowTaps; ++tx) {
        const int vx = ux - tx + px;
        if (ty < ky && tx < kx && vy >= 0 && vy < H && vx >= 0 && vx < W) {
          const int r = (ly + ky - 1 - ty) * HX + lx + kx - 1 - tx;
          const int64_t e =
              (plane + (int64_t)vy * W + vx) * TC + tz * NQ * kChans;
          const KQ w = *reinterpret_cast<const KQ*>(
              b + r * RS + (int)(e & 7) * 2 + (ty * kx + tx) * 8);
          const float gv = gb[r];
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            float p = __fmul_rn(K::chan(w, c), gv);
            if (round_q) p = to_f32(from_f32<bf16>(p));
            acc[c] = __fadd_rn(acc[c], p);
          }
        }
      }
    }
    __syncthreads();  // this buffer is read before it is issued again
  }
  if (ux < W && uy < H)
    store_quad(dx + ((int64_t)uz * H * W + (int64_t)uy * W + ux) * kChans,
               acc);
}

template <int BX, int BY>
int launch_port(const float* gr, const bf16* k, bf16* dx, const Geo& g,
                int round_q, cudaStream_t s) {
  dx_keras_row<bf16, bf16, BX, BY>(gr, k, dx, g, round_q, s);
  return (int)cudaGetLastError();
}

template <int BX, int BY>
int launch_async(const float* gr, const bf16* k, bf16* dx, const Geo& g,
                 int round_q, cudaStream_t s) {
  const int hx = BX + (int)g.kx - 1, hy = BY + (int)g.ky - 1;
  const int np = (8 * (int)(g.ky * g.kx) + 23) / 16;
  const size_t smem = 2 * (size_t)hx * hy * (np * 16 + sizeof(float));
  const unsigned blocks = (unsigned)(((g.W + BX - 1) / BX) *
                                     ((g.H + BY - 1) / BY) * g.D);
  dx_keras_tile_async<BX, BY><<<blocks, BX * BY, smem, s>>>(gr, k, dx, g,
                                                             round_q);
  return (int)cudaGetLastError();
}

size_t smem_of(const Geo& g, int nb) {
  return (size_t)(nb + g.kx - 1) * g.kz * g.ky *
         (g.kx * g.C * sizeof(bf16) + sizeof(float));
}

}  // namespace

// mode: 0 the first design; 1-3 the row-group design, its staging alone,
// its sums alone; 4-9 the tile design with two indices a quad: plain,
// pipelined, its staging alone, its sums alone, z fastest, L2::256B; 10
// the cp.async tile; 11-13 the port's body at 32 x 8, 8 x 16, 16 x 4; nb
// input voxels a block (modes 0-3); bf16 x and weights.
extern "C" int k9_variant(int mode, int nb, const float* gr, const void* k,
                          void* dx, const int64_t* geo, int round_q,
                          cudaStream_t s) {
  const Geo g = make_geo(geo);
  const bf16* kk = (const bf16*)k;
  bf16* d = (bf16*)dx;
  const unsigned blocks = (unsigned)((g.D * g.H * g.W + nb - 1) / nb);
  const size_t smem = smem_of(g, nb);
  switch (mode) {
    case 0:
      dx_keras_first<bf16, bf16><<<blocks, nb, smem, s>>>(gr, kk, d, g,
                                                          round_q);
      break;
    case 1:
      dx_keras_part<bf16, bf16, 0><<<blocks, nb, smem, s>>>(gr, kk, d, g,
                                                            round_q);
      break;
    case 2:
      dx_keras_part<bf16, bf16, 2><<<blocks, nb, smem, s>>>(gr, kk, d, g,
                                                            round_q);
      break;
    case 3:
      dx_keras_part<bf16, bf16, 3><<<blocks, nb, smem, s>>>(gr, kk, d, g,
                                                            round_q);
      break;
    case 4: return launch_tile<16, 8, 0, 0>(gr, kk, d, g, round_q, s);
    case 5: return launch_tile<16, 8, 1, 0>(gr, kk, d, g, round_q, s);
    case 6: return launch_tile<16, 8, 1, 2>(gr, kk, d, g, round_q, s);
    case 7: return launch_tile<16, 8, 1, 3>(gr, kk, d, g, round_q, s);
    case 8: return launch_tile<16, 8, 1, 0, 1>(gr, kk, d, g, round_q, s);
    case 9: return launch_tile<16, 8, 1, 0, 0, 1>(gr, kk, d, g, round_q, s);
    case 10: return launch_async<16, 8>(gr, kk, d, g, round_q, s);
    case 11: return launch_port<32, 8>(gr, kk, d, g, round_q, s);
    case 12: return launch_port<8, 16>(gr, kk, d, g, round_q, s);
    case 13: return launch_port<16, 4>(gr, kk, d, g, round_q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
'''

# name: (mode, voxels a block, whether dx must equal the one-voxel body's)
VARIANTS = {
    'first design': (0, 128, True),
    'row groups': (1, 128, True),
    'row groups NB=64': (1, 64, True),
    'row groups, stage only': (2, 128, False),
    'row groups, sums only': (3, 128, False),
    'tile 16x8, two indices': (4, 128, True),
    'tile 16x8, two indices, pipelined': (5, 128, True),
    '  the same, stage only': (6, 128, False),
    '  the same, sums only': (7, 128, False),
    '  the same, z fastest': (8, 128, True),
    '  the same, L2::256B': (9, 128, True),
    'cp.async tile 16x8': (10, 128, True),
    'keras_row at 32x8': (11, 256, True),
    'keras_row at 8x16': (12, 128, True),
    'keras_row at 16x4': (13, 64, True),
}
KS = (3, 3, 3)


def build():
    """Compile SOURCE with `lc.cu` into its own library under the build
    directory; return the loaded `k9_variant`."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), 'lc_keras_layouts')
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, n) for n in ('lc_keras_layouts.cu',
                                                    'liblc_keras_layouts.so'))
    with open(src, 'w') as f:
        f.write(SOURCE)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-I',
                          _build.CSRC, '-shared', '-o', lib, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{res.stdout}'
                           f'{res.stderr}')
    for line in (res.stdout + res.stderr).splitlines():
        if 'Compiling entry' in line or 'Used' in line:
            print('  nvcc: ' + line.strip())
    fn = ctypes.CDLL(lib).k9_variant
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def inputs(vol, gen):
    """x [1, vol^3, 4] bf16, keras weights [vol^3, 108] bf16 and their
    [1, 108, V] view, g [1, vol^3, 1] f32."""
    sp, v = (vol,) * 3, vol ** 3
    x = torch.randn((1, *sp, 4), generator=gen, device='cuda').bfloat16()
    k2 = torch.randn((v, 108), generator=gen, device='cuda').bfloat16()
    g = torch.randn((1, *sp, 1), generator=gen, device='cuda')
    return x, k2, lc_cuda._weight_view(k2, True), g


def main():
    if not torch.cuda.is_available():
        print('no CUDA device: lc_keras_layouts.py needs one', file=sys.stderr)
        return 1
    card = cs.phase_device()
    variant = build()
    gen = torch.Generator(device='cuda').manual_seed(11)
    rows, ok = [], True
    x, k2, kv, g = inputs(cs.LC_VOL, gen)
    shape = tuple(x.shape)
    geo, _, _ = lc_cuda._launch_args(shape, kv, KS, 'same', x.dtype)
    nbytes, flops = cs.lc_bound('lc_dx', x, kv, g)
    bound, _ = cs.bound_ms(nbytes, flops)
    read_ms = cs.time_ms(lambda: k2.sum(dtype=torch.float32))
    print(f'K9 keras at {list(shape)} bf16, round_q: bound {bound:.4f} ms '
          f'(bytes); read probe w.sum() {read_ms:.4f} ms', flush=True)

    def port(body):
        return lambda o: lc_cuda._dx_launch(g, kv, o, KS, 'same', True, body)

    def run(mode, nb):
        def fn(o):
            err = variant(mode, nb, g.data_ptr(), kv.data_ptr(), o.data_ptr(),
                          geo, 1, _build.stream_of(g))
            if err:
                raise RuntimeError(f'k9_variant {mode}: CUDA error {err}')
        return fn

    ref = torch.empty_like(x)
    port('voxel')(ref)
    fns = {'voxel': (port('voxel'), True),
           'keras_row': (port('keras_row'), True),
           **{n: (run(m, nb), eq) for n, (m, nb, eq) in VARIANTS.items()},
           'keras_row again': (port('keras_row'), True)}
    for name, (fn, must_equal) in fns.items():
        out = torch.empty_like(ref)
        fn(out)
        torch.cuda.synchronize()
        same = cs.bit_equal(out, ref)
        ok &= same or not must_equal
        ms = cs.time_ms(lambda: fn(out))
        print(f'  {name:32s} {ms:.4f} ms  bit-equal to voxel {same}'
              f'{"" if must_equal else " (diagnostic)"}', flush=True)
        rows.append({'case': 'head', 'variant': name, 'ms': ms,
                     'bound_ms': bound, 'bit_equal': same})
    y = torch.empty((1, *shape[1:4], 1), device='cuda')
    ms = cs.time_ms(lambda: lc_cuda._fwd_launch(x, kv, y, KS, 'same',
                                                'keras_row'))
    print(f'  K7 keras_row     {ms:.4f} ms', flush=True)
    rows.append({'case': 'head', 'variant': 'K7 keras_row', 'ms': ms})
    del x, k2, kv, g, ref, y
    # a volume whose weights stay in L2 when timed back to back
    x, k2, kv, g = inputs(48, gen)
    nbytes, flops = cs.lc_bound('lc_dx', x, kv, g)
    small, _ = cs.bound_ms(nbytes, flops)
    y, dx = torch.empty((1, 48, 48, 48, 1), device='cuda'), torch.empty_like(x)
    for name, fn in (
            ('K9 keras_row', lambda: lc_cuda._dx_launch(
                g, kv, dx, KS, 'same', True, 'keras_row')),
            ('K7 keras_row', lambda: lc_cuda._fwd_launch(
                x, kv, y, KS, 'same', 'keras_row')),
            ('read probe', lambda: k2.sum(dtype=torch.float32))):
        ms = cs.time_ms(fn)
        print(f'  48^3 {name:12s} {ms:.4f} ms (bytes bound {small:.4f})',
              flush=True)
        rows.append({'case': '48^3', 'variant': name, 'ms': ms,
                     'bound_ms': small})
    print(card)
    print(json.dumps({'ok': ok, 'card': card, 'rows': rows}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
