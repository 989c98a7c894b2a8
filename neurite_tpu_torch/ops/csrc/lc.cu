// Locally-connected (unshared-weight) 3-D convolution, stride 1, 'same' or
// 'valid' padding: K7 forward, K8 kernel cotangent (dk), K9 input cotangent
// (dx), for float32 or bfloat16 x and weights (every load widened to f32).
//
// Replaces these TPU kernels:
// - K7: neurite_tpu/ops/pallas_lc2.py `_fwd_kernel` (pallas_call of
//   `_pallas_fwd`, :230) and neurite_tpu/ops/pallas_lc.py `_fwd_kernel`
//   (pallas_call of `_run_fwd`, :188);
// - K8: pallas_lc2.py `_dk_kernel` (`_pallas_dk`, :263) and pallas_lc.py
//   `_dk_kernel` (`_run_dk`, :220);
// - K9: pallas_lc.py `_dx_kernel` (`_run_dx`, :252), and the v2 path's dx,
//   which the JAX package leaves to XLA (`lc_tap.lc_transposed_dx`).
// The two Pallas versions differ only in the weight layout, so each kernel
// here takes the weights as element strides (s_o, s_t, s_v) of their
// [O, prod(k)*C, V] view: the transposed layout [O, TC, V] is
// (TC*V, V, 1) and the keras layout [V, TC, O] is (1, O, TC*O).
//
// What bounds them on the card: device memory. Each weight is used once per
// pass (one multiply-add a weight), so at the config #3 head (x [160^3, 4]
// bf16, weights [1, 108, 160^3] bf16) the 884.7 MB weight stream is nearly
// all of each kernel's bytes. The design keeps that stream read (K7, K9) or
// written (K8) once and coalesced: one thread per voxel, neighbouring threads
// on neighbouring voxels, so each tap row of the transposed weights is one
// contiguous run per warp. x is channels-last (8 bytes a voxel at C=4 bf16)
// and its 27-fold reuse is left to L1/L2. Zero padding is a per-axis bounds
// test on the input index, not a padded copy and not the v1 kernel's
// flat-shift masks. Each thread walks all taps of its voxel, so its voxel
// coordinates are decomposed once (32-bit: a volume has < 2^31 voxels; weight
// offsets are int64, since O*TC*V passes 2^31), and K8 and K9 handle four
// channels of a tap together, so their loads are in flight together.
//
// Each kernel has three bodies, picked by the caller (`lc_cuda.fwd_body`,
// `dk_body`, `dx_body`). With one voxel a thread (`lc_fwd_kernel`,
// `lc_dk_kernel`, `lc_dx_kernel`: any layout and shape) each weight is a
// 2-byte (bf16) load or store a thread, 64 bytes a warp: at the config #3
// head that is 13.8 M load or store instructions a warp for 885 MB, and the
// kernels ran at 0.65 (K8), 1.1 (K7) and 1.0 TB/s (K9) on an H100 80GB HBM3
// (700 W). The row bodies take B = 1, C = 4, kx <= 3 and Wo a multiple of
// 16 bytes of voxels (NV: 8 bf16 or 4 float32 weights) in the transposed
// layout (s_v = 1, rows and base 16-byte aligned): the config #3 head. A
// thread owns NV consecutive voxels of one row, so each (t, c, o) row is
// one aligned 16-byte streaming access a thread and 512 contiguous bytes a
// warp, and the weights are read (K7, K9) or written (K8) once without
// pushing x and g out of L2:
// - K8 (`lc_dk_row_kernel`) and K7 (`lc_fwd_row_kernel`) own NV output
//   voxels; per (tz, ty) they load the NV + kx - 1 input voxels their taps
//   along W reach once, four channels a load, and keep them in registers
//   for every tx and channel (K8: and filter). K7 loads the kx * 4 rows of
//   a (tz, ty) together, the taps in the padding too (they multiply 0).
// - K9 (`lc_dx_row_kernel`, 'same' padding only, so W = Wo) owns NV input
//   voxels: tap (tz, ty, tx) reads the output row at vx = ux + j + px - tx,
//   one voxel off the thread's aligned 16 bytes for the taps off the centre
//   along W. It loads its own aligned 16 bytes and takes the one element
//   beyond them from the neighbouring lane's (a warp shuffle; lanes 0 and
//   31 load it, 2 bytes), masked by its vx where a warp spans two rows.
// The keras row bodies ('keras_row') take the keras layout on the row
// bodies' head conditions but for the layout: the keras strides with a
// 16-byte aligned base, B = 1, C = 4, O = 1, ky and kx <= 3, x aligned to
// its voxels (K9: 'same' padding; every other keras shape takes the
// one-voxel body). In the keras layout a voxel's 108 weights at the head
// are one 216-byte run, so the one-voxel bodies' 2-byte accesses put
// neighbouring threads 216 bytes apart: every warp access touches 32
// sectors for 64 useful bytes. Each keras row body reads or writes those
// runs through shared memory instead:
// - K8 (`lc_dk_keras_row_kernel`): dk [V, TC, O] is one contiguous run; a
//   block of VB voxels (one a thread) computes its [VB, TC] part into
//   shared memory, four channels of a tap as one load of x and one 8- or
//   16-byte shared store, then streams it out in 16-byte chunks,
//   neighbouring threads on neighbouring chunks.
// - K7 (`lc_fwd_keras_row_kernel`), K8's in reverse: a block loads its
//   voxels' [VB, TC] run into shared memory by 16-byte streaming loads,
//   then each thread sums its voxel from there, a tap's four weights one
//   8- or 16-byte shared load.
// - K9 (`lc_dx_keras_row_kernel`): an input voxel takes weights from 27
//   output voxels, so a block owns a 16 x 8 tile of input voxels of one
//   z-plane and, per tz, stages the tz part of each output row its taps
//   reach (the ky * kx tap quads, 72 contiguous bytes of the run at the
//   head), lanes on consecutive quads; the other two parts of a row are
//   read by the blocks one plane before and after, which find them in L2.
// Measured at the head, bf16 (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py`
// phase 10): K8's keras row body 0.3290 ms against its one-voxel body's
// 8.3317, a 0.2788 ms bytes bound and 0.2685 ms for `zero_()` of the same
// bytes; K7's 0.3206 against 2.0134 and K9's 0.4165 against 0.9549
// (products rounded to bf16), both against a 0.2755 ms bound and 0.2929 ms
// for `w.sum()`; K9's designs side by side in `lc_keras_layouts.py`.
// The bytes each moves at the head: 884.7 MB of weights (K8 writes all of
// them; K7 and K9 read the 873.7 MB whose taps reach the volume, plus the
// few rows that a thread's 16 bytes share with them), 32.8 MB of x or dx
// and 16.4 MB of g or y. Measured at the head, bf16, on an H100 80GB HBM3
// (700 W; `chip_smoke.py` phase 10), against bytes bounds of 0.279 ms (K8)
// and 0.276 ms (K7, K9): K8's row body 0.33 ms, K7's 0.31 ms (the one-voxel
// body: 0.79), K9's 0.36 ms (0.85); the card reads the weights alone
// (`w.sum()`) in 0.30 ms.
//
// Semantics, exactly as the plain versions (ops/lc_tap.py):
// - K7: y[b, v, o] = sum over taps t, then channels c, of
//   f32(k[o, t*C+c, v]) * f32(x_tap), the first term then acc + term; a tap
//   in the padding multiplies 0 (as the padded copy does). y is f32.
// - K8: dk[o, t*C+c, v] = sum over b, left to right, of g[b, v, o] * x_tap,
//   in f32, cast once to the weights' dtype (round to nearest even). At B=1
//   this is the product rounded once, as pallas_lc2.py writes it; at B>1 the
//   batch fold of pallas_lc2.py:316-320 without an f32 [O, TC, V] temporary.
// - K9: dx[b, u, c] = sum over taps t (in order) whose output voxel
//   v = u - offs_t + pad lies inside, of m = sum over o (in order) of
//   k[o, t*C+c, v] * g[b, v, o]; with `round_q` each product is first rounded
//   to the weights' dtype (the v1 q, pallas_lc.py:292). The sum starts at
//   +0 and is rounded once to x's dtype, written by the kernel.
// Products and sums use __fmul_rn and __fadd_rn, so nvcc cannot contract them
// into FMAs: the kernels equal the plain versions bit for bit. Each row body
// keeps its one-voxel body's order for each voxel (and channel): K8's runs
// at B = 1 only, where each value is one product rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geo {
  int64_t B, D, H, W, C;  // x [B, D, H, W, C], channels-last, contiguous
  int64_t Do, Ho, Wo, O;  // y and g [B, Do, Ho, Wo, O], contiguous
  int64_t kz, ky, kx;     // kernel size
  int64_t pz, py, px;     // low padding ((k-1)/2 for 'same', 0 for 'valid')
  int64_t s_o, s_t, s_v;  // element strides of the weights' [O, TC, V] view
};

// Channels handled together by a K8 or K9 thread: their loads are issued
// together.
constexpr int kChans = 4;

// One thread per output voxel v (blockIdx.y: the batch item).
template <typename TX, typename TK>
__global__ void lc_fwd_kernel(const TX* __restrict__ x,
                              const TK* __restrict__ k, float* __restrict__ y,
                              Geo g) {
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vo) return;
  const int64_t b = blockIdx.y;
  const int wo = v % Wo, ho = (v / Wo) % Ho, zo = v / (Wo * Ho);
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W;
  const TX* xb = x + b * g.D * g.H * g.W * g.C;
  for (int64_t o = 0; o < g.O; ++o) {
    const TK* kv = k + o * g.s_o + v * g.s_v;
    float acc = -0.f;  // -0 + p == p for every p: the first term starts it
    int64_t tc = 0;
    for (int tz = 0; tz < (int)g.kz; ++tz) {
      const int zi = zo + tz - (int)g.pz;
      const bool okz = zi >= 0 && zi < D;
      for (int ty = 0; ty < (int)g.ky; ++ty) {
        const int yi = ho + ty - (int)g.py;
        const bool oky = okz && yi >= 0 && yi < H;
        for (int tx = 0; tx < (int)g.kx; ++tx) {
          const int xi = wo + tx - (int)g.px;
          const bool ok = oky && xi >= 0 && xi < W;
          const TX* xp = xb + ((int64_t)(zi * H + yi) * W + xi) * g.C;
#pragma unroll 4
          for (int64_t c = 0; c < g.C; ++c, ++tc) {
            const float xv = ok ? to_f32(xp[c]) : 0.f;
            acc = __fadd_rn(acc, __fmul_rn(to_f32(kv[tc * g.s_t]), xv));
          }
        }
      }
    }
    y[(b * Vo + v) * g.O + o] = acc;
  }
}

// One thread per output voxel v: every tap row of its weights, kChans
// channels at a time.
template <typename TX, typename TK>
__global__ void lc_dk_kernel(const float* __restrict__ gr,
                             const TX* __restrict__ x, TK* __restrict__ dk,
                             Geo g) {
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= Vo) return;
  const int wo = v % Wo, ho = (v / Wo) % Ho, zo = v / (Wo * Ho);
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W;
  const int64_t xstride = g.D * g.H * g.W * g.C;
  TK* dv = dk + v * g.s_v;
  for (int tz = 0; tz < (int)g.kz; ++tz) {
    const int zi = zo + tz - (int)g.pz;
    const bool okz = zi >= 0 && zi < D;
    for (int ty = 0; ty < (int)g.ky; ++ty) {
      const int yi = ho + ty - (int)g.py;
      const bool oky = okz && yi >= 0 && yi < H;
      for (int tx = 0; tx < (int)g.kx; ++tx) {
        const int xi = wo + tx - (int)g.px;
        const bool ok = oky && xi >= 0 && xi < W;
        const int64_t xoff = ((int64_t)(zi * H + yi) * W + xi) * g.C;
        const int64_t t = (tz * g.ky + ty) * g.kx + tx;
        for (int64_t c0 = 0; c0 < g.C; c0 += kChans) {
          for (int64_t o = 0; o < g.O; ++o) {
            float acc[kChans];
#pragma unroll
            for (int j = 0; j < kChans; ++j) acc[j] = -0.f;
            for (int64_t b = 0; b < g.B; ++b) {
              const float gv = gr[(b * Vo + v) * g.O + o];
              const TX* xp = x + b * xstride + xoff + c0;
#pragma unroll
              for (int j = 0; j < kChans; ++j) {
                if (c0 + j < g.C) {
                  const float xv = ok ? to_f32(xp[j]) : 0.f;
                  acc[j] = __fadd_rn(acc[j], __fmul_rn(gv, xv));
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kChans; ++j) {
              if (c0 + j < g.C)
                dv[(t * g.C + c0 + j) * g.s_t + o * g.s_o] =
                    from_f32<TK>(acc[j]);
            }
          }
        }
      }
    }
  }
}

// Four channels of one x voxel as one load: 8 bytes of bf16 (channel c in
// the high or low half of a word: its float32 bits are those 16 bits
// shifted up) or 16 of float32.
template <typename T>
struct Quad;
template <>
struct Quad<bf16> {
  typedef uint2 type;
  __device__ static uint2 load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static uint2 lds(const bf16* p) {  // from shared memory
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static uint2 ldcg(const bf16* p) {  // kept in L2, not L1
    return __ldcg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static float chan(uint2 q, int c) {
    const unsigned w = c < 2 ? q.x : q.y;
    return __uint_as_float(c & 1 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Quad<float> {
  typedef float4 type;
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 lds(const float* p) {  // from shared memory
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static float4 ldcg(const float* p) {  // kept in L2, not L1
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float chan(float4 q, int c) {
    return c == 0 ? q.x : (c == 1 ? q.y : (c == 2 ? q.z : q.w));
  }
};

// One row's 16 bytes of voxels, rounded once each, by a streaming store.
__device__ __forceinline__ void store_row(bf16* p, const float (&v)[8]) {
  union { uint4 u; unsigned short h[8]; } w;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w.h[j] = __bfloat16_as_ushort(from_f32<bf16>(v[j]));
  __stcs(reinterpret_cast<uint4*>(p), w.u);
}

__device__ __forceinline__ void store_row(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// NV voxels of 4 channels each, rounded once, by 16-byte stores: two voxels
// a store in bf16 (channel c of a voxel in the low or high half of word
// c / 2, as Quad<bf16> reads them), one in float32.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(from_f32<bf16>(lo)) |
         ((unsigned)__bfloat16_as_ushort(from_f32<bf16>(hi)) << 16);
}

template <int NV>
__device__ __forceinline__ void store_quads(bf16* p, const float (&a)[NV][4]) {
#pragma unroll
  for (int j = 0; j < NV; j += 2)
    reinterpret_cast<uint4*>(p)[j / 2] = make_uint4(
        pack_bf16(a[j][0], a[j][1]), pack_bf16(a[j][2], a[j][3]),
        pack_bf16(a[j + 1][0], a[j + 1][1]),
        pack_bf16(a[j + 1][2], a[j + 1][3]));
}

template <int NV>
__device__ __forceinline__ void store_quads(float* p,
                                            const float (&a)[NV][4]) {
#pragma unroll
  for (int j = 0; j < NV; ++j)
    reinterpret_cast<float4*>(p)[j] =
        make_float4(a[j][0], a[j][1], a[j][2], a[j][3]);
}

// Four values of one tap, rounded once each, by one 8-byte (bf16) or
// 16-byte (float32) store to an aligned address.
__device__ __forceinline__ void store_quad(bf16* p, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
}

__device__ __forceinline__ void store_quad(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

// Voxels a thread of the K8 row body owns: 16 bytes of weights.
template <typename TK>
__host__ __device__ constexpr int row_voxels() {
  return 16 / (int)sizeof(TK);
}

// Widest kernel along W that the row body takes.
constexpr int kRowTaps = 3;

// The K8 row body, for B = 1, C = 4 channels, kx <= 3 and Wo % NV == 0
// in the transposed layout, so a thread's NV voxels lie in one output row
// and each of its rows is one aligned 16-byte store: for each
// (tz, ty) it loads the NV + kx - 1 input voxels that its taps along W
// reach once (one 8- or 16-byte load each, zero in the padding) and keeps
// them in registers for every tx, channel and filter. At B = 1 each value
// is one product rounded once (-0 + p == p), so the row order does not
// change a bit.
template <typename TX, typename TK>
__global__ void __launch_bounds__(256)
lc_dk_row_kernel(const float* __restrict__ gr, const TX* __restrict__ x,
                 TK* __restrict__ dk, Geo g) {
  constexpr int NV = row_voxels<TK>();
  constexpr int NW = NV + kRowTaps - 1;
  typedef Quad<TX> Q;
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (grp >= Vo / NV) return;
  const int v0 = grp * NV;
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W, kx = (int)g.kx;
  const int wo = v0 % Wo, ho = (v0 / Wo) % Ho, zo = v0 / (Wo * Ho);
  const int O = (int)g.O;
  float g1[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) g1[j] = O == 1 ? gr[v0 + j] : 0.f;
  TK* dv = dk + v0;
  for (int tz = 0; tz < (int)g.kz; ++tz) {
    const int zi = zo + tz - (int)g.pz;
    for (int ty = 0; ty < (int)g.ky; ++ty) {
      const int yi = ho + ty - (int)g.py;
      const bool ok = zi >= 0 && zi < D && yi >= 0 && yi < H;
      const TX* xr = x + (ok ? (int64_t)(zi * H + yi) * W * kChans : 0);
      typename Q::type win[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int xi = wo - (int)g.px + w;
        win[w] = ok && w < NV + kx - 1 && xi >= 0 && xi < W
                     ? Q::load(xr + xi * kChans)
                     : typename Q::type{};
      }
      for (int o = 0; o < O; ++o) {
        float gv[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j)
          gv[j] = O == 1 ? g1[j] : gr[(int64_t)(v0 + j) * O + o];
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          if (tx >= kx) break;
          const int64_t t = (tz * g.ky + ty) * g.kx + tx;
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            float p[NV];
#pragma unroll
            for (int j = 0; j < NV; ++j)
              p[j] = __fmul_rn(gv[j], Q::chan(win[j + tx], c));
            store_row(dv + (t * kChans + c) * g.s_t + o * g.s_o, p);
          }
        }
      }
    }
  }
}

// The K8 keras row body (`lc_cuda.dk_body` -> 'keras_row'): dk in the keras
// layout [V, TC, O] is one contiguous run, V * TC * O elements. A block owns
// VB consecutive output voxels (one a thread) and their VB * TC run (O = 1),
// staged in shared memory: at B = 1, C = 4 and ky, kx <= 3 (the config #3
// head) each tap is one 8- or 16-byte load of x's four channels, the
// ky * kx loads of a tz plane issued together, and one 8- or 16-byte shared
// store. Then the block streams the tile out: thread i stores the 16-byte
// chunks i, i + VB, ... by streaming stores, so a warp writes 512
// contiguous bytes a store. VB * TC * sizeof(TK) <= 48 KB
// (`keras_tile_voxels`); the run of every block starts 16-byte aligned (VB
// is a multiple of 8) and the last block's tail is stored element by
// element. Each value is the one-voxel body's sum at B = 1: -0 + g * x,
// cast once.
template <typename TX, typename TK>
__global__ void __launch_bounds__(128)
lc_dk_keras_row_kernel(const float* __restrict__ gr, const TX* __restrict__ x,
                       TK* __restrict__ dk, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  TK* tile = reinterpret_cast<TK*>(smem);
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W;
  const int TC = (int)(g.kz * g.ky * g.kx) * kChans;
  const int VB = blockDim.x;
  const int v0 = blockIdx.x * VB;
  const int nv = min(VB, Vo - v0);
  if ((int)threadIdx.x < nv) {
    const int v = v0 + threadIdx.x;
    const int wo = v % Wo, ho = (v / Wo) % Ho, zo = v / (Wo * Ho);
    TK* tv = tile + threadIdx.x * TC;
    typedef Quad<TX> Q;
    const float gv = gr[v];
    for (int tz = 0; tz < (int)g.kz; ++tz) {
      const int zi = zo + tz - (int)g.pz;
      const bool okz = zi >= 0 && zi < D;
      typename Q::type q[kRowTaps][kRowTaps];
#pragma unroll
      for (int ty = 0; ty < kRowTaps; ++ty) {
        const int yi = ho + ty - (int)g.py;
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          const int xi = wo + tx - (int)g.px;
          const bool ok = okz && ty < (int)g.ky && tx < (int)g.kx &&
                          yi >= 0 && yi < H && xi >= 0 && xi < W;
          q[ty][tx] = ok ? Q::load(x + ((int64_t)(zi * H + yi) * W + xi) *
                                           kChans)
                         : typename Q::type{};
        }
      }
#pragma unroll
      for (int ty = 0; ty < kRowTaps; ++ty) {
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          float a[kChans];
#pragma unroll
          for (int c = 0; c < kChans; ++c)
            a[c] = __fadd_rn(-0.f, __fmul_rn(gv, Q::chan(q[ty][tx], c)));
          if (ty < (int)g.ky && tx < (int)g.kx)
            store_quad(tv + ((tz * g.ky + ty) * g.kx + tx) * kChans, a);
        }
      }
    }
  }
  __syncthreads();
  constexpr int NE = 16 / (int)sizeof(TK);  // elements a 16-byte chunk
  const int n = nv * TC;
  TK* dst = dk + (int64_t)v0 * TC;
  for (int i = threadIdx.x; i < n / NE; i += VB)
    __stcs(reinterpret_cast<uint4*>(dst) + i,
           reinterpret_cast<const uint4*>(tile)[i]);
  for (int i = n / NE * NE + threadIdx.x; i < n; i += VB) dst[i] = tile[i];
}

// 16 bytes of one weight row (NV consecutive voxels) by one streaming load
// (read once: it need not push x or g out of L2), and its element j widened
// to float32 (bf16 j in the low or high half of word j / 2).
template <typename T>
struct Row;
template <>
struct Row<bf16> {
  typedef uint4 type;
  __device__ static uint4 load(const bf16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static float elem(uint4 q, int j) {
    const unsigned w = j < 2 ? q.x : (j < 4 ? q.y : (j < 6 ? q.z : q.w));
    return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Row<float> {
  typedef float4 type;
  __device__ static float4 load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ static float elem(float4 q, int j) {
    return j == 0 ? q.x : (j == 1 ? q.y : (j == 2 ? q.z : q.w));
  }
};

// The K7 row body, for K8's row conditions (`lc_cuda.fwd_body`): a thread
// owns NV voxels of one output row. Per filter and (tz, ty) it loads the
// kx * 4 weight rows of its voxels together, one aligned 16-byte streaming
// load each (the taps in the padding too: they multiply 0, as the plain
// version's padded copy does), and the NV + kx - 1 input voxels its taps
// along W reach, as K8's row body does; each voxel's sum runs in the
// one-voxel body's order (taps, then channels, from -0). y is written by
// 16-byte stores at one filter, else one float a voxel.
template <typename TX, typename TK>
__global__ void __launch_bounds__(256)
lc_fwd_row_kernel(const TX* __restrict__ x, const TK* __restrict__ k,
                  float* __restrict__ y, Geo g) {
  constexpr int NV = row_voxels<TK>();
  constexpr int NW = NV + kRowTaps - 1;
  typedef Quad<TX> Q;
  typedef Row<TK> R;
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (grp >= Vo / NV) return;
  const int v0 = grp * NV;
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W, kx = (int)g.kx;
  const int wo = v0 % Wo, ho = (v0 / Wo) % Ho, zo = v0 / (Wo * Ho);
  const int O = (int)g.O;
  for (int o = 0; o < O; ++o) {
    const TK* kv = k + o * g.s_o + v0;
    float acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = -0.f;
    for (int tz = 0; tz < (int)g.kz; ++tz) {
      const int zi = zo + tz - (int)g.pz;
      for (int ty = 0; ty < (int)g.ky; ++ty) {
        const int yi = ho + ty - (int)g.py;
        const bool ok = zi >= 0 && zi < D && yi >= 0 && yi < H;
        const int64_t t0 = (tz * g.ky + ty) * g.kx;
        typename R::type w[kRowTaps][kChans];
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
#pragma unroll
          for (int c = 0; c < kChans; ++c)
            w[tx][c] = tx < kx ? R::load(kv + ((t0 + tx) * kChans + c) * g.s_t)
                               : typename R::type{};
        }
        const TX* xr = x + (ok ? (int64_t)(zi * H + yi) * W * kChans : 0);
        typename Q::type win[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int xi = wo - (int)g.px + i;
          win[i] = ok && i < NV + kx - 1 && xi >= 0 && xi < W
                       ? Q::load(xr + xi * kChans)
                       : typename Q::type{};
        }
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          if (tx >= kx) break;
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
#pragma unroll
            for (int j = 0; j < NV; ++j)
              acc[j] = __fadd_rn(acc[j], __fmul_rn(R::elem(w[tx][c], j),
                                                   Q::chan(win[j + tx], c)));
          }
        }
      }
    }
    if (O == 1) {
#pragma unroll
      for (int j = 0; j < NV; j += 4)
        *reinterpret_cast<float4*>(y + v0 + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) y[(int64_t)(v0 + j) * O + o] = acc[j];
    }
  }
}

// n elements of a 16-byte aligned run from src into the shared tile, by the
// block's threads: thread i loads the 16-byte chunks i, i + blockDim.x, ...
// by streaming loads (read once), kStage of them issued before any is
// stored, and the tail element by element.
template <typename T>
__device__ __forceinline__ void stage_run(const T* __restrict__ src, T* tile,
                                          int n) {
  constexpr int NE = 16 / (int)sizeof(T);
  constexpr int kStage = 8;
  const int nc = n / NE, step = blockDim.x;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(tile);
  for (int i0 = threadIdx.x; i0 < nc; i0 += kStage * step) {
    uint4 r[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j)
      if (i0 + j * step < nc) r[j] = __ldcs(s + i0 + j * step);
#pragma unroll
    for (int j = 0; j < kStage; ++j)
      if (i0 + j * step < nc) t[i0 + j * step] = r[j];
  }
  for (int i = nc * NE + threadIdx.x; i < n; i += step) tile[i] = src[i];
}

// The K7 keras row body (`lc_cuda.fwd_body` -> 'keras_row', on K8's keras
// row conditions): K8's keras row body in reverse. The keras weights
// [V, TC, O] (O = 1) are one contiguous run and an output voxel reads only
// its own TC of them, so a block of VB consecutive output voxels (one a
// thread) stages its [VB, TC] run in shared memory (`stage_run`: 16-byte
// streaming loads, neighbouring threads on neighbouring chunks), then each
// thread sums its voxel in the one-voxel body's order (taps, then channels,
// from -0): a tap's four weights one 8- or 16-byte shared load, x's four
// channels one load through L1/L2 (the ky * kx of a tz plane issued
// together), a tap in the padding multiplying 0. The tile is not padded: a
// thread's run is 8 (bf16) or 16 (f32) bytes a tap, 216 or 432 at the head
// (54 or 108 words, 22 or 12 mod 32), so the 8-byte loads of a half-warp, or
// the 16-byte loads of a quarter-warp, start on distinct banks. y is one
// float a voxel.
template <typename TX, typename TK>
__global__ void __launch_bounds__(128)
lc_fwd_keras_row_kernel(const TX* __restrict__ x, const TK* __restrict__ k,
                        float* __restrict__ y, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  TK* tile = reinterpret_cast<TK*>(smem);
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Vo = Wo * Ho * (int)g.Do;
  const int D = (int)g.D, H = (int)g.H, W = (int)g.W;
  const int ky = (int)g.ky, kx = (int)g.kx;
  const int TC = (int)g.kz * ky * kx * kChans;
  const int VB = blockDim.x;
  const int v0 = blockIdx.x * VB;
  const int nv = min(VB, Vo - v0);
  stage_run(k + (int64_t)v0 * TC, tile, nv * TC);
  __syncthreads();
  if ((int)threadIdx.x >= nv) return;
  typedef Quad<TX> Q;
  typedef Quad<TK> K;
  const int v = v0 + threadIdx.x;
  const int wo = v % Wo, ho = (v / Wo) % Ho, zo = v / (Wo * Ho);
  const TK* tv = tile + threadIdx.x * TC;
  float acc = -0.f;  // -0 + p == p for every p: the first term starts it
  for (int tz = 0; tz < (int)g.kz; ++tz) {
    const int zi = zo + tz - (int)g.pz;
    const bool okz = zi >= 0 && zi < D;
    typename Q::type q[kRowTaps][kRowTaps];
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
      const int yi = ho + ty - (int)g.py;
#pragma unroll
      for (int tx = 0; tx < kRowTaps; ++tx) {
        const int xi = wo + tx - (int)g.px;
        const bool ok = okz && ty < ky && tx < kx && yi >= 0 && yi < H &&
                        xi >= 0 && xi < W;
        q[ty][tx] = ok ? Q::load(x + ((int64_t)(zi * H + yi) * W + xi) *
                                         kChans)
                       : typename Q::type{};
      }
    }
#pragma unroll
    for (int ty = 0; ty < kRowTaps; ++ty) {
#pragma unroll
      for (int tx = 0; tx < kRowTaps; ++tx) {
        if (ty < ky && tx < kx) {
          const typename K::type w =
              K::lds(tv + ((tz * ky + ty) * kx + tx) * kChans);
#pragma unroll
          for (int c = 0; c < kChans; ++c)
            acc = __fadd_rn(acc, __fmul_rn(K::chan(w, c),
                                           Q::chan(q[ty][tx], c)));
        }
      }
    }
  }
  y[v] = acc;
}

// The K9 keras row body (`lc_cuda.dx_body` -> 'keras_row': K7's keras row
// conditions with 'same' padding). An input voxel u takes weights from the
// kz * ky * kx output voxels v = u - (t - p), and in the keras layout a
// row's TC weights are one run, [tz][ty][tx][c]: for one tz the ky * kx
// tap quads of a row are contiguous (72 bytes in bf16 at the head). So a
// block owns a BY x BX tile of input voxels of one z-plane (one a thread)
// and walks tz: it stages the (BY + ky - 1) x (BX + kx - 1) output rows of
// plane uz - tz + pz that the tile's taps reach, of each row the tz part of
// its run (lanes on consecutive tap quads of 8 or 16 bytes, by `__ldcg`:
// kept in L2, not L1) and g there; then each thread adds that plane's
// taps from shared memory, in the one-voxel body's order, a tap in the
// volume only; plane tz + 1's loads are issued before plane tz's sums, so
// they overlap. The sum starts at +0 (carried over tz in registers), each
// product rounded to the weights' dtype with round_q, and dx is rounded
// once, four channels by one 8- or 16-byte store. Each run part is read by
// one block, apart from the tile's halo; the other two parts of a row (the
// neighbouring planes' tz) are read by the blocks a plane before and after
// it in launch order, which find its sectors in L2. A thread keeps one
// plane offset a quad (`kTileQuads`): 80 registers in bf16, where two
// indices a quad took 122 and ran 1.16 times as long; rows
// 72 (bf16) or 144 (f32) bytes apart put a half-warp's 8-byte (a quarter-
// warp's 16-byte) shared loads on distinct banks. Why a tile and not a run
// of consecutive input voxels: such a block needs a separate kx * C chunk
// (24 bytes) of each row for each (tz, ty), which uses half of each 32-byte
// sector and spreads its loads over nine places; at the head it ran about
// 1.6 times as long (`lc_keras_layouts.py`).
constexpr int kTileX = 16, kTileY = 8;  // the tile of input voxels

template <typename TX, typename TK, int BX = kTileX, int BY = kTileY>
__global__ void __launch_bounds__(BX * BY)
lc_dx_keras_row_kernel(const float* __restrict__ gr, const TK* __restrict__ k,
                       TX* __restrict__ dx, Geo g, int round_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef Quad<TK> K;
  typedef typename K::type KQ;
  constexpr int NB = BX * BY;
  // tap quads and rows a thread stages a plane, at ky = kx = 3
  constexpr int kTileQuads = ((BX + 2) * (BY + 2) * 9 + NB - 1) / NB;
  constexpr int kTileRows = ((BX + 2) * (BY + 2) + NB - 1) / NB;
  const int W = (int)g.W, H = (int)g.H, D = (int)g.D;
  const int kz = (int)g.kz, ky = (int)g.ky, kx = (int)g.kx;
  const int pz = (int)g.pz, py = (int)g.py, px = (int)g.px;
  const int NQ = ky * kx, TC = kz * NQ * kChans;
  const int HX = BX + kx - 1, NRW = HX * (BY + ky - 1);
  const int nbx = (W + BX - 1) / BX, nby = (H + BY - 1) / BY;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nby;
  const int uz = blockIdx.x / (nbx * nby);
  const int x0 = bx * BX, y0 = by * BY, tid = threadIdx.x;
  KQ* wt = reinterpret_cast<KQ*>(smem);                 // [NRW][NQ]
  float* gt = reinterpret_cast<float*>(wt + NRW * NQ);  // [NRW]
  // quad p = tid + j NB is halo row p / NQ, tap p % NQ: its element offset
  // in a plane's weights, -1 outside the volume or past the halo (the
  // caller keeps H W TC < 2^31); and row tid + h NB's voxel in a plane
  int poff[kTileQuads], grow[kTileRows];
#pragma unroll
  for (int j = 0; j < kTileQuads; ++j) {
    const int p = tid + j * NB, r = p / NQ;
    const int y = y0 - (ky - 1) + py + r / HX, x = x0 - (kx - 1) + px + r % HX;
    poff[j] = p < NRW * NQ && y >= 0 && y < H && x >= 0 && x < W
                  ? (y * W + x) * TC + (p % NQ) * kChans : -1;
  }
#pragma unroll
  for (int h = 0; h < kTileRows; ++h) {
    const int r = tid + h * NB;
    const int y = y0 - (ky - 1) + py + r / HX, x = x0 - (kx - 1) + px + r % HX;
    grow[h] = r < NRW && y >= 0 && y < H && x >= 0 && x < W ? y * W + x : -1;
  }
  const int lx = tid % BX, ly = tid / BX, ux = x0 + lx, uy = y0 + ly;
  float acc[kChans];
#pragma unroll
  for (int c = 0; c < kChans; ++c) acc[c] = 0.f;
  // the taps whose plane vz = uz - tz + pz lies inside: tz in [t0, t1]
  const int t0 = max(0, uz + pz - D + 1), t1 = min(kz - 1, uz + pz);
  KQ q[kTileQuads];
  float gq[kTileRows];
  auto load = [&](int tz) {
    const int64_t plane = (int64_t)(uz - tz + pz) * H * W;
    const TK* run = k + plane * TC + tz * NQ * kChans;
#pragma unroll
    for (int j = 0; j < kTileQuads; ++j)
      q[j] = poff[j] >= 0 ? K::ldcg(run + poff[j]) : KQ{};
#pragma unroll
    for (int h = 0; h < kTileRows; ++h)
      gq[h] = grow[h] >= 0 ? gr[plane + grow[h]] : 0.f;
  };
  if (t0 <= t1) load(t0);
  for (int tz = t0; tz <= t1; ++tz) {
    __syncthreads();  // the previous plane's sums are done
#pragma unroll
    for (int j = 0; j < kTileQuads; ++j)
      if (tid + j * NB < NRW * NQ) wt[tid + j * NB] = q[j];
#pragma unroll
    for (int h = 0; h < kTileRows; ++h)
      if (tid + h * NB < NRW) gt[tid + h * NB] = gq[h];
    __syncthreads();
    if (tz < t1) load(tz + 1);
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
            acc[c] = __fadd_rn(acc[c], p);  // -0 + p == p: the one-voxel m
          }
        }
      }
    }
  }
  if (ux < W && uy < H)
    store_quad(dx + ((int64_t)uz * H * W + (int64_t)uy * W + ux) * kChans,
               acc);
}

// The element beyond a lane's aligned 16 bytes at ux of one row that tap
// shift d (vx = ux + j + d) needs, where the neighbouring lane that holds it
// is in another warp: lane 31 for d = 1, lane 0 for d = -1 (a 2-byte load,
// issued with the rows' loads); else 0.
template <int NV, typename TK>
__device__ __forceinline__ float edge(const TK* row, int d, int ux, int W,
                                      int lane, bool on) {
  if (d > 0) return lane == 31 && on && ux + NV < W ? to_f32(row[ux + NV]) : 0.f;
  if (d < 0) return lane == 0 && on && ux > 0 ? to_f32(row[ux - 1]) : 0.f;
  return 0.f;
}

// The weights at vx = ux + j + d (j < NV, d in {-1, 0, 1}, known at compile
// time) of one row, from the aligned 16 bytes q at ux that this lane loaded:
// d = 0 is q itself; the element off q's edge is the edge of the
// neighbouring lane's q (one shuffle), or e (`edge`) at lanes 31 and 0.
// Every lane of the warp calls it with the same d (the shuffle takes the
// full warp); the caller masks the elements outside [0, W), which the
// shuffle may bring from another row.
template <typename TK, int NV>
__device__ __forceinline__ void shifted_row(typename Row<TK>::type q, float e,
                                            int d, int lane, float (&w)[NV]) {
  typedef Row<TK> R;
  if (d > 0) {
    const float n = __shfl_down_sync(0xffffffffu, R::elem(q, 0), 1);
    e = lane == 31 ? e : n;
  } else if (d < 0) {
    const float n = __shfl_up_sync(0xffffffffu, R::elem(q, NV - 1), 1);
    e = lane == 0 ? e : n;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j)
    w[j] = d == 0 ? R::elem(q, j)
                  : (d > 0 ? (j + 1 < NV ? R::elem(q, j + 1) : e)
                           : (j > 0 ? R::elem(q, j - 1) : e));
}

// acc[j][c] += m[j] where tap shift d keeps voxel j's output voxel (vx =
// ux + j + d, in a row that is inside when ok) inside [0, W).
template <int NV>
__device__ __forceinline__ void add_tap(float (&acc)[NV][kChans], int c,
                                        const float (&m)[NV], int d, int ux,
                                        int W, bool ok) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int vx = ux + j + d;
    if (ok && vx >= 0 && vx < W) acc[j][c] = __fadd_rn(acc[j][c], m[j]);
  }
}

// The K9 row body, for B = 1, C = 4, kx <= 3, 'same' padding (W = Wo,
// PX = (kx - 1) / 2) and W % NV == 0 in the transposed layout
// (`lc_cuda.dx_body`): a thread owns NV input voxels u of one row, and tap
// (tz, ty, tx) reads the output row (vz, vy) at vx = ux + j + PX - tx. Per
// (tz, ty) it loads g at the NV + 2 voxels those taps reach and, at one
// filter, the kx * 4 weight rows together, one aligned 16-byte streaming
// load each at its own ux: the taps off the centre along W take the one
// element beyond from a neighbouring lane (`shifted_row`). Each (voxel,
// channel) sums as the one-voxel body does: m over filters in order (at one
// filter m is the product: -0 + p == p), then taps in order from +0, a tap
// whose output voxel lies outside skipped (+0 + m == m: the sum is never
// -0). Every lane runs every tap (a lane past the end works on the last
// group and stores nothing), so the shuffles see the whole warp. dx is
// written by 16-byte stores. Two blocks an SM (at most 128 registers) keep
// enough rows in flight.
template <typename TX, typename TK, int PX>
__global__ void __launch_bounds__(256, 2)
lc_dx_row_kernel(const float* __restrict__ gr, const TK* __restrict__ k,
                 TX* __restrict__ dx, Geo g, int round_q) {
  constexpr int NV = row_voxels<TK>();
  constexpr int NG = NV + kRowTaps - 1;
  typedef Row<TK> R;
  const int W = (int)g.W, H = (int)g.H, V = W * H * (int)g.D;
  const int ngrp = V / NV;
  const int grp0 = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = grp0 < ngrp;
  const int u0 = (live ? grp0 : ngrp - 1) * NV;
  const int ux = u0 % W, uy = (u0 / W) % H, uz = u0 / (W * H);
  const int Ho = (int)g.Ho, Do = (int)g.Do, O = (int)g.O, kx = (int)g.kx;
  const int lane = threadIdx.x & 31;
  float acc[NV][kChans];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int c = 0; c < kChans; ++c) acc[j][c] = 0.f;
  }
  for (int tz = 0; tz < (int)g.kz; ++tz) {
    const int vz = uz - tz + (int)g.pz;
    for (int ty = 0; ty < (int)g.ky; ++ty) {
      const int vy = uy - ty + (int)g.py;
      const bool ok = vz >= 0 && vz < Do && vy >= 0 && vy < Ho;
      const int64_t vrow = ok ? (int64_t)(vz * Ho + vy) * W : 0;
      // the rows of tap (tz, ty, 0), channel 0, filter 0
      const TK* kt = k + (tz * g.ky + ty) * g.kx * kChans * g.s_t + vrow;
      // filter 0's g at vx = ux + PX - (kRowTaps - 1) + i
      float g0[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int vx = ux + PX - (kRowTaps - 1) + i;
        g0[i] = ok && vx >= 0 && vx < W ? gr[(vrow + vx) * O] : 0.f;
      }
      if (O == 1) {
        typename R::type q[kRowTaps][kChans];
        float e[kRowTaps][kChans];
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            const TK* row = kt + (tx * kChans + c) * g.s_t;
            const bool on = ok && tx < kx;
            q[tx][c] = on ? R::load(row + ux) : typename R::type{};
            e[tx][c] = edge<NV>(row, PX - tx, ux, W, lane, on);
          }
        }
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          if (tx >= kx) break;
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            float w[NV], m[NV];
            shifted_row<TK, NV>(q[tx][c], e[tx][c], PX - tx, lane, w);
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              m[j] = __fmul_rn(w[j], g0[j + kRowTaps - 1 - tx]);
              if (round_q) m[j] = to_f32(from_f32<TK>(m[j]));
            }
            add_tap(acc, c, m, PX - tx, ux, W, ok);
          }
        }
      } else {
#pragma unroll
        for (int tx = 0; tx < kRowTaps; ++tx) {
          if (tx >= kx) break;
          const int d = PX - tx;
#pragma unroll
          for (int c = 0; c < kChans; ++c) {
            float w[NV], m[NV];
            for (int o = 0; o < O; ++o) {
              const TK* row = kt + (tx * kChans + c) * g.s_t + o * g.s_o;
              shifted_row<TK, NV>(
                  ok ? R::load(row + ux) : typename R::type{},
                  edge<NV>(row, d, ux, W, lane, ok), d, lane, w);
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                const int vx = ux + j + d;
                float p = __fmul_rn(
                    w[j], o == 0 ? g0[j + kRowTaps - 1 - tx]
                          : (ok && vx >= 0 && vx < W ? gr[(vrow + vx) * O + o]
                                                     : 0.f));
                if (round_q) p = to_f32(from_f32<TK>(p));
                m[j] = o == 0 ? p : __fadd_rn(m[j], p);
              }
            }
            add_tap(acc, c, m, d, ux, W, ok);
          }
        }
      }
    }
  }
  if (live) store_quads(dx + (int64_t)u0 * kChans, acc);
}

// One thread per input voxel u (blockIdx.y: the batch item): its C
// cotangents, kChans channels at a time.
template <typename TX, typename TK>
__global__ void lc_dx_kernel(const float* __restrict__ gr,
                             const TK* __restrict__ k, TX* __restrict__ dx,
                             Geo g, int round_q) {
  const int W = (int)g.W, H = (int)g.H, V = W * H * (int)g.D;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= V) return;
  const int64_t b = blockIdx.y;
  const int Wo = (int)g.Wo, Ho = (int)g.Ho, Do = (int)g.Do;
  const int ux = u % W, uy = (u / W) % H, uz = u / (W * H);
  const float* gb = gr + b * (int64_t)Wo * Ho * Do * g.O;
  for (int64_t c0 = 0; c0 < g.C; c0 += kChans) {
    float acc[kChans];
#pragma unroll
    for (int j = 0; j < kChans; ++j) acc[j] = 0.f;
    for (int tz = 0; tz < (int)g.kz; ++tz) {
      const int vz = uz - tz + (int)g.pz;
      if (vz < 0 || vz >= Do) continue;
      for (int ty = 0; ty < (int)g.ky; ++ty) {
        const int vy = uy - ty + (int)g.py;
        if (vy < 0 || vy >= Ho) continue;
        for (int tx = 0; tx < (int)g.kx; ++tx) {
          const int vx = ux - tx + (int)g.px;
          if (vx < 0 || vx >= Wo) continue;
          const int64_t v = (int64_t)(vz * Ho + vy) * Wo + vx;
          const int64_t t = (tz * g.ky + ty) * g.kx + tx;
          const TK* kp = k + (t * g.C + c0) * g.s_t + v * g.s_v;
          const float* gp = gb + v * g.O;
          float m[kChans];
#pragma unroll
          for (int j = 0; j < kChans; ++j) m[j] = -0.f;
          for (int64_t o = 0; o < g.O; ++o) {
            const float gv = gp[o];
#pragma unroll
            for (int j = 0; j < kChans; ++j) {
              if (c0 + j < g.C) {
                float p = __fmul_rn(to_f32(kp[j * g.s_t + o * g.s_o]), gv);
                if (round_q) p = to_f32(from_f32<TK>(p));
                m[j] = __fadd_rn(m[j], p);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kChans; ++j) acc[j] = __fadd_rn(acc[j], m[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kChans; ++j) {
      if (c0 + j < g.C) dx[(b * V + u) * g.C + c0 + j] = from_f32<TX>(acc[j]);
    }
  }
}

Geo make_geo(const int64_t* a) {
  return Geo{a[0],  a[1],  a[2],  a[3],  a[4],  a[5],  a[6],  a[7],  a[8],
             a[9],  a[10], a[11], a[12], a[13], a[14], a[15], a[16], a[17]};
}

constexpr int kThreads = 256;

// Shared memory a block of a keras row body may stage (no opt-in).
constexpr int64_t kKerasTileBytes = 48 * 1024;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// Voxels a block of the keras row body owns: the most of 128, 64 and 32
// whose [VB, TC] tile fits 48 KB of shared memory (the caller has checked
// that 32 do).
int keras_tile_voxels(const Geo& g, int elem) {
  const int64_t bytes = g.kz * g.ky * g.kx * g.C * elem;
  int vb = 128;
  while (vb > 32 && vb * bytes > kKerasTileBytes) vb /= 2;
  return vb;
}

// body: 0 the one-voxel body, 1 the row body, 2 the keras row body (each
// on its `lc_cuda.fwd_body` conditions).
template <typename TX, typename TK>
void fwd(const void* x, const void* k, float* y, const Geo& g, int body,
         cudaStream_t s) {
  const int64_t Vo = g.Do * g.Ho * g.Wo;
  if (body == 2) {
    const int vb = keras_tile_voxels(g, (int)sizeof(TK));
    const size_t smem = (size_t)vb * g.kz * g.ky * g.kx * g.C * sizeof(TK);
    lc_fwd_keras_row_kernel<TX, TK><<<(unsigned)((Vo + vb - 1) / vb), vb,
                                      smem, s>>>((const TX*)x, (const TK*)k,
                                                 y, g);
  } else if (body == 1) {
    lc_fwd_row_kernel<TX, TK>
        <<<blocks_for(Vo / row_voxels<TK>()), kThreads, 0, s>>>(
            (const TX*)x, (const TK*)k, y, g);
  } else {
    lc_fwd_kernel<TX, TK><<<dim3(blocks_for(Vo), (unsigned)g.B), kThreads, 0,
                            s>>>((const TX*)x, (const TK*)k, y, g);
  }
}

// body: 0 the one-voxel body, 1 the row body, 2 the keras row body (each
// on its `lc_cuda.dk_body` conditions).
template <typename TX, typename TK>
void dkk(const float* gr, const void* x, void* dk, const Geo& g, int body,
         cudaStream_t s) {
  const int64_t Vo = g.Do * g.Ho * g.Wo;
  if (body == 2) {
    const int vb = keras_tile_voxels(g, (int)sizeof(TK));
    const size_t smem = (size_t)vb * g.kz * g.ky * g.kx * g.C * sizeof(TK);
    const unsigned nb = (unsigned)((Vo + vb - 1) / vb);
    lc_dk_keras_row_kernel<TX, TK><<<nb, vb, smem, s>>>(gr, (const TX*)x,
                                                        (TK*)dk, g);
  } else if (body == 1) {
    lc_dk_row_kernel<TX, TK>
        <<<blocks_for(Vo / row_voxels<TK>()), kThreads, 0, s>>>(
            gr, (const TX*)x, (TK*)dk, g);
  } else {
    lc_dk_kernel<TX, TK><<<blocks_for(Vo), kThreads, 0, s>>>(
        gr, (const TX*)x, (TK*)dk, g);
  }
}

// Shared memory of a K9 keras row block: a plane's halo rows, ky * kx tap
// quads and one g each.
template <typename TK, int BX = kTileX, int BY = kTileY>
size_t keras_dx_smem(const Geo& g) {
  return (size_t)(BX + g.kx - 1) * (BY + g.ky - 1) *
         (g.ky * g.kx * g.C * sizeof(TK) + sizeof(float));
}

template <typename TX, typename TK, int BX = kTileX, int BY = kTileY>
void dx_keras_row(const float* gr, const void* k, void* dx, const Geo& g,
                  int round_q, cudaStream_t s) {
  const unsigned nb =
      (unsigned)(((g.W + BX - 1) / BX) * ((g.H + BY - 1) / BY) * g.D);
  lc_dx_keras_row_kernel<TX, TK, BX, BY>
      <<<nb, BX * BY, keras_dx_smem<TK, BX, BY>(g), s>>>(
          gr, (const TK*)k, (TX*)dx, g, round_q);
}

// body: 0 the one-voxel body, 1 the row body, 2 the keras row body (each
// on its `lc_cuda.dx_body` conditions).
template <typename TX, typename TK>
void dxk(const float* gr, const void* k, void* dx, const Geo& g, int round_q,
         int body, cudaStream_t s) {
  const int64_t V = g.D * g.H * g.W;
  if (body == 2) {
    dx_keras_row<TX, TK>(gr, k, dx, g, round_q, s);
    return;
  }
  const unsigned nb = blocks_for(V / row_voxels<TK>());
  if (body == 1 && g.px == 1)
    lc_dx_row_kernel<TX, TK, 1><<<nb, kThreads, 0, s>>>(gr, (const TK*)k,
                                                       (TX*)dx, g, round_q);
  else if (body == 1)
    lc_dx_row_kernel<TX, TK, 0><<<nb, kThreads, 0, s>>>(gr, (const TK*)k,
                                                       (TX*)dx, g, round_q);
  else
    lc_dx_kernel<TX, TK><<<dim3(blocks_for(V), (unsigned)g.B), kThreads, 0,
                           s>>>(gr, (const TK*)k, (TX*)dx, g, round_q);
}

}  // namespace

extern "C" {

// geo: the 18 int64 fields of Geo, in order. x_bf16 / k_bf16 pick the
// dtypes of x and of the weights (bfloat16 when 1, float32 when 0). The
// caller keeps each volume under 2^31 voxels and B under 65536. body picks
// the body, on the conditions `lc_cuda.fwd_body` and `dx_body` check: 0 the
// one-voxel body (any layout and shape), 1 the row body (B = 1, C = 4,
// kx <= 3, Wo % (16 bytes of weights) == 0, the transposed layout with
// 16-byte aligned rows and base, x aligned to its 4-channel voxels; K9 also
// 'same' padding), 2 the keras row body (the keras strides with a 16-byte
// aligned base, B = 1, C = 4, O = 1, ky and kx <= 3; K7: x aligned to its
// voxels and a 32-voxel tile within 48 KB; K9: 'same' padding and a
// z-plane's H W TC weights within 32-bit offsets).
int neurite_lc_fwd(const void* x, const void* k, float* y, const int64_t* geo,
                   int x_bf16, int k_bf16, int body, cudaStream_t stream) {
  const Geo g = make_geo(geo);
  if (g.B * g.Do * g.Ho * g.Wo == 0) return 0;
  if (x_bf16 && k_bf16) fwd<bf16, bf16>(x, k, y, g, body, stream);
  else if (x_bf16) fwd<bf16, float>(x, k, y, g, body, stream);
  else if (k_bf16) fwd<float, bf16>(x, k, y, g, body, stream);
  else fwd<float, float>(x, k, y, g, body, stream);
  return (int)cudaGetLastError();
}

// body (K8): 0 the one-voxel body, 1 the row body, 2 the keras row body
// (the keras strides, dk 16-byte aligned, B = 1, C = 4, O = 1, ky and
// kx <= 3, x aligned to its voxels, a [32, TC] tile within 48 KB).
int neurite_lc_dk(const float* gr, const void* x, void* dk, const int64_t* geo,
                  int x_bf16, int k_bf16, int body, cudaStream_t stream) {
  const Geo g = make_geo(geo);
  if (g.Do * g.Ho * g.Wo == 0) return 0;
  if (x_bf16 && k_bf16) dkk<bf16, bf16>(gr, x, dk, g, body, stream);
  else if (x_bf16) dkk<bf16, float>(gr, x, dk, g, body, stream);
  else if (k_bf16) dkk<float, bf16>(gr, x, dk, g, body, stream);
  else dkk<float, float>(gr, x, dk, g, body, stream);
  return (int)cudaGetLastError();
}

int neurite_lc_dx(const float* gr, const void* k, void* dx, const int64_t* geo,
                  int x_bf16, int k_bf16, int round_q, int body,
                  cudaStream_t stream) {
  const Geo g = make_geo(geo);
  if (g.B * g.D * g.H * g.W == 0) return 0;
  if (x_bf16 && k_bf16) dxk<bf16, bf16>(gr, k, dx, g, round_q, body, stream);
  else if (x_bf16) dxk<bf16, float>(gr, k, dx, g, round_q, body, stream);
  else if (k_bf16) dxk<float, bf16>(gr, k, dx, g, round_q, body, stream);
  else dxk<float, float>(gr, k, dx, g, round_q, body, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
