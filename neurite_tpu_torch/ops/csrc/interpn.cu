// K4: 3-D linear and nearest interpolation of a channels-last volume
// vol [B, D, H, W, C] at absolute voxel coordinates loc [B, P, 3] (P output
// points of any shape, flattened), out [B, P, C]; float32.
//
// Replaces both Pallas warp kernels of neurite_tpu/ops/pallas_warp.py:
// `_kernel` (v1, launched by `_warp_p`, pallas_call at :114) and `_kernel_v2`
// (v2, launched by `_warp_p2`, pallas_call at :302). Both compute
// `utils.core.interpn`; their windows exist only because Mosaic's gathers
// stay inside one vreg, and each is exact inside its window contract (v1
// clamps beyond the block spread, v2 zeroes beyond max_disp). A Hopper thread
// can load from any address, so this kernel is the exact, unbounded op, and
// equals each TPU kernel wherever that kernel's contract holds.
//
// What bounds it on the card: device memory. Per point it reads 12 bytes of
// loc and writes 4*C bytes of out; the 2 (nearest) or 8 (linear) corner
// reads of a smooth field hit neighbouring addresses, which L2 mostly serves.
// The arithmetic (floor, clamp, 8 weights) is a few dozen operations per
// point, far below the card's rate. One launch per call, all C channels in
// the thread, neighbouring threads on neighbouring points so the loc reads
// and out writes coalesce.
//
// Two bodies; `warp_cuda.plan` picks one and the launcher trusts it:
// - 'vec' (B * D * H * W * C, B * P * 3 and B * P * C below 2^31 and
//   B <= 65535: every call of the port's paths). All indices are 32-bit
//   and the batch item comes from blockIdx.y. A thread owns NP points 128
//   apart (`vec_points`: 4 for nearest, 1 for linear), so the lanes of a
//   warp sit on 32 consecutive points in every loc load, gather and out
//   store; it computes all its points' corner offsets and weights first,
//   then issues their 8*NP*C (linear) or NP*C (nearest) gathers through
//   the read-only path together (a filled point issues none). C = 1 and 3
//   are compiled with C known; any other C is a launch argument.
// - 'scalar' (past those sizes): one point a thread, int64 offsets, the
//   batch item by a division.
// What held the 'scalar' body back: 64-bit index arithmetic on every point
// (a division, eight offset products) and one dependent chain a point with
// few loads in flight; in the 64^3 calls of config #5 (9.4 MB each, one
// wave, L2-resident back to back) that chain and the fixed cost of the
// launch set the time, not bytes. `k4_layouts.py` (at the repo's root)
// times this body against the layouts it was chosen over, at the paths'
// shapes, all bit-equal (NVIDIA H100 80GB HBM3, 700 W):
//   layout                          64^3 C=3 lin  128^3 nearest  128^3 lin
//   'scalar'                        0.0074 ms     0.0188         0.0339
//   'vec', NP = 1                   0.0064        0.0162         0.0186
//   'vec', NP = 2                   0.0068        0.0152         0.0196
//   'vec', NP = 4                   0.0079        0.0144         0.0185
//   4 consecutive points, float4    0.0105        0.0150         0.0255
//   bytes bound                     0.0028        0.0125         0.0125
// The float4 layout (loc by three aligned 16-byte loads, out by C 16-byte
// stores) puts a thread on 4 consecutive points, so a warp's gather of one
// corner spans 128 points, not 32; and a 16-byte vector of loc holds 4/3
// of a point, so with lanes on consecutive points the three 4-byte loads
// a point coalesce into the same sectors anyway. Linear gains nothing from
// more points a thread (eight gathers a channel are already in flight);
// nearest does.

// Semantics, exactly as the plain version (`utils.core.interpn_plain`):
// - linear: loc0 = clip(floor(loc)), loc1 = clip(loc0 + 1); the weight of
//   corner bit 0 is loc1 - clip(loc) and of bit 1 one minus that (both
//   corners collapse onto the upper edge); corners summed in
//   itertools.product order, weights multiplied in axis order. The products
//   and sums are rounded one by one (__fmul_rn, __fadd_rn: no contraction to
//   FMA), so the result is the plain version's bit for bit;
// - nearest: round half to even (__float2int_rn, as jnp.round), then clip;
// - fill: a point whose unclipped loc is < 0 or > the last index on any axis
//   gets fill in every channel.
// Both bodies run this arithmetic for each point in the same order, so they
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clipf(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

__device__ __forceinline__ int64_t clipi(int v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ int clipi32(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

template <bool kNearest>
__global__ void interpn3d_kernel(const float* __restrict__ vol,
                                 const float* __restrict__ loc,
                                 float* __restrict__ out, int64_t B,
                                 int64_t D, int64_t H, int64_t W, int64_t C,
                                 int64_t P, int has_fill, float fill) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * P) return;
  const int64_t b = i / P;
  const float l[3] = {loc[3 * i], loc[3 * i + 1], loc[3 * i + 2]};
  const int64_t dims[3] = {D, H, W};
  float* o = out + i * C;

  if (has_fill) {
    bool oob = false;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      oob |= (l[d] < 0.f) | (l[d] > (float)(dims[d] - 1));
    if (oob) {
      for (int64_t c = 0; c < C; ++c) o[c] = fill;
      return;
    }
  }
  const float* v = vol + b * D * H * W * C;

  if (kNearest) {
    const int64_t z = clipi(__float2int_rn(l[0]), D - 1);
    const int64_t y = clipi(__float2int_rn(l[1]), H - 1);
    const int64_t x = clipi(__float2int_rn(l[2]), W - 1);
    const float* s = v + ((z * H + y) * W + x) * C;
    for (int64_t c = 0; c < C; ++c) o[c] = s[c];
    return;
  }

  int64_t idx[2][3];
  float wgt[2][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float hi = (float)(dims[d] - 1);
    const float cl = clipf(l[d], hi);
    const float f0 = clipf(floorf(l[d]), hi);
    const float f1 = clipf(f0 + 1.f, hi);
    idx[0][d] = (int64_t)f0;
    idx[1][d] = (int64_t)f1;
    wgt[0][d] = __fsub_rn(f1, cl);
    wgt[1][d] = __fsub_rn(1.f, wgt[0][d]);
  }
  float wt[8];
  int64_t off[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int cz = (k >> 2) & 1, cy = (k >> 1) & 1, cx = k & 1;
    wt[k] = __fmul_rn(__fmul_rn(wgt[cz][0], wgt[cy][1]), wgt[cx][2]);
    off[k] = ((idx[cz][0] * H + idx[cy][1]) * W + idx[cx][2]) * C;
  }
  for (int64_t c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      acc = __fadd_rn(acc, __fmul_rn(wt[k], v[off[k] + c]));
    o[c] = acc;
  }
}

// ---- K4 'vec' body: 32-bit, NP points a thread along the warp ----

constexpr int kVecThreads = 128;

// CT: the channels, known at compile time (1, 3), or 0 for C given at
// launch. A block owns NP * kVecThreads consecutive points of one batch
// item (the item from blockIdx.y); thread t owns its points
// u = k * kVecThreads + t (k < NP), so the lanes of a warp sit on 32
// consecutive points in every loc load, gather and out store. Each point's
// corners, weights, sums and fill test are the 'scalar' body's, in its
// order, in 32-bit indices; a filled point issues no gathers.
template <int NP, int CT, bool kNearest>
__global__ void __launch_bounds__(kVecThreads)
interpn3d_vec_kernel(const float* __restrict__ vol,
                     const float* __restrict__ loc, float* __restrict__ out,
                     int D, int H, int W, int Cr, int P, int has_fill,
                     float fill) {
  constexpr int K = kNearest ? 1 : 8;  // corners a point
  const int C = CT > 0 ? CT : Cr;
  const int u0 = blockIdx.x * (NP * kVecThreads) + threadIdx.x;
  const int i0 = blockIdx.y * P + u0;  // point k of the thread: i0 + k * 128
  const float* v = vol + blockIdx.y * (D * H * W * C);
  const int dims[3] = {D, H, W};

  bool live[NP], skip[NP];  // skip: past P, or filled: no gathers
  int off[NP][K];
  float wt[NP][K];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    live[k] = u0 + k * kVecThreads < P;
    const int i = i0 + k * kVecThreads;
    float lp[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) lp[d] = live[k] ? __ldg(loc + 3 * i + d) : 0.f;
    bool oob = false;
    if (has_fill) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        oob |= (lp[d] < 0.f) | (lp[d] > (float)(dims[d] - 1));
    }
    skip[k] = oob || !live[k];
    if (kNearest) {
      const int z = clipi32(__float2int_rn(lp[0]), D - 1);
      const int y = clipi32(__float2int_rn(lp[1]), H - 1);
      const int x = clipi32(__float2int_rn(lp[2]), W - 1);
      off[k][0] = ((z * H + y) * W + x) * C;
      continue;
    }
    int idx[2][3];
    float wgt[2][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float hi = (float)(dims[d] - 1);
      const float cl = clipf(lp[d], hi);
      const float f0 = clipf(floorf(lp[d]), hi);
      const float f1 = clipf(f0 + 1.f, hi);
      idx[0][d] = (int)f0;
      idx[1][d] = (int)f1;
      wgt[0][d] = __fsub_rn(f1, cl);
      wgt[1][d] = __fsub_rn(1.f, wgt[0][d]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int cz = (j >> 2) & 1, cy = (j >> 1) & 1, cx = j & 1;
      wt[k][j] = __fmul_rn(__fmul_rn(wgt[cz][0], wgt[cy][1]), wgt[cx][2]);
      off[k][j] = ((idx[cz][0] * H + idx[cy][1]) * W + idx[cx][2]) * C;
    }
  }

  // channel c of point k: the gathers of every (k, c) are independent, so
  // with C known they are issued before the first sum needs one
  auto value = [&](int k, int c) {
    if (skip[k]) return fill;
    if (kNearest) return __ldg(v + off[k][0] + c);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc = __fadd_rn(acc, __fmul_rn(wt[k][j], __ldg(v + off[k][j] + c)));
    return acc;
  };
  if constexpr (CT > 0) {
    float r[NP][CT];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
#pragma unroll
      for (int c = 0; c < CT; ++c) r[k][c] = value(k, c);
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (live[k]) {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          out[(i0 + k * kVecThreads) * CT + c] = r[k][c];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (live[k]) {
        for (int c = 0; c < C; ++c)
          out[(i0 + k * kVecThreads) * C + c] = value(k, c);
      }
    }
  }
}

// Points a thread of the 'vec' body, by method: nearest 4 (a point is one
// gather a channel, so more points keep more loads in flight), linear 1
// (eight gathers a channel already are; more points only cut the threads).
template <bool kNearest>
constexpr int vec_points() {
  return kNearest ? 4 : 1;
}

template <bool kNearest>
int launch_vec(const float* vol, const float* loc, float* out, int B, int D,
               int H, int W, int C, int P, int has_fill, float fill,
               cudaStream_t s) {
  constexpr int NP = vec_points<kNearest>();
  const int nb = NP * kVecThreads;  // points a block
  const dim3 grid((unsigned)(((int64_t)P + nb - 1) / nb), (unsigned)B);
  if (C == 1)
    interpn3d_vec_kernel<NP, 1, kNearest><<<grid, kVecThreads, 0, s>>>(
        vol, loc, out, D, H, W, C, P, has_fill, fill);
  else if (C == 3)
    interpn3d_vec_kernel<NP, 3, kNearest><<<grid, kVecThreads, 0, s>>>(
        vol, loc, out, D, H, W, C, P, has_fill, fill);
  else
    interpn3d_vec_kernel<NP, 0, kNearest><<<grid, kVecThreads, 0, s>>>(
        vol, loc, out, D, H, W, C, P, has_fill, fill);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neurite_interpn3d_f32(const float* vol, const float* loc,
                                     float* out, int64_t B, int64_t D,
                                     int64_t H, int64_t W, int64_t C,
                                     int64_t P, int nearest, int has_fill,
                                     float fill, cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = B * P;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (nearest)
    interpn3d_kernel<true><<<blocks, threads, 0, stream>>>(
        vol, loc, out, B, D, H, W, C, P, has_fill, fill);
  else
    interpn3d_kernel<false><<<blocks, threads, 0, stream>>>(
        vol, loc, out, B, D, H, W, C, P, has_fill, fill);
  return (int)cudaGetLastError();
}

// The 'vec' body, on `warp_cuda.plan`'s conditions: B * D * H * W * C,
// B * P * 3 and B * P * C below 2^31, B <= 65535.
extern "C" int neurite_interpn3d_vec_f32(const float* vol, const float* loc,
                                         float* out, int64_t B, int64_t D,
                                         int64_t H, int64_t W, int64_t C,
                                         int64_t P, int nearest, int has_fill,
                                         float fill, cudaStream_t stream) {
  if (B * P == 0) return 0;
  const int b = (int)B, d = (int)D, h = (int)H, w = (int)W, c = (int)C,
            p = (int)P;
  return nearest ? launch_vec<true>(vol, loc, out, b, d, h, w, c, p,
                                    has_fill, fill, stream)
                 : launch_vec<false>(vol, loc, out, b, d, h, w, c, p,
                                     has_fill, fill, stream);
}
