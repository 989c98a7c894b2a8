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
// point, far below the card's rate. So: one thread per output point, all C
// channels in the thread (one launch per call), neighbouring threads on
// neighbouring points so the loc reads and out writes coalesce.
//
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clipf(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

__device__ __forceinline__ int64_t clipi(int v, int64_t hi) {
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
