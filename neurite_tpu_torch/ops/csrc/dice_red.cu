// Per-label Dice sums over the voxels of two [bs, V, L] float32 maps:
// sum(x*y), sum(x*x) and sum(y*y), each [bs, L], accumulated in float32.
//
// Replaces the Pallas kernel of neurite_tpu/ops/dice_red.py: `_kernel`
// (launched by `_dice_sums_p`).
//
// What bounds it on the card: device memory. Each element of x and y is read
// once for three multiply-adds, far below the card's arithmetic rate. The
// design streams both maps once with coalesced loads: a block of G*L threads
// walks row b's V*L elements with a stride that is a multiple of L, so each
// thread always sees the same label and keeps its three sums in registers.
// The TPU kernel carried its sums across a sequential grid; blocks on the card
// run in parallel, so each block writes partials [bs, nblk, 3, L] and a second
// small launch adds them up. Both passes add in a fixed order and use no
// atomics, so a result is the same from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// grid (nblk, bs); blockDim.x is a multiple of L; dynamic shared memory holds
// 3 * blockDim.x floats.
__global__ void dice_partial_kernel(const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    float* __restrict__ partial, int64_t n,
                                    int L, int nblk) {
  extern __shared__ float sh[];
  const int64_t b = blockIdx.y;
  const float* xb = x + b * n;
  const float* yb = y + b * n;
  float sxy = 0.f, sxx = 0.f, syy = 0.f;
  const int64_t stride = (int64_t)nblk * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const float xv = xb[e];
    const float yv = yb[e];
    sxy += xv * yv;
    sxx += xv * xv;
    syy += yv * yv;
  }
  sh[threadIdx.x] = sxy;
  sh[blockDim.x + threadIdx.x] = sxx;
  sh[2 * blockDim.x + threadIdx.x] = syy;
  __syncthreads();
  // entry j = q * L + l: quantity q (xy, xx, yy) of label l, summed over the
  // threads t = l, l + L, ... in order
  for (int j = threadIdx.x; j < 3 * L; j += blockDim.x) {
    const int q = j / L;
    const int l = j % L;
    float s = 0.f;
    for (int t = l; t < (int)blockDim.x; t += L) s += sh[q * blockDim.x + t];
    partial[((b * nblk + blockIdx.x) * 3 + q) * L + l] = s;
  }
}

// grid (bs); out is [3, bs, L].
__global__ void dice_final_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int64_t bs, int L,
                                  int nblk) {
  const int64_t b = blockIdx.x;
  for (int j = threadIdx.x; j < 3 * L; j += blockDim.x) {
    const int q = j / L;
    const int l = j % L;
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += partial[((b * nblk + k) * 3 + q) * L + l];
    out[(q * bs + b) * L + l] = s;
  }
}

}  // namespace

extern "C" {

// x, y: [bs, V, L] float32, contiguous; partial: [bs, nblk, 3, L] scratch;
// out: [3, bs, L]. `threads` is a multiple of L, at most 1024.
int neurite_dice_sums_f32(const void* x, const void* y, void* partial,
                          void* out, int64_t bs, int64_t V, int L, int threads,
                          int nblk, void* stream) {
  if (bs == 0 || L == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  dice_partial_kernel<<<dim3(nblk, (unsigned)bs), threads,
                        3 * threads * sizeof(float), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partial), V * L, L, nblk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dice_final_kernel<<<(unsigned)bs, 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), bs, L,
      nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
