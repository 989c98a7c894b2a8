// K6: one pass of the separable 3-D SAME blur. Viewing x [N, D, H, W] as
// [pre, L, post] around the blurred axis (L = its length, post = the product
// of the axes after it), out[p, i, q] = sum_t k[t] * x[p, i + t - r, q] with
// r = (K - 1) / 2 and zeros outside [0, L) (cross-correlation, zero padding,
// odd K). The blur of a volume is three launches, one per axis.
//
// Replaces the fused Pallas blur of neurite_tpu/ops/blur.py: `_blur_kernel`,
// launched by `_blur3d_p` (pallas_call at :118). That kernel existed to cut
// the volume's HBM round trips from three to one on the TPU, within VMEM's
// budget and a cap of 48 taps in all; the synthesis path needs 7, 41 and 165
// taps (a 165-tap window is wider than the 128-voxel axis, and its taps
// beyond the edge meet zeros). This kernel has no width cap.
//
// What bounds it on the card: at 7 taps, device memory (each pass reads and
// writes the volume once: 16.8 MB for 128^3 float32 over three passes); at
// 165 taps, float32 arithmetic outside the tensor cores (2 * V * K FLOP per
// pass as written; the taps that meet the zero padding, about a third at 165
// taps on 128 voxels, are work the function does not need). The design keeps each value read from device memory once per pass:
// a block stages a tile of TL outputs along L by TQ columns along q, with its
// 2r-row halo, in shared memory, and the taps beside it (they live in device
// memory: the sigma is drawn on the device). Each thread then sums K products
// out of shared memory into a register. With post > 1 a tile row is TQ
// consecutive floats, so the loads coalesce and threads of a warp read
// consecutive shared words; with post == 1 (the last axis) TQ is 1 and the
// rows themselves are consecutive. Fusing the three passes into one pass over
// the volume, as the TPU kernel does, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void blur_axis_kernel(const float* __restrict__ x,
                                 const float* __restrict__ taps,
                                 float* __restrict__ out, int64_t L,
                                 int64_t post, int K, int TL, int TQ,
                                 int64_t n_lt, int64_t n_qt) {
  extern __shared__ float smem[];
  float* sk = smem;      // K taps
  float* sx = smem + K;  // (TL + K - 1) rows of TQ columns
  const int r = K / 2;
  int64_t t = blockIdx.x;
  const int64_t qt = t % n_qt;
  t /= n_qt;
  const int64_t lt = t % n_lt;
  const int64_t p = t / n_lt;
  const int64_t i0 = lt * TL, q0 = qt * TQ;
  const float* xp = x + p * L * post;
  float* op = out + p * L * post;

  for (int j = threadIdx.x; j < K; j += blockDim.x) sk[j] = taps[j];
  const int rows = TL + K - 1;
  for (int j = threadIdx.x; j < rows * TQ; j += blockDim.x) {
    const int row = j / TQ, col = j % TQ;
    const int64_t i = i0 - r + row, q = q0 + col;
    sx[j] = (i >= 0 && i < L && q < post) ? xp[i * post + q] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < TL * TQ; j += blockDim.x) {
    const int row = j / TQ, col = j % TQ;
    const int64_t i = i0 + row, q = q0 + col;
    if (i >= L || q >= post) continue;
    const float* s = sx + row * TQ + col;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(sk[k], s[k * TQ], acc);
    op[i * post + q] = acc;
  }
}

}  // namespace

extern "C" int neurite_blur_axis_f32(const float* x, const float* taps,
                                     float* out, int64_t pre, int64_t L,
                                     int64_t post, int K, int TL, int TQ,
                                     cudaStream_t stream) {
  const int threads = 256;
  const int64_t n_lt = (L + TL - 1) / TL, n_qt = (post + TQ - 1) / TQ;
  const int64_t blocks = pre * n_lt * n_qt;
  if (blocks == 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)(TL + K - 1) * TQ + K);
  blur_axis_kernel<<<(unsigned)blocks, threads, smem, stream>>>(
      x, taps, out, L, post, K, TL, TQ, n_lt, n_qt);
  return (int)cudaGetLastError();
}
