// Per-label Dice sums over the voxels of two [bs, V, L] float32 maps:
// sum(x*y), sum(x*x) and sum(y*y), each [bs, L], accumulated in float32.
//
// Replaces the Pallas kernel of neurite_tpu/ops/dice_red.py: `_kernel`
// (launched by `_dice_sums_p`).
//
// What bounds it on the card: device memory. Each element of x and y is read
// once for three multiply-adds, far below the card's arithmetic rate. The
// TPU kernel carried its sums across a sequential grid; blocks on the card
// run in parallel, so each block sums a share of the voxels and the blocks'
// partials [bs, nblk, 3, L] are added in a fixed order. No float atomics: a
// result is the same from run to run. Two bodies; `dice_red.plan` picks one
// and the launcher trusts it:
// - 'vec' (L a multiple of 4, both maps 16-byte aligned: the flagship's
//   L = 4 and config #5's L = 16). One launch. A thread streams float4s of x
//   and y, four pairs in flight, with a stride through row b that is a
//   multiple of L/4 float4s, so it always holds the same 4 labels; a block
//   adds its threads' sums by a fixed shared-memory tree and writes its
//   partials; the last block to finish (an atomic ticket on a counter)
//   adds every block's partials with its whole block, again by a fixed
//   tree, writes out and resets the counter. The ticket only picks WHICH
//   block adds; the order of the float additions never depends on it. This
//   replaces 4-byte loads and a second launch whose 3 * L threads each
//   added up to 1024 partials in a serial chain.
// - 'scalar' (any other L or alignment): a block of G*L threads walks row b
//   with a stride that is a multiple of L, each thread keeping one label's
//   three sums; a second small launch adds the partials.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- 'scalar' body: two launches ----

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

// ---- 'vec' body: one launch ----

constexpr int kUnroll = 4;  // float4 pairs in flight a thread

__device__ __forceinline__ void add_products(float4& sxy, float4& sxx,
                                             float4& syy, const float4& a,
                                             const float4& b) {
  sxy.x += a.x * b.x;
  sxy.y += a.y * b.y;
  sxy.z += a.z * b.z;
  sxy.w += a.w * b.w;
  sxx.x += a.x * a.x;
  sxx.y += a.y * a.y;
  sxx.z += a.z * a.z;
  sxx.w += a.w * a.w;
  syy.x += b.x * b.x;
  syy.y += b.y * b.y;
  syy.z += b.z * b.z;
  syy.w += b.w * b.w;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// grid (nblk, bs), blockDim.x = T a multiple of L4 = L / 4; dynamic shared
// memory holds 3 * T float4s. n4: float4s of a row (V * L / 4); n4 plus
// kUnroll strides fits 32 bits (dice_red.plan). partial: [bs, nblk, 3, L];
// out: [3, bs, L]; counter: one int, 0 at launch, 0 again at exit. `fin`
// threads add each of the bs * 3 * L / 4 float4 columns of partials in the
// last block.
//
// The counter is safe on one stream: the wrapper keeps one per (device,
// stream), and launches on a stream run one after the other, so a launch
// starts after the previous one's last block has reset it, and no launch
// sees another's tickets.
__global__ void dice_vec_kernel(const float4* __restrict__ x,
                                const float4* __restrict__ y,
                                float* __restrict__ partial,
                                float* __restrict__ out,
                                unsigned int* __restrict__ counter,
                                unsigned int n4, int L, int fin) {
  extern __shared__ float4 sh4[];
  __shared__ bool last;
  const int T = blockDim.x, tid = threadIdx.x, L4 = L / 4;
  const int nblk = gridDim.x, bs = gridDim.y, b = blockIdx.y;
  const float4* xb = x + (size_t)b * n4;
  const float4* yb = y + (size_t)b * n4;
  float4 sxy = make_float4(0.f, 0.f, 0.f, 0.f), sxx = sxy, syy = sxy;
  // this thread's float4s: e = blockIdx.x * T + tid + i * S, all of labels
  // 4 (tid % L4) .. 4 (tid % L4) + 3, in ascending e
  const unsigned int S = (unsigned int)nblk * T;
  unsigned int e = blockIdx.x * T + tid;
  for (; e + (kUnroll - 1) * S < n4; e += kUnroll * S) {
    float4 xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = __ldcs(xb + e + u * S);
      yv[u] = __ldcs(yb + e + u * S);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      add_products(sxy, sxx, syy, xv[u], yv[u]);
  }
  for (; e < n4; e += S)
    add_products(sxy, sxx, syy, __ldcs(xb + e), __ldcs(yb + e));

  // the block's sums: a pairwise tree over the P = T / L4 threads of each
  // label group, k = tid / L4: at step h = 1, 2, 4, ... thread k, a multiple
  // of 2h, adds thread k + h's sums
  sh4[tid] = sxy;
  sh4[T + tid] = sxx;
  sh4[2 * T + tid] = syy;
  __syncthreads();
  const int P = T / L4, k = tid / L4;
  for (int h = 1; h < P; h <<= 1) {
    if ((k & (2 * h - 1)) == 0 && k + h < P) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        add4(sh4[q * T + tid], sh4[q * T + tid + h * L4]);
    }
    __syncthreads();
  }
  if (tid < L4) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      reinterpret_cast<float4*>(
          partial + (((size_t)b * nblk + blockIdx.x) * 3 + q) * L)[tid] =
          sh4[q * T + tid];
    __threadfence();  // the partials are seen on the device before the ticket
  }
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(counter, 1u) == (unsigned int)(nblk * bs) - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's partials are seen before they are read

  // the last block: float4 column C = b * 3 L4 + c of the partials (c =
  // q * L4 + l4: labels 4 l4 .. 4 l4 + 3 of quantity q), summed over the
  // nblk blocks by `fin` threads (thread p of a column takes blocks p,
  // p + fin, ... in order), then a pairwise tree over those fin threads.
  // Neighbouring threads read neighbouring float4s of the partials.
  const float4* part4 = reinterpret_cast<const float4*>(partial);
  const int row4 = 3 * L4, cols = bs * row4;
  const int per_pass = cols < T ? cols : T, p = tid / per_pass;
  for (int c0 = 0; c0 < cols; c0 += per_pass) {
    const int col = c0 + tid % per_pass;
    const bool on = p < fin && col < cols;
    const int cb = col / row4, c = col - cb * row4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      const float4* src = part4 + (size_t)cb * nblk * row4 + c;
#pragma unroll 4
      for (int kb = p; kb < nblk; kb += fin)
        add4(s, __ldcg(src + (size_t)kb * row4));
    }
    sh4[tid] = s;
    __syncthreads();
    for (int h = 1; h < fin; h <<= 1) {
      if (on && (p & (2 * h - 1)) == 0 && p + h < fin)
        add4(sh4[tid], sh4[tid + h * per_pass]);
      __syncthreads();
    }
    if (on && p == 0) {
      const int q = c / L4;
      reinterpret_cast<float4*>(out + ((size_t)q * bs + cb) * L)[c - q * L4] =
          sh4[tid];
    }
    __syncthreads();
  }
  if (tid == 0) *counter = 0u;
}

}  // namespace

extern "C" {

// The 'scalar' body. x, y: [bs, V, L] float32, contiguous; partial:
// [bs, nblk, 3, L] scratch; out: [3, bs, L]. `threads` is a multiple of L,
// at most 1024.
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

// The 'vec' body, one launch, with dice_red.plan's threads (a multiple of
// L / 4), blocks per row and final threads per column. x, y: [bs, V, L]
// float32, contiguous, 16-byte aligned, L a multiple of 4; partial and out
// as above; counter: the stream's int, 0 between launches.
int neurite_dice_sums_vec_f32(const void* x, const void* y, void* partial,
                              void* out, void* counter, int64_t bs, int64_t V,
                              int L, int threads, int nblk, int fin,
                              void* stream) {
  if (bs == 0 || L == 0) return 0;
  dice_vec_kernel<<<dim3(nblk, (unsigned)bs), threads,
                    3 * threads * sizeof(float4), (cudaStream_t)stream>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(y),
      static_cast<float*>(partial), static_cast<float*>(out),
      static_cast<unsigned int*>(counter), (unsigned int)(V * L / 4), L, fin);
  return (int)cudaGetLastError();
}

}  // extern "C"
