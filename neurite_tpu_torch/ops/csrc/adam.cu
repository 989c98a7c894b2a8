// K11: one Adam step over a group of tensors of one dtype (float32 or
// bfloat16), in one pass: each element's parameter, gradient and two moments
// are read once, the update is computed in float32, and the parameter and
// the moments are written once each, rounded to their own type (round to
// nearest even).
//
// Replaces no Pallas kernel: the JAX package leaves Adam to `optax.adam`.
// It was added because torch.optim.Adam's foreach path makes seven passes
// over each tensor (lerp_, mul_, addcmul_, sqrt, div_, add_, addcdiv_), each
// reading and writing device memory again and rounding to the stored type
// again, in many launches a step.
//
// What bounds it on the card: device memory. An element reads four values
// and writes three, 14 bytes a bfloat16 parameter and 28 a float32 one, for
// about a dozen float32 operations, far under the card's arithmetic rate.
// What the design does about it: one read and one write of each stream, by
// 16-byte loads and stores (8 bfloat16 or 4 float32 a thread a stream,
// kUnroll vectors of each in flight) with evict-first cache hints, since
// nothing is read twice and the streams are far larger than the 50 MB L2.
// One launch takes a whole group: the tensors' pointers and lengths travel
// in the kernel's arguments as a table, each tensor is cut into chunks of
// kThreads * kUnroll vectors (or elements, for the scalar body), and the
// blocks walk over all the chunks of all the tensors. Offsets are 64-bit.
// Two bodies, picked a tensor at a time by `adam.plan` and trusted here:
// - 'vec': all four streams 16-byte aligned and the length a multiple of
//   the vector's width;
// - 'scalar': any other tensor, one element a thread a step.
// The step size and bias corrections come from the host as arguments, so a
// step needs no read of the device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 64;  // rows of a launch's table
constexpr int kThreads = 256;
constexpr int kUnroll = 2;       // vectors (or elements) of each stream in
                                 // flight a thread: 2 keeps a thread at 78
                                 // registers, three blocks an SM; 4 takes
                                 // 138, one block, 2 % slower at config #3

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* m[kMaxTensors];
  void* v[kMaxTensors];
  int64_t n[kMaxTensors];
  int first[kMaxTensors + 1];      // the chunk each tensor starts at;
                                   // first[count]: the chunks of all
  unsigned char vec[kMaxTensors];  // 1: the 'vec' body, 0: the scalar body
  int count;
};

struct Hyper {
  float w1;            // 1 - b1, the weight of m's lerp towards g
  float b2, c2;        // b2 and 1 - b2
  float inv_bc2_sqrt;  // 1 / sqrt(1 - b2^t)
  float eps;
  float neg_step;      // -lr / (1 - b1^t)
};

template <typename T>
constexpr int kWidth = 16 / (int)sizeof(T);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// torch.optim.Adam's order: m.lerp_(g, 1 - b1) (torch's lerp: the first form
// for a weight under 0.5), v.mul_(b2).addcmul_(g, g, 1 - b2), denom =
// sqrt(v) / sqrt(1 - b2^t) + eps, p += -lr / (1 - b1^t) * m / denom
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& h) {
  m = h.w1 < 0.5f ? m + h.w1 * (g - m) : g - (g - m) * (1.f - h.w1);
  v = v * h.b2 + h.c2 * g * g;
  const float denom = sqrtf(v) * h.inv_bc2_sqrt + h.eps;
  p = p + h.neg_step * (m / denom);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* f) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < kWidth<T>; ++k) f[k] = to_float(e[k]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < kWidth<T>; ++k) e[k] = from_float<T>(f[k]);
  return r;
}

// chunk c of tensor i by the 'vec' body: vectors c * kThreads * kUnroll +
// threadIdx.x + u * kThreads, u < kUnroll, the loads of all four streams
// issued before any arithmetic
template <typename T>
__device__ __forceinline__ void vec_chunk(const Table& t, int i, int64_t c,
                                          const Hyper& h) {
  constexpr int W = kWidth<T>;
  const int64_t nv = t.n[i] / W;
  const int64_t base = c * (kThreads * kUnroll) + threadIdx.x;
  uint4* P = static_cast<uint4*>(t.p[i]);
  const uint4* G = static_cast<const uint4*>(t.g[i]);
  uint4* M = static_cast<uint4*>(t.m[i]);
  uint4* V = static_cast<uint4*>(t.v[i]);
  uint4 rp[kUnroll], rg[kUnroll], rm[kUnroll], rv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e = base + u * kThreads;
    if (e < nv) {
      rp[u] = __ldcs(P + e);
      rg[u] = __ldcs(G + e);
      rm[u] = __ldcs(M + e);
      rv[u] = __ldcs(V + e);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e = base + u * kThreads;
    if (e < nv) {
      float p[W], g[W], m[W], v[W];
      unpack<T>(rp[u], p);
      unpack<T>(rg[u], g);
      unpack<T>(rm[u], m);
      unpack<T>(rv[u], v);
#pragma unroll
      for (int k = 0; k < W; ++k) update(p[k], g[k], m[k], v[k], h);
      __stcs(P + e, pack<T>(p));
      __stcs(M + e, pack<T>(m));
      __stcs(V + e, pack<T>(v));
    }
  }
}

// chunk c of tensor i by the scalar body: elements c * kThreads * kUnroll +
// threadIdx.x + u * kThreads
template <typename T>
__device__ __forceinline__ void scalar_chunk(const Table& t, int i, int64_t c,
                                             const Hyper& h) {
  const int64_t n = t.n[i];
  const int64_t base = c * (kThreads * kUnroll) + threadIdx.x;
  T* P = static_cast<T*>(t.p[i]);
  const T* G = static_cast<const T*>(t.g[i]);
  T* M = static_cast<T*>(t.m[i]);
  T* V = static_cast<T*>(t.v[i]);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e = base + u * kThreads;
    if (e < n) {
      float p = to_float(P[e]), m = to_float(M[e]), v = to_float(V[e]);
      update(p, to_float(G[e]), m, v, h);
      P[e] = from_float<T>(p);
      M[e] = from_float<T>(m);
      V[e] = from_float<T>(v);
    }
  }
}

// the table stays in the kernel's parameter space (__grid_constant__): the
// binary search over its rows reads it there, never from a local copy
template <typename T>
__global__ void __launch_bounds__(kThreads)
    adam_fused_kernel(const __grid_constant__ Table t, const Hyper h) {
  const int total = t.first[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    // the tensor of chunk c: the last row that starts at or before it
    int lo = 0, hi = t.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.first[mid] <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    if (t.vec[lo])
      vec_chunk<T>(t, lo, c - t.first[lo], h);
    else
      scalar_chunk<T>(t, lo, c - t.first[lo], h);
  }
}

// one launch over `count` tensors: as many blocks as the card holds at once
// (or fewer where there are fewer chunks), each walking the chunks with a
// stride of the grid
template <typename T>
int launch(const void* p, const void* g, const void* m, const void* v,
           const void* n, const void* vec, int count, float w1, float b2,
           float c2, float inv_bc2_sqrt, float eps, float neg_step,
           void* stream) {
  if (count < 0 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  Table t;
  int64_t total = 0;
  for (int i = 0; i < count; ++i) {
    t.p[i] = static_cast<void* const*>(p)[i];
    t.g[i] = static_cast<void* const*>(g)[i];
    t.m[i] = static_cast<void* const*>(m)[i];
    t.v[i] = static_cast<void* const*>(v)[i];
    t.n[i] = static_cast<const int64_t*>(n)[i];
    t.vec[i] = static_cast<const unsigned char*>(vec)[i];
    t.first[i] = (int)total;
    const int64_t per =
        (int64_t)kThreads * kUnroll * (t.vec[i] ? kWidth<T> : 1);
    total += (t.n[i] + per - 1) / per;
    if (total > INT32_MAX) return (int)cudaErrorInvalidValue;
  }
  t.first[count] = (int)total;
  t.count = count;
  if (total == 0) return 0;
  static int per_sm = 0;  // resident blocks an SM, the same on every card
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_fused_kernel<T>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t most = (int64_t)per_sm * sms;
  const int grid = (int)(total < most ? total : most);
  const Hyper h{w1, b2, c2, inv_bc2_sqrt, eps, neg_step};
  adam_fused_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One Adam step of `count` (at most 64) float32 tensors in place. p, g, m,
// v: host arrays of `count` device pointers (parameters, gradients, first
// and second moments); n: a host array of `count` int64 lengths; vec: a
// host array of `count` bytes, 1 where `adam.plan` picked the 'vec' body.
// The hyper-parameters as `Hyper` names them.
int neurite_adam_f32(const void* p, const void* g, const void* m,
                     const void* v, const void* n, const void* vec, int count,
                     float w1, float b2, float c2, float inv_bc2_sqrt,
                     float eps, float neg_step, void* stream) {
  return launch<float>(p, g, m, v, n, vec, count, w1, b2, c2, inv_bc2_sqrt,
                       eps, neg_step, stream);
}

// The same for bfloat16 tensors (arithmetic in float32).
int neurite_adam_bf16(const void* p, const void* g, const void* m,
                      const void* v, const void* n, const void* vec, int count,
                      float w1, float b2, float c2, float inv_bc2_sqrt,
                      float eps, float neg_step, void* stream) {
  return launch<__nv_bfloat16>(p, g, m, v, n, vec, count, w1, b2, c2,
                               inv_bc2_sqrt, eps, neg_step, stream);
}

}  // extern "C"
