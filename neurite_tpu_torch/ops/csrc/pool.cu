// 2x2x2 stride-2 max pool of a channels-last volume [B, D, H, W, C]:
// forward and first-max backward, in float32 and bfloat16.
//
// Replaces the Pallas kernels of neurite_tpu/ops/pool_pallas.py:
// `_fwd_kernel` (launched by `_call_fwd`) and `_bwd_kernel` (launched by
// `_call_bwd`).
//
// What bounds it on the card: device memory. The forward reads 8 values and
// writes 1 per output element; the backward reads 8 x and 1 g and writes 8 dx
// per window. There is no arithmetic to speak of, so the design is about
// bytes: one thread per output element (per window in the backward) with C
// fastest, so that neighbouring threads read neighbouring addresses of each of
// the 8 taps and every byte of x is read once. The backward owns all 8 dx of
// its window, so it needs no atomics and no zero fill, and it recomputes the
// window max from the x it reads anyway instead of reading y. The TPU kernel's
// transposes, selector matmuls and VMEM budgeting existed only for Mosaic's
// lane layout and have no counterpart here.
//
// Semantics, as the plain version in ops/pool.py and the JAX reference:
// - forward: the max in (D, H, W) window order with a strict '>'; NaN
//   propagates (the first NaN of a window is the result);
// - backward: g goes to the FIRST tap, in (D, H, W) order, whose value equals
//   the window max, compared in float32. In a window whose max is NaN no tap
//   equals it, and every tap receives g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

struct Geom {
  int64_t D, H, W, C;  // input dims; D, H, W even
  int64_t D2, H2, W2;  // output dims
};

// Offset of tap t = pd*4 + ph*2 + pw from the first element of its window.
__device__ __forceinline__ int64_t tap_offset(int t, const Geom& g) {
  return ((t >> 2) & 1) * g.H * g.W * g.C + ((t >> 1) & 1) * g.W * g.C +
         (t & 1) * g.C;
}

// Input offset of the first tap of the window of output element o.
__device__ __forceinline__ int64_t window_base(int64_t o, const Geom& g) {
  const int64_t c = o % g.C;
  o /= g.C;
  const int64_t w2 = o % g.W2;
  o /= g.W2;
  const int64_t h2 = o % g.H2;
  o /= g.H2;
  const int64_t d2 = o % g.D2;
  const int64_t b = o / g.D2;
  return (((b * g.D + 2 * d2) * g.H + 2 * h2) * g.W + 2 * w2) * g.C + c;
}

// Index of the window's first max in (D, H, W) order (strict '>'), or of its
// first NaN; the max itself, in float32, goes to *vmax.
template <typename T>
__device__ __forceinline__ int first_max_tap(const T* __restrict__ x,
                                             int64_t base, const Geom& g,
                                             float* vmax) {
  int best = 0;
  float m = to_f32(x[base]);
#pragma unroll
  for (int t = 1; t < 8; ++t) {
    const float v = to_f32(x[base + tap_offset(t, g)]);
    if (!isnan(m) && (v > m || isnan(v))) {
      m = v;
      best = t;
    }
  }
  *vmax = m;
  return best;
}

template <typename T>
__global__ void pool2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 int64_t n_out, Geom g) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out;
       o += stride) {
    const int64_t base = window_base(o, g);
    float m;
    const int t = first_max_tap(x, base, g, &m);
    y[o] = x[base + tap_offset(t, g)];  // the raw element: exact in any type
  }
}

template <typename T>
__global__ void pool2_bwd_kernel(const T* __restrict__ x,
                                 const T* __restrict__ gy, T* __restrict__ dx,
                                 int64_t n_out, Geom g) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t o = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; o < n_out;
       o += stride) {
    const int64_t base = window_base(o, g);
    float m;
    const int best = first_max_tap(x, base, g, &m);
    // first_max_tap's strict '>' keeps the first of equal maxima, so `best`
    // is the first tap equal to the max; a NaN max equals no tap.
    const bool every_tap = isnan(m);
    const T gv = gy[o];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      dx[base + tap_offset(t, g)] = (every_tap || t == best) ? gv : zero<T>();
    }
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;

Geom make_geom(int64_t D, int64_t H, int64_t W, int64_t C) {
  return Geom{D, H, W, C, D / 2, H / 2, W / 2};
}

int64_t n_blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t B, int64_t D, int64_t H,
               int64_t W, int64_t C, void* stream) {
  const Geom g = make_geom(D, H, W, C);
  const int64_t n = B * g.D2 * g.H2 * g.W2 * C;
  if (n == 0) return 0;
  pool2_fwd_kernel<T><<<(unsigned)n_blocks(n), kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* gy, void* dx, int64_t B, int64_t D,
               int64_t H, int64_t W, int64_t C, void* stream) {
  const Geom g = make_geom(D, H, W, C);
  const int64_t n = B * g.D2 * g.H2 * g.W2 * C;
  if (n == 0) return 0;
  pool2_bwd_kernel<T><<<(unsigned)n_blocks(n), kThreads, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy),
      static_cast<T*>(dx), n, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int neurite_pool2_fwd_f32(const void* x, void* y, int64_t B, int64_t D,
                          int64_t H, int64_t W, int64_t C, void* stream) {
  return launch_fwd<float>(x, y, B, D, H, W, C, stream);
}

int neurite_pool2_fwd_bf16(const void* x, void* y, int64_t B, int64_t D,
                           int64_t H, int64_t W, int64_t C, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, B, D, H, W, C, stream);
}

int neurite_pool2_bwd_f32(const void* x, const void* gy, void* dx, int64_t B,
                          int64_t D, int64_t H, int64_t W, int64_t C,
                          void* stream) {
  return launch_bwd<float>(x, gy, dx, B, D, H, W, C, stream);
}

int neurite_pool2_bwd_bf16(const void* x, const void* gy, void* dx, int64_t B,
                           int64_t D, int64_t H, int64_t W, int64_t C,
                           void* stream) {
  return launch_bwd<__nv_bfloat16>(x, gy, dx, B, D, H, W, C, stream);
}

const char* neurite_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
