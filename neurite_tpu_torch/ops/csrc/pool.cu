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
// bytes. The TPU kernel's transposes, selector matmuls and VMEM budgeting
// existed only for Mosaic's lane layout and have no counterpart here.
//
// Forward (K1), two bodies; `pool_cuda.plan` picks one and the launcher
// trusts it:
// - 'vec' (C a multiple of 8 bf16 or 4 f32 channels, x and y 16-byte
//   aligned: every shape of the port's paths). A thread owns one 16-byte
//   vector of channels of one output voxel: eight 16-byte loads (the two
//   W taps of each (d, h) row lie side by side) and one 16-byte store, so
//   neighbouring threads read neighbouring 16 bytes and each sector is
//   loaded once. The output row (b, d2, h2) comes from blockIdx.y and
//   threadIdx.y, (w2, channel group) from the x dimension, all in 32-bit
//   arithmetic where every index fits (64-bit offsets otherwise); rows past
//   65535 blocks are walked by a grid-stride loop. It replaces a thread per
//   element whose four int64 divisions and eight 2-byte loads made the
//   scalar body bound by instruction issue, not by bytes.
// - 'scalar' (any other C or alignment): one thread per output element, as
//   the backward.
// Backward (K2): one thread per window with C fastest; it owns all 8 dx of
// its window, so it needs no atomics and no zero fill, and it recomputes the
// window max from the x it reads anyway instead of reading y.
//
// Semantics, as the plain version in ops/pool.py and the JAX reference:
// - forward: the max in (D, H, W) window order with a strict '>', compared in
//   float32; NaN propagates (the first NaN of a window is the result); the
//   result is the raw element of the winning tap, so signed zeros and NaN
//   payloads are the input's bits;
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

// ---- K1 'vec' body: one 16-byte vector of channels a thread ----

struct VecGeom {
  int64_t D, H, W, C;   // input dims; D, H, W even
  int64_t D2, H2;       // output dims
  int64_t groups;       // 16-byte channel vectors a voxel: C / lanes
  int64_t per_row;      // vectors of an output row (b, d2, h2): W2 * groups
  int64_t rows;         // output rows: B * D2 * H2
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void or_word(uint4& v, int i, uint32_t b) {
  if (i == 0) v.x |= b;
  else if (i == 1) v.y |= b;
  else if (i == 2) v.z |= b;
  else v.w |= b;
}

// Raw bits of lane i of a 16-byte vector of kBits-bit elements.
template <int kBits>
__device__ __forceinline__ uint32_t lane_bits(const uint4& v, int i) {
  if (kBits == 32) return word(v, i);
  return (word(v, i >> 1) >> ((i & 1) * 16)) & 0xffffu;
}

// The float32 value of raw bits: a bfloat16 is the top half of its float32.
template <int kBits>
__device__ __forceinline__ float bits_f32(uint32_t b) {
  return __uint_as_float(kBits == 32 ? b : b << 16);
}

// I: the index type, int where every offset of x fits, int64_t otherwise.
// Block (tx, ty): threadIdx.x walks (w2, channel group) of a row, threadIdx.y
// the rows; no 64-bit division anywhere in the int body.
template <typename T, typename I>
__global__ void pool2_fwd_vec_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, VecGeom g) {
  constexpr int kBits = 8 * sizeof(T);
  constexpr int kLanes = 16 / sizeof(T);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (int)g.per_row) return;
  const int groups = (int)g.groups;
  const int w2 = j / groups;
  const I c = (I)(j - w2 * groups) * kLanes;
  const I C = (I)g.C, WC = (I)g.W * C, HWC = (I)g.H * WC;
  const I H2 = (I)g.H2, D2 = (I)g.D2;
  const I rows = (I)g.rows;
  const I row_step = (I)gridDim.y * blockDim.y;
  for (I r = (I)blockIdx.y * blockDim.y + threadIdx.y; r < rows;
       r += row_step) {
    const I h2 = r % H2;
    const I bd = r / H2;
    const I d2 = bd % D2;
    const I b = bd / D2;
    const I base = ((b * (I)g.D + 2 * d2) * (I)g.H + 2 * h2) * WC +
                   (I)(2 * w2) * C + c;
    uint4 tap[8];  // (pd, ph, pw) in (D, H, W) order
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      const T* p = x + base + ((t >> 2) & 1) * HWC + ((t >> 1) & 1) * WC;
      tap[t] = __ldg(reinterpret_cast<const uint4*>(p));
      tap[t + 1] = __ldg(reinterpret_cast<const uint4*>(p + C));
    }
    // per lane, first_max_tap's rule: strict '>' in float32, the first NaN
    // wins; the winner's raw bits are stored
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      uint32_t best = lane_bits<kBits>(tap[0], i);
      float m = bits_f32<kBits>(best);
#pragma unroll
      for (int t = 1; t < 8; ++t) {
        const uint32_t bt = lane_bits<kBits>(tap[t], i);
        const float v = bits_f32<kBits>(bt);
        if (!isnan(m) && (v > m || isnan(v))) {
          m = v;
          best = bt;
        }
      }
      or_word(out, kBits == 32 ? i : i >> 1,
              kBits == 32 ? best : best << ((i & 1) * 16));
    }
    __stcs(reinterpret_cast<uint4*>(y + (r * (I)g.per_row + j) * kLanes),
           out);
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
int launch_fwd_vec(const void* x, void* y, int64_t B, int64_t D, int64_t H,
                   int64_t W, int64_t C, int tx, int ty, int gx, int gy,
                   int wide, void* stream) {
  constexpr int kLanes = 16 / sizeof(T);
  const VecGeom g{D, H, W, C, D / 2, H / 2, C / kLanes,
                  (W / 2) * (C / kLanes), B * (D / 2) * (H / 2)};
  if (g.per_row == 0 || g.rows == 0) return 0;
  const dim3 grid(gx, gy), block(tx, ty);
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    pool2_fwd_vec_kernel<T, int64_t><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), g);
  else
    pool2_fwd_vec_kernel<T, int><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), g);
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

// The 'vec' body with pool_cuda.plan's block (tx, ty), grid (gx, gy) and
// index width (wide: 64-bit offsets).
int neurite_pool2_fwd_vec_f32(const void* x, void* y, int64_t B, int64_t D,
                              int64_t H, int64_t W, int64_t C, int tx, int ty,
                              int gx, int gy, int wide, void* stream) {
  return launch_fwd_vec<float>(x, y, B, D, H, W, C, tx, ty, gx, gy, wide,
                               stream);
}

int neurite_pool2_fwd_vec_bf16(const void* x, void* y, int64_t B, int64_t D,
                               int64_t H, int64_t W, int64_t C, int tx,
                               int ty, int gx, int gy, int wide,
                               void* stream) {
  return launch_fwd_vec<__nv_bfloat16>(x, y, B, D, H, W, C, tx, ty, gx, gy,
                                       wide, stream);
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
