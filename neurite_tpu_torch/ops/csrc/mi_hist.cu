// Fused soft-quantize + mutual-information histograms of two [bs, V]
// float32 volumes with B bin centers each (1 <= B <= 16320):
//
//   xq[v][i] = exp(-alpha * (clip(x[v]) - cx[i])^2), yq likewise with cy,
//   pxy[i][j] = sum_v xq[v][i] * yq[v][j],  px[i] = sum_v xq[v][i],
//   py[j] = sum_v yq[v][j],  each [bs, ...], accumulated in float32.
//
// Replaces the Pallas kernel of neurite_tpu/ops/mi_hist.py: `_kernel`
// (launched by `_mi_histograms_p`, mi_hist.py:90).
//
// What bounds it on the card: operations. Per voxel it does 2*B^2 flops
// of the joint histogram and about 5*B of quantize (two maps of B bins,
// each an exp), against 8 bytes read: at B=16 that is ~670 flops for
// 8 bytes, far above the card's ~20 flop/byte balance in float32.
//
// The design keeps the [V, B] maps out of device memory. A block walks a
// strided range of tiles of T voxels: its threads clip the tile's x and y
// into shared memory, write the tile's maps xq[i][t], yq[j][t] there (t
// fastest, rows padded by 4 floats so that float4 reads of one t-quad by
// the lanes of a warp fall in distinct banks), and then each thread adds
// the tile into the (i, j) entries it owns, kept in registers across
// tiles; the first threads also sum px and py. Each thread reads two
// shared float4s per four multiply-adds: shared-memory bandwidth, not the
// FMA rate, is its limit (register tiling or mma is the next step). The
// TPU kernel carried its sums across a sequential grid; blocks here run in
// parallel, so each writes its partial sums [bs, nblk, B*B + 2B] and a
// second launch adds them in a fixed order. There are no atomics, so two
// calls give the same bits. The caller picks nblk (`mi_hist_cuda`), fewer
// as B grows, so that the partials stay bounded.
//
// Past kChunk bins: the bins are cut into chunks of kChunk, and the
// grid's third axis runs over the nc x nc pairs of chunks (nc =
// ceil(B / kChunk)). Block (ci, cj) builds the maps of its x-chunk ci and
// y-chunk cj only (shared memory stays at most 2 * kChunk * kRow floats),
// keeps its <= kChunk^2 pairs in registers and writes them to their own
// entries of the partials; the blocks with cj == 0 sum px of x-chunk ci,
// those with ci == 0 py of y-chunk cj. Each map is rebuilt nc times. At
// B <= kChunk there is one chunk: one block per tile range, as before.
//
// The clip keeps NaN (a compare, not fminf/fmaxf), as jnp.clip and the
// plain version do; voxels past V contribute nothing (the mask of
// mi_hist.py:54-60). expf is the accurate exp, not __expf. alpha comes by
// value or, for a 0-d device tensor, by pointer (read once per block), so
// the host never reads it back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // voxels per tile
constexpr int kRow = kTile + 4;  // padded row of a map in shared memory
constexpr int kThreads = 256;
constexpr int kChunk = 64;       // bins per chunk

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// grid (nblk, bs, nc * nc), blockIdx.z = ci * nc + cj; dynamic shared
// memory 2 * min(B, kChunk) * kRow floats. With Bx and By the bins of
// chunks ci and cj, thread tid owns the pairs p = tid + k * kThreads
// (k < MAXK, p < Bx*By), i = p / By, j = p % By: global bins
// (ci * kChunk + i, cj * kChunk + j).
template <int MAXK>
__global__ void __launch_bounds__(kThreads)
mi_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ cx, const float* __restrict__ cy,
                  float* __restrict__ partial, int64_t n, int B, int nblk,
                  float alpha_val, const float* __restrict__ alpha_ptr,
                  float lo, float hi) {
  extern __shared__ float4 sh4[];
  const int Bc = B < kChunk ? B : kChunk;
  float* xq = reinterpret_cast<float*>(sh4);   // [Bx][kRow]
  float* yq = xq + Bc * kRow;                  // [By][kRow]
  __shared__ float xs[kTile], ys[kTile], cxs[kChunk], cys[kChunk];
  __shared__ float alpha_sh;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = (B + kChunk - 1) / kChunk;
  const int ci = blockIdx.z / nc, cj = blockIdx.z % nc;
  const int x0 = ci * kChunk, y0 = cj * kChunk;
  const int Bx = B - x0 < kChunk ? B - x0 : kChunk;
  const int By = B - y0 < kChunk ? B - y0 : kChunk;
  const int Bm = Bx > By ? Bx : By;
  const bool sum_x = cj == 0, sum_y = ci == 0;
  const float* xb = x + b * n;
  const float* yb = y + b * n;
  if (tid < Bx) cxs[tid] = cx[x0 + tid];
  if (tid < By) cys[tid] = cy[y0 + tid];
  if (tid == 0) alpha_sh = alpha_ptr ? *alpha_ptr : alpha_val;

  int pi[MAXK], pj[MAXK];
  float acc[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int p = tid + k * kThreads;
    pi[k] = p < Bx * By ? p / By : 0;
    pj[k] = p < Bx * By ? p % By : 0;
    acc[k] = 0.f;
  }
  float accx = 0.f, accy = 0.f;

  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += nblk) {
    const int64_t v0 = tile * kTile;
    const int valid = (int)(n - v0 < kTile ? n - v0 : kTile);
    // stage the clipped tile
    if (tid < kTile) {
      if (tid < valid) xs[tid] = clip_keep_nan(xb[v0 + tid], lo, hi);
    } else if (tid < 2 * kTile) {
      const int t = tid - kTile;
      if (t < valid) ys[t] = clip_keep_nan(yb[v0 + t], lo, hi);
    }
    __syncthreads();
    const float alpha = alpha_sh;
    for (int r = tid; r < Bm * kTile; r += kThreads) {
      const int i = r / kTile;
      const int t = r % kTile;
      if (i < Bx) {
        float qx = 0.f;
        if (t < valid) {
          const float dx = xs[t] - cxs[i];
          qx = expf(-alpha * (dx * dx));
        }
        xq[i * kRow + t] = qx;
      }
      if (i < By) {
        float qy = 0.f;
        if (t < valid) {
          const float dy = ys[t] - cys[i];
          qy = expf(-alpha * (dy * dy));
        }
        yq[i * kRow + t] = qy;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAXK; ++k) {
      if (tid + k * kThreads < Bx * By) {
        const float4* xr = reinterpret_cast<const float4*>(xq + pi[k] * kRow);
        const float4* yr = reinterpret_cast<const float4*>(yq + pj[k] * kRow);
        float s = acc[k];
        for (int t4 = 0; t4 < kTile / 4; ++t4) {
          const float4 a = xr[t4];
          const float4 c = yr[t4];
          s = fmaf(a.x, c.x, s);
          s = fmaf(a.y, c.y, s);
          s = fmaf(a.z, c.z, s);
          s = fmaf(a.w, c.w, s);
        }
        acc[k] = s;
      }
    }
    if (sum_x && tid < Bx) {
      const float4* xr = reinterpret_cast<const float4*>(xq + tid * kRow);
      for (int t4 = 0; t4 < kTile / 4; ++t4) {
        const float4 a = xr[t4];
        accx = accx + a.x + a.y + a.z + a.w;
      }
    }
    if (sum_y && tid < By) {
      const float4* yr = reinterpret_cast<const float4*>(yq + tid * kRow);
      for (int t4 = 0; t4 < kTile / 4; ++t4) {
        const float4 c = yr[t4];
        accy = accy + c.x + c.y + c.z + c.w;
      }
    }
    // no barrier here: the next tile's staging writes only xs/ys, last
    // read before the barrier above, and its maps are written after the
    // next barrier, which every thread reaches only when done here
  }

  float* out = partial + (b * nblk + blockIdx.x) * (int64_t)(B * B + 2 * B);
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    const int p = tid + k * kThreads;
    if (p < Bx * By) out[(x0 + pi[k]) * B + y0 + pj[k]] = acc[k];
  }
  if (sum_x && tid < Bx) out[B * B + x0 + tid] = accx;
  if (sum_y && tid < By) out[B * B + B + y0 + tid] = accy;
}

// grid (ceil(E / 32), bs), 256 threads: warp w sums the partials of blocks
// [w * nblk / 8, (w + 1) * nblk / 8) for 32 entries, in order; then the
// first warp adds the eight sums in order. E = B*B + 2B entries, written
// to pxy [bs, B, B], px [bs, B] and py [bs, B].
__global__ void __launch_bounds__(256)
mi_final_kernel(const float* __restrict__ partial, float* __restrict__ pxy,
                float* __restrict__ px, float* __restrict__ py, int B,
                int nblk) {
  __shared__ float part[8][32];
  const int E = B * B + 2 * B;
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int k0 = (int)((int64_t)w * nblk / 8);
  const int k1 = (int)((int64_t)(w + 1) * nblk / 8);
  float s = 0.f;
  if (e < E) {
    const float* src = partial + b * nblk * (int64_t)E + e;
    for (int k = k0; k < k1; ++k) s += src[(int64_t)k * E];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < E) {
    float t = 0.f;
    for (int g = 0; g < 8; ++g) t += part[g][lane];
    if (e < B * B) {
      pxy[b * B * B + e] = t;
    } else if (e < B * B + B) {
      px[b * B + (e - B * B)] = t;
    } else {
      py[b * B + (e - B * B - B)] = t;
    }
  }
}

template <int MAXK>
cudaError_t launch_partial(const float* x, const float* y, const float* cx,
                           const float* cy, float* partial, int64_t bs,
                           int64_t V, int B, int nblk, float alpha,
                           const float* alpha_ptr, float lo, float hi,
                           cudaStream_t s) {
  const int Bc = B < kChunk ? B : kChunk;
  const unsigned nc = (unsigned)((B + kChunk - 1) / kChunk);
  const size_t smem = 2 * (size_t)Bc * kRow * sizeof(float);
  mi_partial_kernel<MAXK>
      <<<dim3(nblk, (unsigned)bs, nc * nc), kThreads, smem, s>>>(
          x, y, cx, cy, partial, V, B, nblk, alpha, alpha_ptr, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [bs, V] float32, contiguous; cx, cy: [B] float32 on the device;
// partial: [bs, nblk, B*B + 2B] scratch; pxy: [bs, B, B]; px, py: [bs, B].
// alpha is the RBF sharpness, read from alpha_ptr (one float32 on the
// device) when that is not null; lo and hi are the clip bounds (+-inf: no
// clip). The caller keeps ceil(B / 64)^2 <= 65535 (the grid's third axis).
int neurite_mi_hist_f32(const void* x, const void* y, const void* cx,
                        const void* cy, void* partial, void* pxy, void* px,
                        void* py, int64_t bs, int64_t V, int B, int nblk,
                        float alpha, const void* alpha_ptr, float lo, float hi,
                        void* stream) {
  if (bs == 0) return 0;
  const int64_t nc = (B + kChunk - 1) / kChunk;
  if (B < 1 || nc * nc > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float *xf = static_cast<const float*>(x),
              *yf = static_cast<const float*>(y),
              *cxf = static_cast<const float*>(cx),
              *cyf = static_cast<const float*>(cy),
              *af = static_cast<const float*>(alpha_ptr);
  float* pf = static_cast<float*>(partial);
  const int Bc = B < kChunk ? B : kChunk;
  cudaError_t err;
  if (Bc * Bc <= kThreads) {
    err = launch_partial<1>(xf, yf, cxf, cyf, pf, bs, V, B, nblk, alpha, af,
                            lo, hi, s);
  } else if (Bc * Bc <= 4 * kThreads) {
    err = launch_partial<4>(xf, yf, cxf, cyf, pf, bs, V, B, nblk, alpha, af,
                            lo, hi, s);
  } else {
    err = launch_partial<16>(xf, yf, cxf, cyf, pf, bs, V, B, nblk, alpha, af,
                             lo, hi, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int E = B * B + 2 * B;
  mi_final_kernel<<<dim3((E + 31) / 32, (unsigned)bs), 256, 0, s>>>(
      pf, static_cast<float*>(pxy), static_cast<float*>(px),
      static_cast<float*>(py), B, nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
