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
// 8 bytes, far above the card's ~20 flop/byte balance in float32. In
// issued instructions the maps weigh more than the joint sums: an accurate
// expf with its argument, select and bin sum is ~14 instructions, so at
// B = 16 a voxel costs ~14 warp instructions of maps against ~9 of the
// joint loop (8 of them FMAs).
//
// The design keeps the [V, B] maps out of device memory and the joint sums
// in registers. A block walks a strided range of tiles of T voxels (256 up
// to 16 bins, 128 up to 32, else 64: `mi_hist_cuda.plan`), loading the
// next tile's x and y while it works on this one: its threads clip the
// tile into shared memory, then write the tile's maps voxel-major, xq[t][i]
// and yq[t][j] (bins fastest, rows of ceil(B/4) float4s), one accurate expf
// per (voxel, bin), four bins a thread side by side and one float4 store;
// each thread keeps its four bins' sums (px, py) in registers as it writes
// them, so the marginals cost no pass over shared memory. Then each thread
// adds the tile into a tile of 4 x 4 bin pairs that it owns, kept in
// registers across tiles: per voxel one float4 of xq and one of yq, two
// shared loads for 16 FMAs. The P = ceil(Bx/4) * ceil(By/4) pair tiles
// take P threads; the block's 256 threads form G = min(T, 256 / P) voxel
// groups (16 at B = 16, one at 64 bins), group g adding voxels g, g + G,
// ... of each tile. At the end of the block the groups' sums, and the map
// threads' bin sums, are added in a fixed order through shared memory. The
// TPU kernel carried its sums across a sequential grid; blocks here run in
// parallel, so each writes its partial sums [bs, nblk, B*B + 2B] and a
// second launch adds them in a fixed order (32 warps a block, each over
// its share of the blocks with 8 loads in flight). There are no atomics,
// so two calls give the same bits. The caller picks nblk (`mi_hist_cuda`),
// fewer as B grows, so that the partials stay bounded.
//
// Past kChunk bins: the bins are cut into chunks of kChunk, and the
// grid's third axis runs over the nc x nc pairs of chunks (nc =
// ceil(B / kChunk)). Block (ci, cj) builds the maps of its x-chunk ci and
// y-chunk cj only, keeps its <= kChunk^2 pairs in registers and writes
// them to their own entries of the partials; the blocks with cj == 0 sum
// px of x-chunk ci, those with ci == 0 py of y-chunk cj. Each map is
// rebuilt nc times. At B <= kChunk there is one chunk.
//
// The clip keeps NaN (a compare, not fminf/fmaxf), as jnp.clip and the
// plain version do; voxels past V contribute nothing (the mask of
// mi_hist.py:54-60). expf is the accurate exp, not __expf. alpha comes by
// value or, for a 0-d device tensor, by pointer (read once per block), so
// the host never reads it back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileMax = 256;    // voxels per tile, at most
constexpr int kThreads = 256;
constexpr int kChunk = 64;       // bins per chunk

__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Writes one tile's map q[t][i] = exp(-alpha (v[t] - c[i])^2) (0 past the
// tile's valid voxels and past the chunk's nb bins; rows of nq float4s):
// thread tid takes the bins 4 (tid % nq) + a, a < 4, of voxels tid / nq,
// + step, ... (four independent exps, one float4 store), and adds its
// values into m[a]; threads past nq * step do nothing. kMask: the tile or
// the row has such a past; without it (full tiles, 4 | nb) no select.
template <bool kMask>
__device__ __forceinline__ void write_map(float4* __restrict__ q,
                                          const float* __restrict__ v,
                                          const float* __restrict__ c, int nb,
                                          int nq, int T, int valid,
                                          float alpha, int tid, float m[4]) {
  const int step = kThreads / nq;
  if (tid >= nq * step) return;
  const int iq = tid % nq, i0 = 4 * iq;
  float ci[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) ci[a] = c[i0 + a];
#pragma unroll 2
  for (int t = tid / nq; t < T; t += step) {
    // no branches: the four exps run side by side, and a select (not a
    // product, which would keep a NaN) zeroes what lies past the tile's
    // voxels or the chunk's bins
    const float vt = v[t];
    float e[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float d = vt - ci[a];
      const float ex = expf(-alpha * (d * d));
      e[a] = !kMask || (t < valid && i0 + a < nb) ? ex : 0.f;
      m[a] += e[a];
    }
    q[t * nq + iq] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

// grid (nblk, bs, nc * nc), blockIdx.z = ci * nc + cj; T voxels a tile;
// dynamic shared memory `smem` bytes (`mi_hist_cuda.plan`): the maps, then
// at the end the groups' sums. With Bx and By the bins of chunks ci and cj,
// thread tid < G * P adds pair tile pt = tid % P (x-bins 4 * (pt / ntj) +
// a, y-bins 4 * (pt % ntj) + b, a and b < 4) for voxel group g = tid / P.
__global__ void __launch_bounds__(kThreads)
mi_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ cx, const float* __restrict__ cy,
                  float* __restrict__ partial, int64_t n, int B, int nblk,
                  float alpha_val, const float* __restrict__ alpha_ptr,
                  float lo, float hi, int T) {
  extern __shared__ float4 sh4[];
  __shared__ float xs[kTileMax], ys[kTileMax], cxs[kChunk], cys[kChunk];
  __shared__ float alpha_sh;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = (B + kChunk - 1) / kChunk;
  const int ci = blockIdx.z / nc, cj = blockIdx.z % nc;
  const int x0 = ci * kChunk, y0 = cj * kChunk;
  const int Bx = B - x0 < kChunk ? B - x0 : kChunk;
  const int By = B - y0 < kChunk ? B - y0 : kChunk;
  const int nti = (Bx + 3) / 4, ntj = (By + 3) / 4;  // float4s of a map row
  const int P = nti * ntj;
  const int G = kThreads / P < T ? kThreads / P : T;
  float4* xq = sh4;            // [T][nti]
  float4* yq = xq + T * nti;   // [T][ntj]
  const bool sum_x = cj == 0, sum_y = ci == 0;
  const float* xb = x + b * n;
  const float* yb = y + b * n;
  if (tid < kChunk) {
    cxs[tid] = tid < Bx ? cx[x0 + tid] : 0.f;
    cys[tid] = tid < By ? cy[y0 + tid] : 0.f;
  }
  if (tid == 0) alpha_sh = alpha_ptr ? *alpha_ptr : alpha_val;

  const bool active = tid < G * P;
  const int g = tid / P, pt = tid % P;
  const int ti = pt / ntj, tj = pt % ntj;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  float mx[4] = {0.f, 0.f, 0.f, 0.f}, my[4] = {0.f, 0.f, 0.f, 0.f};

  const int64_t n_tiles = (n + T - 1) / T;
  // thread tid < T loads voxel tid of the block's next tile while it works
  // on this one
  float nx = 0.f, ny = 0.f;
  auto fetch = [&](int64_t tile) {
    const int64_t v = tile * T + tid;
    if (tid < T && tile < n_tiles && v < n) {
      nx = xb[v];
      ny = yb[v];
    }
  };
  fetch(blockIdx.x);
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += nblk) {
    const int64_t v0 = tile * T;
    const int valid = (int)(n - v0 < T ? n - v0 : T);
    if (tid < valid) {  // stage the clipped tile
      xs[tid] = clip_keep_nan(nx, lo, hi);
      ys[tid] = clip_keep_nan(ny, lo, hi);
    }
    __syncthreads();
    fetch(tile + nblk);
    const float alpha = alpha_sh;
    if (valid == T && Bx % 4 == 0 && By % 4 == 0) {
      write_map<false>(xq, xs, cxs, Bx, nti, T, valid, alpha, tid, mx);
      write_map<false>(yq, ys, cys, By, ntj, T, valid, alpha, tid, my);
    } else {
      write_map<true>(xq, xs, cxs, Bx, nti, T, valid, alpha, tid, mx);
      write_map<true>(yq, ys, cys, By, ntj, T, valid, alpha, tid, my);
    }
    __syncthreads();
    if (active) {
      const float4* xr = xq + ti;
      const float4* yr = yq + tj;
#pragma unroll 4
      for (int t = g; t < valid; t += G) {
        const float4 p = xr[t * nti];
        const float4 q = yr[t * ntj];
        const float pa[4] = {p.x, p.y, p.z, p.w};
        const float qa[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(pa[a], qa[c], acc[a][c]);
      }
    }
    // no barrier here: the next tile's staging writes only xs/ys, last
    // read before the barrier above, and its maps are written after the
    // next barrier, which every thread reaches only when done here
  }

  // the groups' sums and the map threads' bin sums, added in a fixed order
  __syncthreads();  // the maps are read no more
  const int sx = kThreads / nti * nti, sy = kThreads / ntj * ntj;
  float* red = reinterpret_cast<float*>(sh4);  // [G][P][16]
  float* redx = red + G * P * 16;              // [sx / nti][4 nti]
  float* redy = redx + 4 * sx;                 // [sy / ntj][4 ntj]
  if (active) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(g * P + pt) * 16 + a * 4 + c] = acc[a][c];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (tid < sx) redx[4 * tid + a] = mx[a];
    if (tid < sy) redy[4 * tid + a] = my[a];
  }
  __syncthreads();
  float* out = partial + (b * nblk + blockIdx.x) * (int64_t)(B * B + 2 * B);
  for (int e = tid; e < Bx * By; e += kThreads) {
    const int i = e / By, j = e - i * By;
    const int o = ((i >> 2) * ntj + (j >> 2)) * 16 + (i & 3) * 4 + (j & 3);
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += red[k * P * 16 + o];
    out[(x0 + i) * B + y0 + j] = s;
  }
  if (sum_x) {
    for (int i = tid; i < Bx; i += kThreads) {
      float s = 0.f;
      for (int k = 0; k < sx / nti; ++k) s += redx[k * 4 * nti + i];
      out[B * B + x0 + i] = s;
    }
  }
  if (sum_y) {
    for (int j = tid; j < By; j += kThreads) {
      float s = 0.f;
      for (int k = 0; k < sy / ntj; ++k) s += redy[k * 4 * ntj + j];
      out[B * B + B + y0 + j] = s;
    }
  }
}

// grid (ceil(E / 32), bs), kFinal threads: warp w sums the partials of
// blocks [w * nblk / W, (w + 1) * nblk / W) (W = kFinal / 32 warps) for 32
// entries, in order, with 8 loads in flight; then the first warp adds the W
// sums in order. E = B*B + 2B entries, written to pxy [bs, B, B], px
// [bs, B] and py [bs, B].
constexpr int kFinal = 1024;

__global__ void __launch_bounds__(kFinal)
mi_final_kernel(const float* __restrict__ partial, float* __restrict__ pxy,
                float* __restrict__ px, float* __restrict__ py, int B,
                int nblk) {
  constexpr int W = kFinal / 32;
  __shared__ float part[W][33];
  const int E = B * B + 2 * B;
  const int64_t b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int k0 = (int)((int64_t)w * nblk / W);
  const int k1 = (int)((int64_t)(w + 1) * nblk / W);
  float s = 0.f;
  if (e < E) {
    const float* src = partial + b * nblk * (int64_t)E + e;
    int k = k0;
    for (; k + 8 <= k1; k += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = src[(int64_t)(k + u) * E];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; k < k1; ++k) s += src[(int64_t)k * E];
  }
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < E) {
    float t = 0.f;
    for (int g = 0; g < W; ++g) t += part[g][lane];
    if (e < B * B) {
      pxy[b * B * B + e] = t;
    } else if (e < B * B + B) {
      px[b * B + (e - B * B)] = t;
    } else {
      py[b * B + (e - B * B - B)] = t;
    }
  }
}

}  // namespace

extern "C" {

// x, y: [bs, V] float32, contiguous; cx, cy: [B] float32 on the device;
// partial: [bs, nblk, B*B + 2B] scratch; pxy: [bs, B, B]; px, py: [bs, B].
// alpha is the RBF sharpness, read from alpha_ptr (one float32 on the
// device) when that is not null; lo and hi are the clip bounds (+-inf: no
// clip); tile (voxels a tile, at most 256) and smem (the first launch's
// dynamic shared bytes) come from `mi_hist_cuda.plan`. The caller keeps
// ceil(B / 64)^2 <= 65535 (the grid's third axis).
int neurite_mi_hist_f32(const void* x, const void* y, const void* cx,
                        const void* cy, void* partial, void* pxy, void* px,
                        void* py, int64_t bs, int64_t V, int B, int nblk,
                        float alpha, const void* alpha_ptr, float lo, float hi,
                        int tile, int smem, void* stream) {
  if (bs == 0) return 0;
  const int64_t nc = (B + kChunk - 1) / kChunk;
  if (B < 1 || nc * nc > 65535 || tile < 1 || tile > kTileMax)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* pf = static_cast<float*>(partial);
  mi_partial_kernel<<<dim3(nblk, (unsigned)bs, (unsigned)(nc * nc)), kThreads,
                      smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(cx), static_cast<const float*>(cy), pf, V, B,
      nblk, alpha, static_cast<const float*>(alpha_ptr), lo, hi, tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = B * B + 2 * B;
  mi_final_kernel<<<dim3((E + 31) / 32, (unsigned)bs), kFinal, 0, s>>>(
      pf, static_cast<float*>(pxy), static_cast<float*>(px),
      static_cast<float*>(py), B, nblk);
  return (int)cudaGetLastError();
}

}  // extern "C"
