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
// writes the volume once); at 41 and 165 taps, float32 multiply-adds
// outside the tensor cores, counted over the taps that meet the axis only
// (a 165-tap window on a 128-voxel axis keeps about 112 a voxel). A block
// stages, computes and stores in turn, and at the path's shapes all blocks
// fit in one wave, so the three phases add up rather than overlap.
//
// The design: the lines along the axis are the block's columns, 32 of them,
// one a lane (the columns q of one p when post > 1; 32 rows p when post == 1,
// the last axis, staged transposed so that no lane idles). A block stages
// its columns' inputs in shared memory (8 loads of a thread in flight),
// rows of 33 floats (the pad keeps both the transposed staging and the
// lanes' reads free of bank conflicts), beside its taps, and computes into
// a shared output tile that it stores once at the end, so that loads and
// stores both run along q (post > 1) or along L (post == 1). A warp takes
// groups of kR = 8 consecutive outputs along the axis, one column a lane,
// with 8 sums in registers and a window of 8 inputs in registers: each tap
// costs one new input read from shared memory and 8 multiply-adds, and the
// taps come as warp-wide broadcast float4s, four at a time (10 shared loads
// per 64 FMAs, against 2 per FMA before). The tap loop is unrolled by 8 so
// that the window rotates without moves; a step of 8 taps whose next
// inputs all lie inside the staged rows reads them without a bounds check
// (warp-uniform). A group runs only the taps that reach an input in
// [0, L), from the first such tap rounded down to a multiple of 4 (the
// float4s; the few taps before it read zeros); its lanes share the group's
// outputs, so the bounds are warp-uniform. Taps run in ascending order and
// a skipped tap would have added fmaf(t, +0, acc) = acc, so each output's
// sum is the plain loop's over all K taps, in its order. Rows outside
// [0, L) are not staged: a read there gives 0.
//
// Two bodies, chosen by `blur_cuda.plan` (the launcher trusts it):
// 'whole' stages the block's columns over the whole axis with every tap,
// once (no halo re-reads; the config #5 axes, 64 and 128, take 17 and 34
// KB); 'halo' takes 64-row tiles of outputs with their halo (any length),
// and, when the taps with their rows do not fit in 48 KB, walks the taps in
// chunks: each chunk stages its taps and the rows they reach, and the sums
// carry from chunk to chunk in the shared output tile (the same order).
// Fusing the three passes into one, as the TPU kernel does, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 8;         // outputs of a thread, consecutive on the axis
constexpr int kCols = 32;     // columns of a block: one a lane
constexpr int kRow = 33;      // floats of a shared row (32 columns + pad)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = 8;     // staging loads of a thread in flight

// One step of 8 taps from tap k (phase 0: w[m] holds the input of output m
// at tap k) into acc; the steps past kend (the last, partial step) are
// skipped. The inputs it reads next, rows j .. j + kR - 1 (j = base + k +
// kR), are checked against [0, nrows) where kCheck is set; the caller
// clears it where all of them lie inside.
template <bool kCheck, bool kTail>
__device__ __forceinline__ void taps8(const float* __restrict__ sx,
                                      const float* __restrict__ skk,
                                      int nrows, int lane, int j, int left,
                                      float w[kR], float acc[kR]) {
  const float4 ta = *reinterpret_cast<const float4*>(skk);
  const float4 tb = *reinterpret_cast<const float4*>(skk + 4);
  const float t[kR] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
  for (int u = 0; u < kR; ++u) {
    if (kTail && u >= left) break;
#pragma unroll
    for (int m = 0; m < kR; ++m) acc[m] = fmaf(t[u], w[(u + m) % kR], acc[m]);
    const int jr = j + u;
    w[u] = !kCheck || (unsigned)jr < (unsigned)nrows ? sx[jr * kRow + lane]
                                                     : 0.f;
  }
}

// Adds taps [k, kend] (ascending; k a multiple of 4 at or after the chunk
// start kc) into acc[m], the output at row i + m: the input at staged row
// base + t + m of column `lane`, 0 outside [0, nrows).
__device__ __forceinline__ void run_taps(const float* __restrict__ sx,
                                         const float* __restrict__ sk,
                                         int nrows, int lane, int base, int k,
                                         int kend, int kc, float acc[kR]) {
  float w[kR];  // w[(u + m) % kR]: the input of output m at tap k + u
#pragma unroll
  for (int m = 0; m < kR; ++m) {
    const int jr = base + k + m;
    w[m] = (unsigned)jr < (unsigned)nrows ? sx[jr * kRow + lane] : 0.f;
  }
  for (; k + kR - 1 <= kend; k += kR) {
    const int j = base + k + kR;
    if (j >= 0 && j + kR <= nrows)  // warp-uniform: no row checks
      taps8<false, false>(sx, sk + (k - kc), nrows, lane, j, kR, w, acc);
    else
      taps8<true, false>(sx, sk + (k - kc), nrows, lane, j, kR, w, acc);
  }
  if (k <= kend)  // the last taps, fewer than kR
    taps8<true, true>(sx, sk + (k - kc), nrows, lane, base + k + kR,
                      kend - k + 1, w, acc);
}

// grid: n_ct * n_lt blocks (column tile ct, row tile lt); dynamic shared
// memory: taps [round4(KC) + 8], inputs [min(L, TL + KC - 1)][kRow],
// outputs [round8(TL)][kRow] floats.
__global__ void __launch_bounds__(kThreads)
blur_axis_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int64_t L, int64_t post,
                 int64_t ncols, int K, int TL, int KC, int64_t n_lt) {
  extern __shared__ float4 smem4[];
  const int kcs = (KC + 3) / 4 * 4 + 8;
  const int rows_max = (int)(L < (int64_t)TL + KC - 1 ? L : TL + KC - 1);
  float* sk = reinterpret_cast<float*>(smem4);
  float* sx = sk + kcs;
  float* so = sx + rows_max * kRow;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t lt = blockIdx.x % n_lt, ct = blockIdx.x / n_lt;
  const int64_t i0 = lt * TL, c0 = ct * kCols;
  const int tl = (int)(L - i0 < TL ? L - i0 : TL);
  const int ngroups = (tl + kR - 1) / kR;
  const int r = K / 2;
  const bool last_axis = post == 1;
  // post > 1: lane's column c0 + lane is (p, q) = (c / post, c % post)
  const int64_t c = c0 + lane;
  const bool col_ok = c < ncols;
  const int64_t colbase = col_ok ? (c / post) * L * post + c % post : 0;

  const int nchunks = (K + KC - 1) / KC;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int kc = ch * KC;
    const int kn = K - kc < KC ? K - kc : KC;
    // the rows this chunk's taps reach from the tile's outputs, in [0, L)
    int64_t lo = i0 - r + kc, hi = i0 + tl - r + kc + kn - 1;
    lo = lo < 0 ? 0 : lo;
    hi = hi > L ? L : hi;
    const int nrows = hi > lo ? (int)(hi - lo) : 0;
    if (ch > 0) __syncthreads();  // the previous chunk's reads are done
    for (int k = tid; k < kcs; k += kThreads)
      sk[k] = k < kn ? taps[kc + k] : 0.f;
    // kLoads loads of a thread in flight before their shared stores
    if (last_axis) {  // coalesced along L, transposed into the columns
      for (int cc = warp; cc < kCols; cc += kWarps) {
        const int64_t col = c0 + cc;
        const float* xc = x + (col < ncols ? col : 0) * L + lo;
        for (int j0 = lane; j0 < nrows; j0 += 32 * kLoads) {
          float v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int j = j0 + 32 * u;
            v[u] = col < ncols && j < nrows ? xc[j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u)
            if (j0 + 32 * u < nrows) sx[(j0 + 32 * u) * kRow + cc] = v[u];
        }
      }
    } else {          // coalesced along q
      const float* xc = x + colbase + lo * post;
      for (int j0 = warp; j0 < nrows; j0 += kWarps * kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int j = j0 + kWarps * u;
          v[u] = col_ok && j < nrows ? xc[j * post] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (j0 + kWarps * u < nrows)
            sx[(j0 + kWarps * u) * kRow + lane] = v[u];
      }
    }
    __syncthreads();
    for (int g = warp; g < ngroups; g += kWarps) {
      const int64_t i = i0 + (int64_t)g * kR;
      // taps that reach an input in [0, L) from outputs [i, i + kR)
      const int64_t klo = r - i - (kR - 1), khi = r + L - 1 - i;
      const int ka = (int)(klo > kc ? klo : kc);
      const int kb = (int)(khi < kc + kn - 1 ? khi : kc + kn - 1);
      float acc[kR];
#pragma unroll
      for (int m = 0; m < kR; ++m)  // a later chunk adds to its own sums
        acc[m] = ch == 0 ? 0.f : so[(g * kR + m) * kRow + lane];
      if (ka <= kb)
        run_taps(sx, sk, nrows, lane, (int)(i - r - lo), ka & ~3, kb, kc, acc);
#pragma unroll
      for (int m = 0; m < kR; ++m) so[(g * kR + m) * kRow + lane] = acc[m];
    }
  }
  __syncthreads();
  // the output tile, stored as the inputs were loaded
  if (last_axis) {
    for (int cc = warp; cc < kCols; cc += kWarps) {
      const int64_t col = c0 + cc;
      if (col >= ncols) continue;
      for (int j = lane; j < tl; j += 32)
        out[col * L + i0 + j] = so[j * kRow + cc];
    }
  } else if (col_ok) {
    for (int j = warp; j < tl; j += kWarps)
      out[colbase + (i0 + j) * post] = so[j * kRow + lane];
  }
}

}  // namespace

// TL: outputs of a row tile (L for the whole-axis body); KC: taps of a
// chunk (K for one chunk; else a multiple of 4); smem: the dynamic shared
// bytes of that layout (`blur_cuda.plan`).
extern "C" int neurite_blur_axis_f32(const float* x, const float* taps,
                                     float* out, int64_t pre, int64_t L,
                                     int64_t post, int K, int TL, int KC,
                                     int smem, cudaStream_t stream) {
  if (pre == 0 || L == 0 || post == 0) return 0;
  if (TL < 1 || KC < 1 || (KC < K && KC % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int64_t ncols = pre * post;
  const int64_t n_lt = (L + TL - 1) / TL, n_ct = (ncols + kCols - 1) / kCols;
  const int64_t blocks = n_lt * n_ct;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  blur_axis_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, taps, out, L, post, ncols, K, TL, KC, n_lt);
  return (int)cudaGetLastError();
}
