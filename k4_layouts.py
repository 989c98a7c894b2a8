"""
K4 thread layouts side by side on the card: the record behind the 'vec'
body of `neurite_tpu_torch/ops/csrc/interpn.cu`.

Builds `interpn.cu` together with the layouts it was chosen over, and at the
paths' K4 shapes times each against the port's two bodies on the same
inputs. Every layout must give the 'scalar' body's bits, or the script
fails. The layouts:

- 'scalar', 'vec': the port's bodies (`warp_cuda._launch`); 'vec' runs 4
  points a thread for nearest and 1 for linear;
- 'vec NP=n' (n = 1, 2, 4): the 'vec' kernel (`interpn3d_vec_kernel`, a
  thread's points 128 apart, so a warp's lanes sit on consecutive points)
  at n points a thread, for each method;
- 'float4 NP=4': 4 consecutive points a thread, loc read as three aligned
  16-byte loads and out written as C 16-byte stores (C = 1 or 3), 32-bit
  indices, every gather of the thread issued together; the same per-point
  arithmetic. It needs P % 4 == 0 and 16-byte aligned loc and out.

Cases (`chip_smoke.py` phase 7's path shapes): [1, 64^3, 3] linear under a
smooth +-8 voxel field (config #5's five squarings), [1, 128^3, 1] nearest
with fill 0 at half-integer ties (its label warp), [1, 128^3, 1] linear
under a field within +-3 (the registration step's warp). Times are device
times by torch.profiler over 20 calls (`chip_smoke.time_ms`).

    python3 k4_layouts.py

needs one CUDA card, `nvcc` and the repo checkout; prints the card's name
and power limit, one line per case and layout, and a JSON line last. Exits
non-zero if a layout's bits differ or the card is missing.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from neurite_tpu_torch.ops import _build, warp_cuda
from neurite_tpu_torch.utils import core

SOURCE = r'''
#include "interpn.cu"

namespace {

// 4 consecutive points a thread: loc by three aligned float4 loads, out by
// CT float4 stores; each point's arithmetic is the 'vec' body's.
template <int CT, bool kNearest>
__global__ void __launch_bounds__(128)
interpn3d_float4_kernel(const float* __restrict__ vol,
                        const float* __restrict__ loc,
                        float* __restrict__ out, int D, int H, int W, int P,
                        int has_fill, float fill) {
  constexpr int NP = 4, K = kNearest ? 1 : 8;
  const int u0 = (blockIdx.x * blockDim.x + threadIdx.x) * NP;
  if (u0 >= P) return;
  const int i0 = blockIdx.y * P + u0;
  const float* v = vol + blockIdx.y * (D * H * W * CT);
  const int dims[3] = {D, H, W};
  float lp[NP][3];
  const float4* l4 = reinterpret_cast<const float4*>(loc + 3 * i0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 q = __ldg(l4 + j);
    const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) lp[(4 * j + m) / 3][(4 * j + m) % 3] = e[m];
  }
  bool skip[NP];
  int off[NP][K];
  float wt[NP][K];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    bool oob = false;
    if (has_fill) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        oob |= (lp[k][d] < 0.f) | (lp[k][d] > (float)(dims[d] - 1));
    }
    skip[k] = oob;
    if (kNearest) {
      const int z = clipi32(__float2int_rn(lp[k][0]), D - 1);
      const int y = clipi32(__float2int_rn(lp[k][1]), H - 1);
      const int x = clipi32(__float2int_rn(lp[k][2]), W - 1);
      off[k][0] = ((z * H + y) * W + x) * CT;
      continue;
    }
    int idx[2][3];
    float wgt[2][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float hi = (float)(dims[d] - 1);
      const float cl = clipf(lp[k][d], hi);
      const float f0 = clipf(floorf(lp[k][d]), hi);
      const float f1 = clipf(f0 + 1.f, hi);
      idx[0][d] = (int)f0;
      idx[1][d] = (int)f1;
      wgt[0][d] = __fsub_rn(f1, cl);
      wgt[1][d] = __fsub_rn(1.f, wgt[0][d]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int cz = (j >> 2) & 1, cy = (j >> 1) & 1, cx = j & 1;
      wt[k][j] = __fmul_rn(__fmul_rn(wgt[cz][0], wgt[cy][1]), wgt[cx][2]);
      off[k][j] = ((idx[cz][0] * H + idx[cy][1]) * W + idx[cx][2]) * CT;
    }
  }
  float r[NP * CT];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float acc;
      if (skip[k]) {
        acc = fill;
      } else if (kNearest) {
        acc = __ldg(v + off[k][0] + c);
      } else {
        acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc = __fadd_rn(acc, __fmul_rn(wt[k][j], __ldg(v + off[k][j] + c)));
      }
      r[k * CT + c] = acc;
    }
  }
  float4* o4 = reinterpret_cast<float4*>(out + i0 * CT);
#pragma unroll
  for (int j = 0; j < CT; ++j)
    o4[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
}

template <int NP, int CT, bool kNearest>
int vec_at(const float* vol, const float* loc, float* out, int B, int D,
           int H, int W, int P, int has_fill, float fill, cudaStream_t s) {
  const dim3 grid((P + NP * kVecThreads - 1) / (NP * kVecThreads), B);
  interpn3d_vec_kernel<NP, CT, kNearest><<<grid, kVecThreads, 0, s>>>(
      vol, loc, out, D, H, W, CT, P, has_fill, fill);
  return (int)cudaGetLastError();
}

template <int CT, bool kNearest>
int float4_at(const float* vol, const float* loc, float* out, int B, int D,
              int H, int W, int P, int has_fill, float fill, cudaStream_t s) {
  const dim3 grid((P / 4 + 127) / 128, B);
  interpn3d_float4_kernel<CT, kNearest><<<grid, 128, 0, s>>>(
      vol, loc, out, D, H, W, P, has_fill, fill);
  return (int)cudaGetLastError();
}

template <int CT, bool kNearest>
int layout_at(int layout, const float* vol, const float* loc, float* out,
              int B, int D, int H, int W, int P, int has_fill, float fill,
              cudaStream_t s) {
  switch (layout) {
    case 1: return vec_at<1, CT, kNearest>(vol, loc, out, B, D, H, W, P,
                                           has_fill, fill, s);
    case 2: return vec_at<2, CT, kNearest>(vol, loc, out, B, D, H, W, P,
                                           has_fill, fill, s);
    case 4: return vec_at<4, CT, kNearest>(vol, loc, out, B, D, H, W, P,
                                           has_fill, fill, s);
    case 0: return float4_at<CT, kNearest>(vol, loc, out, B, D, H, W, P,
                                           has_fill, fill, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// layout: 1, 2, 4 the 'vec' kernel at that many points a thread; 0 the
// float4 layout. C is 1 or 3.
extern "C" int k4_layout(int layout, int nearest, const float* vol,
                         const float* loc, float* out, int B, int D, int H,
                         int W, int C, int P, int has_fill, float fill,
                         cudaStream_t s) {
  if (C == 1)
    return nearest ? layout_at<1, true>(layout, vol, loc, out, B, D, H, W, P,
                                        has_fill, fill, s)
                   : layout_at<1, false>(layout, vol, loc, out, B, D, H, W,
                                         P, has_fill, fill, s);
  if (C == 3)
    return nearest ? layout_at<3, true>(layout, vol, loc, out, B, D, H, W, P,
                                        has_fill, fill, s)
                   : layout_at<3, false>(layout, vol, loc, out, B, D, H, W,
                                         P, has_fill, fill, s);
  return (int)cudaErrorInvalidValue;
}
'''

LAYOUTS = {'vec NP=1': 1, 'vec NP=2': 2, 'vec NP=4': 4, 'float4 NP=4': 0}


def build():
    """Compile SOURCE with `interpn.cu` into its own library under the
    build directory; return the loaded `k4_layout`."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), 'k4_layouts')
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, n) for n in ('k4_layouts.cu',
                                                    'libk4_layouts.so'))
    with open(src, 'w') as f:
        f.write(SOURCE)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-I',
                          _build.CSRC, '-shared', '-o', lib, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n{res.stdout}'
                           f'{res.stderr}')
    fn = ctypes.CDLL(lib).k4_layout
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cases():
    """(name, vol, loc, method, fill) at the paths' K4 shapes."""
    gen = torch.Generator(device='cuda').manual_seed(7)
    v64, v128 = (64,) * 3, (cs.VOL,) * 3
    grid64 = core.grid_points(v64, 'cuda')[None]
    grid128 = core.grid_points(v128, 'cuda')[None]
    vol3 = torch.randn((1, *v64, 3), generator=gen, device='cuda')
    lab = torch.randint(0, cs.SYNTH_LABELS, (1, *v128, 1), generator=gen,
                        device='cuda').float()
    img = torch.rand((1, *v128, 1), generator=gen, device='cuda')
    return [
        ('64^3 C=3 linear, +-8 field', vol3,
         grid64 + cs.smooth_field(v64, 8., gen), 'linear', None),
        ('128^3 C=1 nearest, fill 0, half-integer ties', lab,
         torch.round(2 * (grid128 + cs.smooth_field(v128, 8., gen))) / 2,
         'nearest', 0.),
        ('128^3 C=1 linear, registration field within +-3', img,
         grid128 + torch.clamp(cs.smooth_field(v128, 4., gen), -3., 3.),
         'linear', None),
    ]


def main():
    if not torch.cuda.is_available():
        print('no CUDA device: k4_layouts.py needs one', file=sys.stderr)
        return 1
    card = cs.phase_device()
    layout_fn = build()
    rows, ok = [], True
    for name, vol, loc, method, fill in cases():
        b, d, h, w, c = vol.shape
        p = loc[0, ..., 0].numel()

        def run(layout, out):
            err = layout_fn(layout, int(method == 'nearest'), vol.data_ptr(),
                            loc.data_ptr(), out.data_ptr(), b, d, h, w, c, p,
                            int(fill is not None),
                            0. if fill is None else fill,
                            _build.stream_of(vol))
            if err:
                raise RuntimeError(f'k4_layout {layout}: CUDA error {err}')

        ref = torch.empty((b, *loc.shape[1:-1], c), device='cuda')
        port = {'scalar': lambda o: warp_cuda._launch(vol, loc, o, method,
                                                      fill, 'scalar'),
                'vec': lambda o: warp_cuda._launch(vol, loc, o, method, fill,
                                                   'vec')}
        port['scalar'](ref)
        nbytes = (vol.numel() + loc.numel() + ref.numel()) * 4
        bound, _ = cs.bound_ms(nbytes)
        print(f'{name}: bound {bound:.4f} ms (bytes)', flush=True)
        fns = {**port, **{k: (lambda o, n=n: run(n, o))
                          for k, n in LAYOUTS.items()}}
        for layout, fn in fns.items():
            out = torch.empty_like(ref)
            fn(out)
            torch.cuda.synchronize()
            same = cs.bit_equal(out, ref)
            ok &= same
            ms = cs.time_ms(lambda: fn(out))
            print(f'  {layout:12s} {ms:.4f} ms  bit-equal to scalar {same}',
                  flush=True)
            rows.append({'case': name, 'layout': layout, 'ms': ms,
                         'bound_ms': bound, 'bit_equal': same})
    print(card)
    print(json.dumps({'ok': ok, 'card': card, 'rows': rows}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
