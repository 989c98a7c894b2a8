// Native host-pipeline kernels for neurite_tpu_torch (built on demand with
// g++ into build/neurite_tpu_torch/, loaded via ctypes — see
// neurite_tpu_torch/io/native.py). The same source as the JAX package's
// neurite_tpu/io/_native/hostops.cpp.
//
// The reference's host data path is single-threaded numpy
// (neurite/tf/generators.py:1024-1051 one-hot; pystrum pl.quilt nan-median
// reassembly used by neurite/tf/utils/seg.py:363-374). These are the two
// measured hot spots of host-side feeding/inference:
//   * one_hot_f32/u8 — fused label->one-hot expansion, multithreaded, no
//     intermediate index matrices;
//   * nanmedian_axis0 / nanmean_axis0 — overlap aggregation across quilt
//     layers with per-voxel nth_element instead of numpy's full sort.
//
// Plain C ABI; all arrays are dense row-major as produced by numpy.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 1;
}

// run fn(start, end) over [0, n) on up to `hw_threads` workers
template <typename F>
void parallel_for(int64_t n, F fn) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(n / 65536, 1));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// labels [n] int32 -> out [n, nb] float32 one-hot (values outside [0, nb)
// produce all-zero rows, matching np.eye(nb)[clip]-style semantics except
// out-of-range labels are dropped rather than clamped)
void one_hot_f32(const int32_t* labels, int64_t n, int32_t nb, float* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    std::memset(out + lo * nb, 0, sizeof(float) * (hi - lo) * nb);
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = labels[i];
      if (v >= 0 && v < nb) out[i * nb + v] = 1.0f;
    }
  });
}

void one_hot_u8(const int32_t* labels, int64_t n, int32_t nb, uint8_t* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    std::memset(out + lo * nb, 0, sizeof(uint8_t) * (hi - lo) * nb);
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = labels[i];
      if (v >= 0 && v < nb) out[i * nb + v] = 1;
    }
  });
}

// layers [L, n] float32 (NaN = missing) -> out [n] float32 nan-median
// (median of the non-NaN entries per column; NaN when all missing — numpy
// nanmedian semantics)
void nanmedian_axis0(const float* layers, int64_t L, int64_t n, float* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    std::vector<float> buf(L);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t m = 0;
      for (int64_t l = 0; l < L; ++l) {
        float v = layers[l * n + i];
        if (!std::isnan(v)) buf[m++] = v;
      }
      if (m == 0) {
        out[i] = std::nanf("");
        continue;
      }
      auto mid = buf.begin() + m / 2;
      std::nth_element(buf.begin(), mid, buf.begin() + m);
      if (m & 1) {
        out[i] = *mid;
      } else {
        float hi_v = *mid;
        float lo_v = *std::max_element(buf.begin(), mid);
        out[i] = 0.5f * (lo_v + hi_v);
      }
    }
  });
}

void nanmean_axis0(const float* layers, int64_t L, int64_t n, float* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double acc = 0.0;
      int64_t m = 0;
      for (int64_t l = 0; l < L; ++l) {
        float v = layers[l * n + i];
        if (!std::isnan(v)) {
          acc += v;
          ++m;
        }
      }
      out[i] = m ? static_cast<float>(acc / m) : std::nanf("");
    }
  });
}

// relabel: map each voxel through value->index of `labels` [nl]
// (ref generators.py:1054-1066) — hash-free linear probe over small nl
void relabel_i32(const int32_t* vol, int64_t n, const int32_t* labels,
                 int32_t nl, int32_t* out) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = vol[i], r = 0;
      for (int32_t j = 0; j < nl; ++j) {
        if (labels[j] == v) {
          r = j;
          break;
        }
      }
      out[i] = r;
    }
  });
}

}  // extern "C"
