// Native NMS kernels for host-side detection preprocessing.
//
// A copy of the JAX package's native/nms.cpp, the C++ replacement for the
// reference's Cython/CUDA extension (thirdparty/nms/cpu_nms.pyx:20-71,
// gpu_nms.pyx, nms_kernel.cu): greedy box-IoU suppression and OKS-based
// keypoint suppression (incl. the soft-NMS gaussian/linear rescoring
// variants). Exposed with a C ABI and loaded from Python via ctypes (no
// pybind11 dependency); the device-side analogs are
// fami_pose_torch/ops/nms.py's torch functions.
//
// Built by fami_pose_torch/native/nms.py at first use with
// g++ -O3 -fPIC -shared -std=c++17 (no -march=native: the library runs on
// the host that builds it, whatever its CPU).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

inline float box_area(const float* b) {
  // boxes are [x1, y1, x2, y2]; +1 convention matches the reference
  // (cpu_nms.pyx: areas = (x2 - x1 + 1) * (y2 - y1 + 1))
  return (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
}

inline float box_iou(const float* a, const float* b) {
  const float xx1 = std::max(a[0], b[0]);
  const float yy1 = std::max(a[1], b[1]);
  const float xx2 = std::min(a[2], b[2]);
  const float yy2 = std::min(a[3], b[3]);
  const float w = std::max(0.0f, xx2 - xx1 + 1.0f);
  const float h = std::max(0.0f, yy2 - yy1 + 1.0f);
  const float inter = w * h;
  return inter / (box_area(a) + box_area(b) - inter);
}

// OKS between two keypoint sets (reference datasets/process/nms.py:34-56).
float oks_iou(const float* g, const float* d, int nj, float a_g, float a_d,
              const float* sigmas, float in_vis_thre) {
  float total = 0.0f;
  int count = 0;
  for (int j = 0; j < nj; ++j) {
    const float var = (sigmas[j] * 2.0f) * (sigmas[j] * 2.0f);
    const float xg = g[j * 3 + 0], yg = g[j * 3 + 1], vg = g[j * 3 + 2];
    const float xd = d[j * 3 + 0], yd = d[j * 3 + 1], vd = d[j * 3 + 2];
    if (in_vis_thre > 0.0f && !(vg > in_vis_thre && vd > in_vis_thre)) {
      continue;
    }
    const float dx = xd - xg;
    const float dy = yd - yg;
    const float e =
        (dx * dx + dy * dy) / var / ((a_g + a_d) / 2.0f + 1e-9f) / 2.0f;
    total += std::exp(-e);
    ++count;
  }
  return count > 0 ? total / count : 0.0f;
}

std::vector<int> score_order(const float* scores, int n) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] > scores[b];
  });
  return order;
}

}  // namespace

extern "C" {

// Greedy box NMS. boxes: (n, 4) xyxy; returns number of kept indices
// written to keep_out (caller allocates n ints).
int fami_cpu_nms(const float* boxes, const float* scores, int n, float thresh,
                 int* keep_out) {
  std::vector<int> order = score_order(scores, n);
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      if (box_iou(boxes + 4 * i, boxes + 4 * j) > thresh) {
        suppressed[j] = 1;
      }
    }
  }
  return kept;
}

// Greedy OKS NMS. kpts: (n, nj, 3); areas: (n,); sigmas: (nj,).
int fami_oks_nms(const float* kpts, const float* scores, const float* areas,
                 int n, int nj, float thresh, const float* sigmas,
                 float in_vis_thre, int* keep_out) {
  std::vector<int> order = score_order(scores, n);
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float o = oks_iou(kpts + i * nj * 3, kpts + j * nj * 3, nj,
                              areas[i], areas[j], sigmas, in_vis_thre);
      if (o > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Soft OKS NMS with gaussian (method 2, sigma rescale) or linear (method 1)
// rescoring; max 20 detections kept like the reference (nms.py:121-192).
// rescored scores are written to scores_out (n floats).
int fami_soft_oks_nms(const float* kpts, const float* scores,
                      const float* areas, int n, int nj, float thresh,
                      const float* sigmas, float in_vis_thre, int method,
                      float soft_sigma, int max_dets, int* keep_out,
                      float* scores_out) {
  std::vector<int> order = score_order(scores, n);
  std::vector<float> s(n);
  for (int i = 0; i < n; ++i) s[i] = scores[i];
  int kept = 0;
  size_t pos = 0;
  while (pos < order.size() && kept < max_dets) {
    // pick the current max-score detection
    size_t best = pos;
    for (size_t q = pos + 1; q < order.size(); ++q) {
      if (s[order[q]] > s[order[best]]) best = q;
    }
    std::swap(order[pos], order[best]);
    const int i = order[pos];
    keep_out[kept] = i;
    scores_out[kept] = s[i];
    ++kept;
    for (size_t q = pos + 1; q < order.size(); ++q) {
      const int j = order[q];
      const float o = oks_iou(kpts + i * nj * 3, kpts + j * nj * 3, nj,
                              areas[i], areas[j], sigmas, in_vis_thre);
      if (method == 1) {  // linear
        if (o > thresh) s[j] *= (1.0f - o);
      } else {  // gaussian
        s[j] *= std::exp(-(o * o) / soft_sigma);
      }
    }
    ++pos;
  }
  return kept;
}

}  // extern "C"
