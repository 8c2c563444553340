// deephisto_tpu_torch native host library: the port's own copy of
// deephisto_tpu/native/src/native.cpp.
//
// C++ implementations of the host-side hot paths that sit outside the XLA
// device programs (the reference outsourced these to shapely/GEOS and psimage,
// both C/C++ — SURVEY.md §2):
//
//   * clip_area_boxes   — exact polygon∩box areas (clip-by-clamp with edge
//                         subdivision, float64, OpenMP over boxes). Used by
//                         dense-grid qualification and anchor precomputation,
//                         where a slide can demand millions of box tests.
//   * extract_patches   — parallel HWC uint8 patch extraction from a
//                         (possibly memory-mapped) slide layer; the host-mode
//                         SlideBank gather.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Exact area of polygon ∩ [x0,x1]×[y0,y1] for one polygon and many boxes.
// verts: (V, 2) float64 (x, y); boxes: (B, 4) float64 (x0, y0, x1, y1);
// out: (B,) float64. Same algorithm as geometry/polygon.py: split each edge
// at its crossings with the 4 box lines, clamp, shoelace.
void clip_area_boxes(const double* verts, int64_t V, const double* boxes,
                     int64_t B, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    const double x0 = boxes[4 * b + 0];
    const double y0 = boxes[4 * b + 1];
    const double x1 = boxes[4 * b + 2];
    const double y1 = boxes[4 * b + 3];

    double area2 = 0.0;
    // previous emitted (clamped) vertex of the collapsed polygon walk
    double px = 0.0, py = 0.0;
    double firstx = 0.0, firsty = 0.0;
    bool have_prev = false;

    auto emit = [&](double x, double y) {
      const double cx = std::min(std::max(x, x0), x1);
      const double cy = std::min(std::max(y, y0), y1);
      if (have_prev) {
        area2 += px * cy - cx * py;
      } else {
        firstx = cx;
        firsty = cy;
        have_prev = true;
      }
      px = cx;
      py = cy;
    };

    for (int64_t i = 0; i < V; ++i) {
      const double ax = verts[2 * i + 0];
      const double ay = verts[2 * i + 1];
      const int64_t j = (i + 1 == V) ? 0 : i + 1;
      const double bx = verts[2 * j + 0];
      const double by = verts[2 * j + 1];
      const double dx = bx - ax;
      const double dy = by - ay;

      emit(ax, ay);

      // crossing parameters with the 4 box lines, kept only in (0, 1)
      double ts[4];
      int n = 0;
      if (dx != 0.0) {
        const double t1 = (x0 - ax) / dx;
        const double t2 = (x1 - ax) / dx;
        if (t1 > 0.0 && t1 < 1.0) ts[n++] = t1;
        if (t2 > 0.0 && t2 < 1.0) ts[n++] = t2;
      }
      if (dy != 0.0) {
        const double t3 = (y0 - ay) / dy;
        const double t4 = (y1 - ay) / dy;
        if (t3 > 0.0 && t3 < 1.0) ts[n++] = t3;
        if (t4 > 0.0 && t4 < 1.0) ts[n++] = t4;
      }
      std::sort(ts, ts + n);
      for (int t = 0; t < n; ++t) {
        emit(ax + ts[t] * dx, ay + ts[t] * dy);
      }
    }
    // close the loop
    if (have_prev) {
      area2 += px * firsty - firstx * py;
    }
    out[b] = std::fabs(area2) * 0.5;
  }
}

// Shoelace areas for many polygons stored as a padded (P, V, 2) float64 array
// (padding = repeated last vertex contributes zero).
void polygon_areas(const double* verts, int64_t P, int64_t V, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < P; ++p) {
    const double* v = verts + 2 * V * p;
    double area2 = 0.0;
    for (int64_t i = 0; i < V; ++i) {
      const int64_t j = (i + 1 == V) ? 0 : i + 1;
      area2 += v[2 * i] * v[2 * j + 1] - v[2 * j] * v[2 * i + 1];
    }
    out[p] = std::fabs(area2) * 0.5;
  }
}

// Parallel patch extraction: image (H, W, 3) uint8 row-major; coords (N, 2)
// int32 as (y, x); out (N, ps, ps, 3) uint8.
void extract_patches(const uint8_t* image, int64_t H, int64_t W,
                     const int32_t* coords, int64_t N, int32_t ps,
                     uint8_t* out) {
  const int64_t row_bytes = static_cast<int64_t>(ps) * 3;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < N; ++i) {
    const int64_t y = coords[2 * i + 0];
    const int64_t x = coords[2 * i + 1];
    uint8_t* dst = out + i * ps * row_bytes;
    const uint8_t* src = image + (y * W + x) * 3;
    for (int32_t r = 0; r < ps; ++r) {
      std::memcpy(dst + r * row_bytes, src + r * W * 3, row_bytes);
    }
  }
}

int native_version() { return 1; }

int omp_thread_count() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
