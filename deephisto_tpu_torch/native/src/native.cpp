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
//   * stage_upload      — the slide ingest's upload of a pageable host slide
//                         through a ring of pinned slots (predict/ingest.py),
//                         OpenMP row copies between the card's copies. The
//                         port's own; the JAX package has no such upload.
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

// ---------------------------------------------------------------------------
// The slide ingest's staged upload (predict/ingest.py): a pageable host slide
// through a ring of pinned slots to the card, in one call, so the Python
// thread takes the interpreter lock once for the whole slide. libcuda's
// functions come as pointers (cuMemcpyHtoDAsync_v2, cuEventRecord,
// cuEventSynchronize): the library links no CUDA, and a test drives the same
// loop with stand-ins that defer each copy to the wait that covers it.

typedef int (*htod_fn)(uint64_t dst, const void* src, size_t bytes, void* stream);
typedef int (*record_fn)(void* event, void* stream);
typedef int (*sync_fn)(void* event);

static const int64_t kPiece = 256 << 10;  // bytes an OpenMP task copies

// R rows of row_bytes, src_stride apart, into the contiguous dst, in pieces
// of about kPiece handed out to `threads` threads as each finishes its last
// (a thread descheduled by other load delays only its own piece).
static void copy_rows(uint8_t* dst, const uint8_t* src, int64_t R, int64_t row_bytes,
                      int64_t src_stride, int32_t threads) {
  if (R == 1 || src_stride == row_bytes) {  // one contiguous block
    const int64_t n = R * row_bytes, k = (n + kPiece - 1) / kPiece;
#pragma omp parallel for num_threads(threads) schedule(dynamic, 1)
    for (int64_t i = 0; i < k; ++i) {
      const int64_t a = i * kPiece, b = std::min(n, a + kPiece);
      std::memcpy(dst + a, src + a, b - a);
    }
    return;
  }
  const int64_t per = std::max<int64_t>(1, kPiece / row_bytes);
  const int64_t k = (R + per - 1) / per;
#pragma omp parallel for num_threads(threads) schedule(dynamic, 1)
  for (int64_t i = 0; i < k; ++i) {
    for (int64_t r = i * per; r < std::min(R, (i + 1) * per); ++r) {
      std::memcpy(dst + r * row_bytes, src + r * src_stride, row_bytes);
    }
  }
}

// Chunk c (a row of `table`, (n_chunks, 5) int64: source byte offset, rows,
// row bytes, source row stride, destination byte offset) goes into slot
// c % n_slots by copy_rows, then to dst on `stream`; the slot's event is
// recorded after it. A slot is refilled only once its event has passed, and
// the call returns once the last chunk's has: every copy is on the card.
// Returns 0, or the first error code (after waiting for the copies issued).
int stage_upload(uint64_t dst, const uint8_t* src, const int64_t* table, int64_t n_chunks,
                 uint8_t* const* slots, void* const* events, int32_t n_slots, void* stream,
                 int32_t threads, htod_fn htod, record_fn record, sync_fn sync) {
  int err = 0;
  int64_t recorded = -1;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t* t = table + 5 * c;
    const int32_t k = static_cast<int32_t>(c % n_slots);
    if (c >= n_slots && (err = sync(events[k]))) break;
    copy_rows(slots[k], src + t[0], t[1], t[2], t[3], threads);
    if ((err = htod(dst + t[4], slots[k], static_cast<size_t>(t[1] * t[2]), stream))) break;
    if ((err = record(events[k], stream))) break;
    recorded = c;
  }
  // the last recorded event covers every copy before it on the stream
  if (recorded >= 0) {
    const int e = sync(events[recorded % n_slots]);
    if (!err) err = e;
  }
  return err;
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
