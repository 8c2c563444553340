// K2: stitch. Adds each patch's vector over its footprint in a downscaled map:
//   acc[y_i + a, x_i + b, :] += values[i, :]   for a < min(span_y_i, f), b < min(span_x_i, f)
// with the indices of JAX's .at[yy, xx].add(mode="drop"): one in [-dh, 0)
// (or [-dw, 0)) is first wrapped to the far edge, as NumPy indexing does, and
// any cell still outside the map is dropped. So a patch that straddles row or
// column 0 adds to up to four rectangles of the map.
//
// Replaces deephisto_tpu/ops/stitch.py:scatter_add_map (the XLA scatter-add at
// :107 that scatter_add_map_exact calls; ROADMAP item B5). XLA lowered it on the
// TPU; PyTorch has no deterministic op for it.
//
// Bound: bytes. A call reads values (N*C*4 B) and coords (N*8 B, spans as many),
// and reads and writes every touched map cell once (2*C*4 B each). A main-path
// batch (N=256 patches of a 224/112 grid, f=14, C=5) touches about 28 map rows
// of 1024 cells: ~1.2 MB, under a microsecond at 3.35 TB/s. The adds are few.
//
// Design: determinism. XLA applies a scatter's updates one after another in
// index order. Here every map cell is owned by exactly one thread, which walks
// the patches in index order and adds each one whose footprint covers it
// (directly or wrapped), as often as it covers it. So
// each cell gets the same f32 sums in the same order as the sequential loop,
// with no atomics, and two runs give identical bits. A block owns a 16x16 tile
// of cells and first asks, over all threads, whether any patch touches the tile;
// an untouched tile returns after one pass over the coords.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

__device__ __forceinline__ void footprint(const int32_t* __restrict__ coords,
                                          const int32_t* __restrict__ spans, int i, int f,
                                          int64_t* y, int64_t* x, int* sy, int* sx) {
  *y = coords[2 * i];
  *x = coords[2 * i + 1];
  *sy = f;
  *sx = f;
  if (spans != nullptr) {
    *sy = max(0, min(spans[2 * i], f));
    *sx = max(0, min(spans[2 * i + 1], f));
  }
}

// The times cell index c of an axis of extent d is hit by a footprint
// starting at y with span sy: once directly (c in [y, y + sy)), once more if
// it is the wrap of an index in [-d, 0) (c in [y + d, min(y + sy, 0) + d)).
__device__ __forceinline__ int hits(int64_t c, int64_t y, int sy, int d) {
  return int(c >= y && c < y + sy) + int(c >= y + d && c < min(y + sy, int64_t(0)) + d);
}

// Whether [t0, t0 + kTile) meets the direct or (y < 0) the wrapped footprint.
__device__ __forceinline__ bool meets(int64_t t0, int64_t y, int sy, int d) {
  return (y < t0 + kTile && y + sy > t0) ||
         (y < 0 && y + d < t0 + kTile && min(y + sy, int64_t(0)) + d > t0);
}

__global__ void __launch_bounds__(kThreads) scatter_add_map_kernel(
    float* __restrict__ acc, int dh, int dw, int channels, const int32_t* __restrict__ coords,
    const int32_t* __restrict__ spans, const float* __restrict__ values, int n, int f) {
  const int64_t ty0 = int64_t(blockIdx.y) * kTile;
  const int64_t tx0 = int64_t(blockIdx.x) * kTile;
  int64_t y, x;
  int sy, sx;

  bool touched = false;
  for (int i = threadIdx.x; i < n && !touched; i += kThreads) {
    footprint(coords, spans, i, f, &y, &x, &sy, &sx);
    touched = meets(ty0, y, sy, dh) && meets(tx0, x, sx, dw);
  }
  if (!__syncthreads_or(touched)) return;
  // whether any patch wraps: then the walk counts a footprint's hits of a cell
  bool neg = false;
  for (int i = threadIdx.x; i < n; i += kThreads) neg |= coords[2 * i] < 0 || coords[2 * i + 1] < 0;
  const bool wraps = __syncthreads_or(neg);

  const int64_t cy = ty0 + threadIdx.x / kTile;
  const int64_t cx = tx0 + threadIdx.x % kTile;
  if (cy >= dh || cx >= dw) return;
  float* cell = acc + (cy * dw + cx) * channels;
  if (!wraps) {  // every footprint on the map side of 0: one rectangle each
    for (int i = 0; i < n; ++i) {
      footprint(coords, spans, i, f, &y, &x, &sy, &sx);
      if (cy >= y && cy < y + sy && cx >= x && cx < x + sx) {
        const float* v = values + int64_t(i) * channels;
        for (int c = 0; c < channels; ++c) cell[c] += v[c];
      }
    }
    return;
  }
  for (int i = 0; i < n; ++i) {
    footprint(coords, spans, i, f, &y, &x, &sy, &sx);
    const int times = hits(cy, y, sy, dh) * hits(cx, x, sx, dw);  // 2 only if f > dh or dw
    const float* v = values + int64_t(i) * channels;
    for (int t = 0; t < times; ++t)
      for (int c = 0; c < channels; ++c) cell[c] += v[c];
  }
}

// Makes `device` current for one call and gives the caller's device back.
struct DeviceGuard {
  int prev = 0;
  bool switched = false;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
};

}  // namespace

// acc: (dh, dw, channels) f32, contiguous, updated in place; coords: (n, 2)
// int32 (y, x) in map cells; spans: (n, 2) int32 or null (then f x f);
// values: (n, channels) f32.
extern "C" int dh_scatter_add_map(int device, void* acc, int dh, int dw, int channels,
                                  const void* coords, const void* spans, const void* values,
                                  int n, int f, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n > 0 && f > 0 && dh > 0 && dw > 0) {
    const dim3 grid((dw + kTile - 1) / kTile, (dh + kTile - 1) / kTile);
    scatter_add_map_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), dh, dw, channels, static_cast<const int32_t*>(coords),
        static_cast<const int32_t*>(spans), static_cast<const float*>(values), n, f);
  }
  return cudaGetLastError();
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
