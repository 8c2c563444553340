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
// index order. Here every map cell is owned by exactly one thread, which adds
// the patches whose footprint covers it (directly or wrapped), as often as it
// covers it, in index order. So each cell gets the same f32 sums in the same
// order as the sequential loop, with no atomics, and two runs give identical
// bits.
//
// Design: work only where the batch lands. A batch touches a band of a few
// map rows, and a 16x16 tile of cells meets about 16 of its patches. The grid
// is persistent (a few blocks an SM). Each block first reduces, from the
// coords, the band of rows and columns the footprints can reach, and whether
// any coordinate is negative (then a footprint may wrap to the far edge, and
// the band is the whole map): the band is decided on the card, with no read
// back to the host. The blocks then stride over the band's tiles. For each
// tile a block culls the patches: 256 at a time, each thread tests one, a
// warp ballot and a prefix sum over the warps' counts write the ones that
// meet the tile to a list in shared memory in index order. Each thread then
// walks only that list, its cell's sums held in registers (8 channels at a
// time).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kChannels = 8;  // channels summed in registers per walk

struct Footprint {
  int y, x, sy, sx;
};

__device__ __forceinline__ Footprint footprint(const int32_t* __restrict__ coords,
                                               const int32_t* __restrict__ spans, int i, int f) {
  Footprint p{coords[2 * i], coords[2 * i + 1], f, f};
  if (spans != nullptr) {
    p.sy = max(0, min(spans[2 * i], f));
    p.sx = max(0, min(spans[2 * i + 1], f));
  }
  return p;
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
  __shared__ int band[4];  // min y, max y + f, min x, max x + f (clipped to the map)
  __shared__ int warp_count[kWarps];
  __shared__ int listed[kThreads];
  __shared__ Footprint listed_fp[kThreads];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // 1. the band the batch's footprints can reach, and whether any may wrap
  if (threadIdx.x == 0) {
    band[0] = band[2] = INT_MAX;
    band[1] = band[3] = 0;
  }
  __syncthreads();
  int lo_y = INT_MAX, hi_y = 0, lo_x = INT_MAX, hi_x = 0;
  bool neg = false;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = coords[2 * i], x = coords[2 * i + 1];
    neg |= y < 0 || x < 0;
    lo_y = min(lo_y, y);
    lo_x = min(lo_x, x);
    hi_y = max(hi_y, int(min(int64_t(y) + f, int64_t(dh))));
    hi_x = max(hi_x, int(min(int64_t(x) + f, int64_t(dw))));
  }
  lo_y = __reduce_min_sync(0xffffffffu, lo_y);
  lo_x = __reduce_min_sync(0xffffffffu, lo_x);
  hi_y = __reduce_max_sync(0xffffffffu, hi_y);
  hi_x = __reduce_max_sync(0xffffffffu, hi_x);
  if (lane == 0) {
    atomicMin(&band[0], lo_y);
    atomicMax(&band[1], hi_y);
    atomicMin(&band[2], lo_x);
    atomicMax(&band[3], hi_x);
  }
  const bool wraps = __syncthreads_or(neg);
  int ty0 = 0, ty1 = (dh + kTile - 1) / kTile, tx0 = 0, tx1 = (dw + kTile - 1) / kTile;
  if (!wraps) {  // every footprint starts on the map side of 0: only the band
    ty0 = band[0] / kTile;
    ty1 = (band[1] + kTile - 1) / kTile;
    tx0 = band[2] / kTile;
    tx1 = (band[3] + kTile - 1) / kTile;
  }
  const int ntx = tx1 - tx0;
  const int tiles = ty1 > ty0 && ntx > 0 ? (ty1 - ty0) * ntx : 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t cy0 = int64_t(ty0 + t / ntx) * kTile;
    const int64_t cx0 = int64_t(tx0 + t % ntx) * kTile;
    const int64_t cy = cy0 + threadIdx.x / kTile;
    const int64_t cx = cx0 + threadIdx.x % kTile;
    const bool owner = cy < dh && cx < dw;
    float* cell = acc + (cy * dw + cx) * channels;
    for (int c0 = 0; c0 < channels; c0 += kChannels) {
      const int nc = min(kChannels, channels - c0);
      float sum[kChannels];
#pragma unroll
      for (int k = 0; k < kChannels; ++k) sum[k] = owner && k < nc ? cell[c0 + k] : 0.f;
      for (int base = 0; base < n; base += kThreads) {
        // 2. cull: the patches of [base, base + 256) that meet the tile,
        // listed in index order
        const int i = base + threadIdx.x;
        Footprint p{0, 0, 0, 0};
        bool meet = false;
        if (i < n) {
          p = footprint(coords, spans, i, f);
          meet = meets(cy0, p.y, p.sy, dh) && meets(cx0, p.x, p.sx, dw);
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, meet);
        if (lane == 0) warp_count[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          before += w < warp ? warp_count[w] : 0;
          total += warp_count[w];
        }
        if (meet) {
          const int at = before + __popc(ballot & ((1u << lane) - 1u));
          listed[at] = i;
          listed_fp[at] = p;
        }
        __syncthreads();
        // 3. each owner adds the listed patches that cover its cell
        if (owner) {
          for (int e = 0; e < total; ++e) {
            const Footprint q = listed_fp[e];
            const int times = hits(cy, q.y, q.sy, dh) * hits(cx, q.x, q.sx, dw);  // 2+ only if f > dh or dw
            if (times == 0) continue;
            const float* v = values + int64_t(listed[e]) * channels + c0;
            for (int r = 0; r < times; ++r) {
#pragma unroll
              for (int k = 0; k < kChannels; ++k)
                if (k < nc) sum[k] += v[k];
            }
          }
        }
        __syncthreads();  // the list is rewritten by the next 256 patches
      }
      if (owner) {
#pragma unroll
        for (int k = 0; k < kChannels; ++k)
          if (k < nc) cell[c0 + k] = sum[k];
      }
    }
  }
}

__global__ void empty_kernel() {}

// Blocks of K2's persistent grid for a (dh, dw) map on the current device.
int grid_blocks(int dh, int dw) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = int64_t((dh + kTile - 1) / kTile) * ((dw + kTile - 1) / kTile);
  const int64_t resident = int64_t(sms > 0 ? sms : 1) * kBlocksPerSm;
  return int(tiles < resident ? tiles : resident);
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
    scatter_add_map_kernel<<<grid_blocks(dh, dw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(acc), dh, dw, channels, static_cast<const int32_t*>(coords),
        static_cast<const int32_t*>(spans), static_cast<const float*>(values), n, f);
  }
  return cudaGetLastError();
}

// An empty kernel on K2's grid for a (dh, dw) map: the launch alone, K2's
// floor at its own grid.
extern "C" int dh_empty_launch(int device, int dh, int dw, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  empty_kernel<<<grid_blocks(dh, dw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
