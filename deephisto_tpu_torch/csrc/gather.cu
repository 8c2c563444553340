// K1: fused patch gather + u8 -> float normalisation.
//
// Replaces the TPU kernel deephisto_tpu/experimental/pallas_gather.py
// _gather_norm_kernel (gather_normalize_pallas, pl.pallas_call at :152), whose
// function the exact predict path computes as gather_patches_xla + model_input:
//   out[n, r, c, ch] = lut[slide[y_n + r, x_n + c, ch]]
// with (y_n, x_n) the start indices clamped as gather_patches_xla's
// lax.dynamic_slice clamps them (dynamic_slice_start), and where lut holds the wrapper's 256 values of u8 / 255 in the output type
// (f32 or the bits of bf16), so the result is bit-identical to the plain
// PyTorch version by construction.
//
// Bound: bytes. A call must read the slide bytes under the union of its
// patches (at most N*ps*ps*C) and write N*ps*ps*C outputs of 2 (bf16) or 4
// (f32) bytes. A main-path batch (N=256, ps=224, C=3, bf16) writes 77.1 MB;
// its patches, at stride 112, overlap by half on both axes and cover about
// 16 MB of the slide: ~93 MB, ~28 us at 3.35 TB/s. There is no arithmetic.
//
// Design. The TPU kernel DMAs an (8, 128)-aligned superblock and realigns it in
// VMEM, because Mosaic copies only tile-aligned windows. Hopper has no such
// rule, so a block reads the patch rows straight from global memory: one block
// per (patch, group of kRows rows). A patch row is ps*C contiguous bytes;
// neighbouring threads take neighbouring 4-byte groups of it, so loads and
// stores are coalesced, and four outputs leave as one 8- or 16-byte store. The
// table is copied into shared memory by each block: a __constant__ table would
// serialise every warp whose lanes read different entries, which random pixel
// values always do.
//
// Multi-slide uint8 mode (dh_gather_multi_u8), the training sampler's gather:
//   out[n, r, c, ch] = bank[s_n, y_n + r, x_n + c, ch]
// from a (S, H, W, C) uint8 bank of padded slides, the counterpart of
// gather_patches_multi_xla (deephisto_tpu/ops/gather.py:59), whose
// lax.dynamic_slice start indices it clamps the same way (a negative index
// counts from the end, then the window is clamped inside the bank), so the
// wrapper need not read the device coords back to check them. The trainer
// crops and flips the uint8 windows and divides afterwards, so the mode
// writes bytes, not K1's u8/255 floats. Bound: bytes, N*ps*ps*C read and
// written (a training batch of 256 windows of 256² RGB: 2 x 50.3 MB, 30 us at
// 3.35 TB/s). Same grid as above; a thread packs 4 neighbouring bytes of a
// row into one 4-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

template <typename T> struct Vec4;
template <> struct Vec4<uint16_t> { using type = uint2; };
template <> struct Vec4<uint32_t> { using type = uint4; };

__device__ __forceinline__ uint2 pack4(uint16_t a, uint16_t b, uint16_t c, uint16_t d) {
  return make_uint2(uint32_t(a) | (uint32_t(b) << 16), uint32_t(c) | (uint32_t(d) << 16));
}
__device__ __forceinline__ uint4 pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return make_uint4(a, b, c, d);
}

// lax.dynamic_slice's start index: a negative one counts from the end, then
// it is clamped so that the slice fits.
__device__ __forceinline__ int dynamic_slice_start(int i, int extent, int size) {
  i = i < 0 ? i + extent : i;
  return min(max(i, 0), extent - size);
}

// T is the output's bit pattern: uint16_t for bf16, uint32_t for f32.
// VEC4 requires ps*C % 4 == 0 (then every 4-group starts 4-aligned in `out`).
template <typename T, bool VEC4>
__global__ void __launch_bounds__(kThreads) gather_normalize_kernel(
    const uint8_t* __restrict__ slide, int height, int width, const int32_t* __restrict__ coords,
    int ps, int channels, const T* __restrict__ lut, T* __restrict__ out) {
  __shared__ T table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = lut[i];
  __syncthreads();

  const int64_t n = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, ps - r0);
  const int row_len = ps * channels;
  const int64_t slide_row = int64_t(width) * channels;
  const int y = dynamic_slice_start(coords[2 * n], height, ps);
  const int x = dynamic_slice_start(coords[2 * n + 1], width, ps);
  const uint8_t* src = slide + (int64_t(y) + r0) * slide_row + int64_t(x) * channels;
  T* dst = out + (n * ps + r0) * row_len;
  if (VEC4) {
    const int quads = row_len / 4;
    for (int q = threadIdx.x; q < rows * quads; q += kThreads) {
      const int r = q / quads;
      const int c = (q - r * quads) * 4;
      const uint8_t* s = src + r * slide_row + c;
      *reinterpret_cast<typename Vec4<T>::type*>(dst + int64_t(r) * row_len + c) =
          pack4(table[s[0]], table[s[1]], table[s[2]], table[s[3]]);
    }
  } else {
    for (int q = threadIdx.x; q < rows * row_len; q += kThreads) {
      const int r = q / row_len;
      const int c = q - r * row_len;
      dst[int64_t(r) * row_len + c] = table[src[r * slide_row + c]];
    }
  }
}

template <typename T>
void launch(const void* slide, int height, int width, int channels, const void* coords, int n,
            int ps, const void* lut, void* out, cudaStream_t stream) {
  const dim3 grid(n, (ps + kRows - 1) / kRows);
  const auto* s = static_cast<const uint8_t*>(slide);
  const auto* c = static_cast<const int32_t*>(coords);
  const auto* t = static_cast<const T*>(lut);
  auto* o = static_cast<T*>(out);
  if ((ps * channels) % 4 == 0) {
    gather_normalize_kernel<T, true>
        <<<grid, kThreads, 0, stream>>>(s, height, width, c, ps, channels, t, o);
  } else {
    gather_normalize_kernel<T, false>
        <<<grid, kThreads, 0, stream>>>(s, height, width, c, ps, channels, t, o);
  }
}

__global__ void __launch_bounds__(kThreads) gather_multi_u8_kernel(
    const uint8_t* __restrict__ bank, int slides, int height, int width, int channels,
    const int32_t* __restrict__ slide_idx, const int32_t* __restrict__ coords, int ps,
    uint8_t* __restrict__ out) {
  const int64_t n = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, ps - r0);
  const int row_len = ps * channels;
  const int64_t slide_row = int64_t(width) * channels;
  const int s = dynamic_slice_start(slide_idx[n], slides, 1);
  const int y = dynamic_slice_start(coords[2 * n], height, ps);
  const int x = dynamic_slice_start(coords[2 * n + 1], width, ps);
  const uint8_t* src = bank + (int64_t(s) * height + y + r0) * slide_row + int64_t(x) * channels;
  uint8_t* dst = out + (n * ps + r0) * row_len;
  if (row_len % 4 == 0) {  // every row of `out` starts 4-aligned
    const int quads = row_len / 4;
    for (int q = threadIdx.x; q < rows * quads; q += kThreads) {
      const int r = q / quads;
      const int c = (q - r * quads) * 4;
      const uint8_t* b = src + r * slide_row + c;
      *reinterpret_cast<uint32_t*>(dst + int64_t(r) * row_len + c) =
          uint32_t(b[0]) | (uint32_t(b[1]) << 8) | (uint32_t(b[2]) << 16) | (uint32_t(b[3]) << 24);
    }
  } else {
    for (int q = threadIdx.x; q < rows * row_len; q += kThreads) {
      const int r = q / row_len;
      const int c = q - r * row_len;
      dst[int64_t(r) * row_len + c] = src[r * slide_row + c];
    }
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

// slide: (height, width, channels) u8, contiguous; coords: (n, 2) int32
// (y, x), clamped as lax.dynamic_slice clamps them; ps <= height and
// ps <= width (the wrapper checks); lut: 256 outputs of out_bytes each; out:
// (n, ps, ps, channels) of out_bytes (2: bf16, 4: f32).
extern "C" int dh_gather_normalize(int device, const void* slide, int height, int width,
                                   int channels, const void* coords, int n, int ps,
                                   const void* lut, int out_bytes, void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n > 0 && ps > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    if (out_bytes == 2) {
      launch<uint16_t>(slide, height, width, channels, coords, n, ps, lut, out, s);
    } else if (out_bytes == 4) {
      launch<uint32_t>(slide, height, width, channels, coords, n, ps, lut, out, s);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

// bank: (slides, height, width, channels) u8, contiguous; slide_idx: (n,)
// int32; coords: (n, 2) int32 (y, x), clamped as lax.dynamic_slice clamps
// them; out: (n, ps, ps, channels) u8. ps <= height and ps <= width (the
// wrapper checks).
extern "C" int dh_gather_multi_u8(int device, const void* bank, int slides, int height, int width,
                                  int channels, const void* slide_idx, const void* coords, int n,
                                  int ps, void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n > 0 && ps > 0) {
    const dim3 grid(n, (ps + kRows - 1) / kRows);
    gather_multi_u8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(bank), slides, height, width, channels,
        static_cast<const int32_t*>(slide_idx), static_cast<const int32_t*>(coords), ps,
        static_cast<uint8_t*>(out));
  }
  return cudaGetLastError();
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
