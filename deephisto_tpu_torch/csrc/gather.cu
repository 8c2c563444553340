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
//
// int8 mode (dh_gather_quantize_int8), the input of both int8 predicts: the
// multi-slide gather, each byte u replaced by lut[u] (int8), written in the
// layout the int8 ResNet's stem takes. It fuses what the JAX package runs
// after its gather, the input quantize of QuantizedResNet
// (deephisto_tpu/models/quantize.py:493-496, round(u8 * inv0/255) clipped to
// +-127: the wrapper's table holds its 256 values) and the s2d stem's pack
// (the stem's 4x4 space-to-depth, or the fcn staging's 8x8 form taken back to
// 4x4). Layouts:
//   hwc           the window as it is, (ps, ps, C);
//   s2d4          (ps/4, ps/4, 16C), channel (ry*4 + rx)*C + c;
//   s2d8_to_s2d4  a (t, t, 192) "s2d8" window, channel (si*2 + sj)*48 + c4,
//                 as (2t, 2t, 48): output row 2i + si takes from each cell
//                 of row i its 96 bytes at si*96.
// Bound: bytes. The slide bytes under the union of the windows read once, the
// int8 output written once: an exact batch (256 windows of 224² RGB at stride
// 112) reads ~15 MB and writes 38.5 MB, 16 us at 3.35 TB/s; an fcn step (16
// tiles of 144² x 192) moves 2 x 63.7 MB, 38 us.
// Design: a block takes a window and a few groups of output rows in turn
// (a group: 1 output row; 2 for s2d8_to_s2d4, from one input row). A
// group's input rows (1; 4 for s2d4) are read as aligned 16-byte chunks, so
// a window that starts at any byte is read at full width (a 16-byte aligned
// chunk that holds one byte of the row lies in pages the slide's allocation
// owns), shifted by the row's offset in its first chunk with funnel shifts,
// and stored in shared memory from offset 0. Each thread then writes 16
// consecutive output bytes with one 16-byte store. It reads their source
// as one 16-byte word (hwc; s2d8_to_s2d4, whose 96-byte runs are whole
// chunks) or as four 4-byte words (s2d4: a cell's 16C bytes are 4C-byte
// pieces of the 4 input rows, C words each), so no read is byte-wide, and
// looks each byte up in the table. The table sits in shared memory with one
// copy per lane (value u of lane l at byte 32u + l, 8 KB): random bytes then
// meet in a bank only within a quad of lanes. A block sets it up once for
// its groups; the launch gives each block enough groups to keep about 4096
// blocks.

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

enum Int8Layout { kHwc = 0, kS2d4 = 1, kS2d8To4 = 2 };  // ops/gather.py INT8_LAYOUTS

template <int LAYOUT> struct LayoutRows { static constexpr int value = 1; };
template <> struct LayoutRows<kS2d4> { static constexpr int value = 4; };

constexpr int kTableBytes = 256 * 32;  // the table, one byte per (value, lane)
constexpr int kInt8Blocks = 4096;      // blocks to aim for: output row groups a block takes in turn

// Bytes [head, head + 16) of the 32 bytes a ++ b.
__device__ __forceinline__ uint4 shift_bytes(uint4 a, uint4 b, int head) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = head >> 2;
  const uint32_t bits = (head & 3) * 8;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
    const uint32_t hi = q == 0 ? w[j + 1] : q == 1 ? w[j + 2] : q == 2 ? w[j + 3] : w[j + 4];
    o[j] = __funnelshift_r(lo, hi, bits);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The table's values of the 4 bytes of `word`, packed as they were. Lane l
// reads value u at byte u * 32 + l: lanes of different quads never meet in
// a bank, so random bytes cost few conflicts.
__device__ __forceinline__ uint32_t look_up(const uint8_t* table, uint32_t word, int lane) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) out |= uint32_t(table[(((word >> (8 * k)) & 255u) << 5) | lane]) << (8 * k);
  return out;
}

// out[n, group g] = lut[bank[...]] in LAYOUT; grid (n, ceil(groups / per_block)):
// groups = ps (hwc, s2d8_to_s2d4) or ps / 4 (s2d4), each block taking
// per_block of them in turn. A group's output is R * len bytes, len = ps *
// channels, contiguous in `out`.
template <int LAYOUT>
__global__ void __launch_bounds__(kThreads) gather_quantize_int8_kernel(
    const uint8_t* __restrict__ bank, int slides, int height, int width, int channels,
    const int32_t* __restrict__ slide_idx, const int32_t* __restrict__ coords, int ps,
    const int8_t* __restrict__ lut, int per_block, int8_t* __restrict__ out) {
  constexpr int R = LayoutRows<LAYOUT>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* table = smem;
  uint8_t* rows = smem + kTableBytes;  // R staged rows, each from offset 0, pitch bytes apart
  const int len = ps * channels;
  const int pitch = (len + 15) & ~15;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kTableBytes / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(table)[i] = uint32_t(uint8_t(lut[i >> 3])) * 0x01010101u;

  const int64_t n = blockIdx.x;
  const int groups = LAYOUT == kS2d4 ? ps / 4 : ps;
  const int s = dynamic_slice_start(slide_idx[n], slides, 1);
  const int y = dynamic_slice_start(coords[2 * n], height, ps);
  const int x = dynamic_slice_start(coords[2 * n + 1], width, ps);
  const int64_t row_bytes = int64_t(width) * channels;
  const int out_len = R * len;
  const int g0 = int(blockIdx.y) * per_block;
  const int g_end = min(groups, g0 + per_block);
  for (int g = g0; g < g_end; ++g) {
    // stage the group's input rows, realigned: the row's first byte at the
    // start of its shared row, read as aligned 16-byte chunks
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int iy = y + (LAYOUT == kS2d4 ? 4 * g + r : g);
      const uintptr_t src = reinterpret_cast<uintptr_t>(
          bank + (int64_t(s) * height + iy) * row_bytes + int64_t(x) * channels);
      const uint4* chunk = reinterpret_cast<const uint4*>(src & ~uintptr_t(15));
      const int head = int(src & 15);
      const int chunks = (head + len + 15) >> 4;  // the aligned chunks that hold the row
      uint4* staged = reinterpret_cast<uint4*>(rows + r * pitch);
      for (int c = threadIdx.x; c < pitch / 16; c += kThreads) {
        const uint4 a = __ldg(chunk + c);
        const uint4 b = head != 0 && c + 1 < chunks ? __ldg(chunk + c + 1) : make_uint4(0, 0, 0, 0);
        staged[c] = head != 0 ? shift_bytes(a, b, head) : a;
      }
    }
    __syncthreads();

    int8_t* dst = out + (n * groups + g) * int64_t(out_len);
    const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
    for (int o0 = threadIdx.x * 16; o0 < out_len; o0 += kThreads * 16) {
      uint4 v;
      if (LAYOUT == kS2d4) {
        // a 16-byte chunk lies in one cell (16C bytes: 4C words): word w
        // of the cell is word w % C of the cell's piece of input row w / C
        const int cell = o0 / (16 * channels);
        int w = (o0 - cell * 16 * channels) / 4;
        int r = w / channels, k = w - r * channels;
        uint32_t word[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          word[j] = reinterpret_cast<const uint32_t*>(rows + r * pitch)[cell * channels + k];
          if (++k == channels) {
            k = 0;
            ++r;
          }
        }
        v = make_uint4(word[0], word[1], word[2], word[3]);
      } else {
        int src = o0;  // hwc: the window row as it is
        if (LAYOUT == kS2d8To4) {
          // output rows 2i, 2i+1 from source row i; 96 = channels / 2 is a
          // multiple of 16, so the 16 bytes are one aligned run
          const int half = channels / 2;
          const int si = o0 / (ps * half);
          const int oo = o0 - si * ps * half;
          const int j = oo / half;
          src = j * channels + si * half + (oo - j * half);
        }
        v = *reinterpret_cast<const uint4*>(rows + src);
      }
      v = make_uint4(look_up(table, v.x, lane), look_up(table, v.y, lane),
                     look_up(table, v.z, lane), look_up(table, v.w, lane));
      const int count = min(16, out_len - o0);
      if (vec && count == 16) {
        *reinterpret_cast<uint4*>(dst + o0) = v;
      } else {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        for (int b = 0; b < count; ++b) dst[o0 + b] = int8_t(w[b >> 2] >> (8 * (b & 3)));
      }
    }
    __syncthreads();  // the rows are restaged for the next group
  }
}

// Dynamic shared memory of one block of the int8 mode: the table and R
// staged rows.
int int8_smem_bytes(int layout, int len) {
  return kTableBytes + (layout == kS2d4 ? 4 : 1) * ((len + 15) & ~15);
}

template <int LAYOUT>
cudaError_t launch_int8(const void* bank, int slides, int height, int width, int channels,
                        const void* slide_idx, const void* coords, int n, int ps,
                        const void* lut, void* out, cudaStream_t stream) {
  const int smem = int8_smem_bytes(LAYOUT, ps * channels);
  auto kernel = gather_quantize_int8_kernel<LAYOUT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // as many row groups a block as keeps about kInt8Blocks blocks, so the
  // table's set-up is paid once for several groups
  const int groups = LAYOUT == kS2d4 ? ps / 4 : ps;
  const int per_block = max(1, min(groups, int(int64_t(n) * groups / kInt8Blocks)));
  const dim3 grid(n, (groups + per_block - 1) / per_block);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bank), slides, height, width, channels,
      static_cast<const int32_t*>(slide_idx), static_cast<const int32_t*>(coords), ps,
      static_cast<const int8_t*>(lut), per_block, static_cast<int8_t*>(out));
  return cudaGetLastError();
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

// bank: (slides, height, width, channels) u8, contiguous; slide_idx: (n,)
// int32; coords: (n, 2) int32 (y, x), clamped as lax.dynamic_slice clamps
// them; lut: 256 int8; layout: an Int8Layout; out: int8, (n, ps, ps,
// channels) for hwc, (n, ps/4, ps/4, 16*channels) for s2d4 (ps % 4 == 0),
// (n, 2ps, 2ps, channels/4) for s2d8_to_s2d4 (channels == 192). ps <= height
// and ps <= width (the wrapper checks).
extern "C" int dh_gather_quantize_int8(int device, const void* bank, int slides, int height,
                                       int width, int channels, const void* slide_idx,
                                       const void* coords, int n, int ps, const void* lut,
                                       int layout, void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if ((layout == kS2d4 && ps % 4 != 0) || (layout == kS2d8To4 && channels != 192) ||
      int8_smem_bytes(layout, ps * channels) > 227 * 1024 - 64) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0 || ps <= 0) return cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kHwc:
      return launch_int8<kHwc>(bank, slides, height, width, channels, slide_idx, coords, n, ps,
                               lut, out, s);
    case kS2d4:
      return launch_int8<kS2d4>(bank, slides, height, width, channels, slide_idx, coords, n, ps,
                                lut, out, s);
    case kS2d8To4:
      return launch_int8<kS2d8To4>(bank, slides, height, width, channels, slide_idx, coords, n,
                                   ps, lut, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
