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
// Design: a persistent grid, one block an SM, that streams the windows' input
// rows through a ring of shared-memory slots, so that copies and look-ups
// overlap. The work is cut into items: a group is the input rows one run of
// output bytes is made from (1 row; 4 for s2d4, into one output row; 1 for
// s2d8_to_s2d4, into two), a part a run of whole units of its rows (4x4 cells
// for s2d4, 192-byte s2d8 cells, 16 bytes for hwc), and an item is a block of
// consecutive groups of one window, each cut to the same part, about 12 KB of
// input (plan_int8). A block takes a contiguous range of items. One producer
// warp copies each item's rows with TMA: where the bank's rows are 16-byte
// aligned, as one 2-D box of the bank viewed as rows of 8-byte elements, from
// the 16-byte boundary at or before the part's first byte (a part's row is at
// most 2 KB, the box's 256 elements; rows and columns past the bank's edge
// read as zeros), else with one cp.async.bulk a row, of the aligned-down
// 16-byte span that holds the part's bytes (a window starts at any byte; the
// span lies in the allocation's 16-byte blocks). The copies complete on the
// slot's "full" mbarrier (expect_tx); the producer writes the item's place
// beside the slot (SlotMeta) and runs up to a whole ring ahead. 16 consumer
// warps each own every 16th slot: a warp waits for its slot, makes the item's
// output 16 bytes a lane, in output order, so each warp store writes 512
// contiguous bytes, and frees the slot on its "empty" mbarrier. A lane
// realigns its 16 source bytes as it reads them from shared memory: two
// aligned 16-byte reads and funnel shifts (hwc; s2d8_to_s2d4, whose 96-byte
// runs are whole chunks), or for s2d4 four unaligned words of the cell's
// 4C-byte pieces (two aligned words each). The table is built once a block,
// while the first copies fly: a 32-bit word for each (value, lane), lane l
// reading value u at word 32u + l, so the byte-wise look-ups never meet in a
// bank. What bounds it on the card is the SM's TMA engine: a box costs a
// fixed latency and then its bytes, so items are as large as the ring allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "flash_common.cuh"

namespace {

using flash::DeviceGuard;

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

constexpr int kConsumers = 16;                       // consumer warps of an int8 block
constexpr int kInt8Threads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kTableWords = 256 * 32;                // the table: a word per (value, lane)
constexpr int kSlotTarget = 12288;                   // input bytes a slot holds, at most about
constexpr int kRingBudget = 192 * 1024;              // shared memory of the ring
constexpr int kMaxSlotsPerWarp = 8;
constexpr int kMaxItemRows = 32;        // input rows an item: one a producer lane
constexpr int kBoxBytes = 256 * 8;      // a TMA box's inner extent: 256 elements of 8 bytes
constexpr int kSmemLimit = 227 * 1024;  // a block's dynamic shared memory on Hopper

// An item's place, written by the producer beside its slot.
struct SlotMeta {
  int64_t out;   // the item's first output byte in `out`
  int units;     // units of each of its groups (the part's)
  int nbytes;    // input bytes of each of its rows
  int groups;    // its groups
  uint8_t head[kMaxItemRows];  // each staged row's first byte in its slot row
};

// How a launch cuts its work (plan_int8; ops/gather.py:int8_plan mirrors it).
struct Int8Plan {
  int box;        // 1: an item's rows come in as one 2-D TMA box; 0: a bulk copy a row
  int rows;       // input rows of a group
  int unit;       // input bytes of a unit in each row: 4C (s2d4), 16 (hwc), C (s2d8_to_s2d4)
  int units;      // units of a group
  int per_part;   // units of a part
  int parts;      // parts of a group
  int groups;     // groups of a window
  int per_item;   // groups of an item
  int blocks;     // group blocks of a window: ceil(groups / per_item)
  int row_pitch;  // bytes of a staged row in a slot
  int slot;       // bytes of a slot, a multiple of 128
  int stages;     // slots of the ring, a multiple of kConsumers
  int smem;       // dynamic shared memory of a block (0: the cut does not fit)
  int64_t items;  // n * blocks * parts
  int64_t per_block;
};

__host__ __device__ constexpr int align_up(int v, int a) { return (v + a - 1) / a * a; }

// The barriers and SlotMetas, then the ring, then the table.
__host__ __device__ inline int ring_offset(int stages) {
  return align_up(stages * int(2 * sizeof(uint64_t) + sizeof(SlotMeta)), 128);
}

// An item is a block of per_item groups of a window, each cut to one part
// of its units; its rows are staged row_pitch bytes apart. A row's staged
// bytes start at the 16-byte boundary at or before the part's first byte
// (TMA reads global memory from 16-byte aligned addresses), up to 15 bytes
// early.
Int8Plan plan_int8(int layout, int ps, int channels, int64_t n, bool box) {
  Int8Plan p{};
  const int pad = 15;
  p.box = box;
  p.rows = layout == kS2d4 ? 4 : 1;
  p.unit = layout == kS2d4 ? 4 * channels : layout == kHwc ? 16 : channels;
  p.units = layout == kS2d4 ? ps / 4 : layout == kHwc ? (ps * channels + 15) / 16 : ps;
  p.groups = layout == kS2d4 ? ps / 4 : ps;
  const int target = std::min(kSlotTarget / p.rows, box ? kBoxBytes - pad : INT_MAX);
  const int fit = std::max(1, target / p.unit);  // units a part's row can take
  p.parts = (p.units + fit - 1) / fit;
  p.per_part = (p.units + p.parts - 1) / p.parts;
  p.row_pitch = align_up(p.per_part * p.unit + pad, 16);
  p.per_item = std::max(1, std::min({p.groups, kMaxItemRows / p.rows,
                                     kSlotTarget / (p.rows * p.row_pitch)}));
  p.blocks = (p.groups + p.per_item - 1) / p.per_item;
  p.slot = align_up(p.per_item * p.rows * p.row_pitch, 128);
  const int per_warp = std::max(1, std::min(kMaxSlotsPerWarp, kRingBudget / (kConsumers * p.slot)));
  p.stages = per_warp * kConsumers;
  p.smem = ring_offset(p.stages) + p.stages * p.slot + kTableWords * 4;
  if ((box && p.row_pitch > kBoxBytes) || p.smem > kSmemLimit) p.smem = 0;
  p.items = n * p.blocks * p.parts;
  return p;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The box at element x of row y of a 2-D map into shared address dst.
__device__ __forceinline__ void box_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

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
// reads value u at word 32u + l, in its own bank; the word's low byte holds
// the value.
__device__ __forceinline__ uint32_t look_up(const uint32_t* table, uint32_t word, int lane) {
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out |= (uint32_t(table[(((word >> (8 * k)) & 255u) << 5) | lane]) & 0xffu) << (8 * k);
  return out;
}

__device__ __forceinline__ void store16(int8_t* dst, uint4 v, int count, bool vec) {
  if (vec && count == 16) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    for (int b = 0; b < count; ++b) dst[b] = int8_t(w[b >> 2] >> (8 * (b & 3)));
  }
}

// One item, by one warp: its output bytes in order, 16 a lane. The item's
// groups are staged one after the other (rows * row_pitch bytes each), and
// their outputs follow each other in `out`, out_len bytes apart.
template <int LAYOUT, int CH>
__device__ __forceinline__ void consume(const uint8_t* slot, const SlotMeta& meta,
                                        const uint32_t* table, int lane, int channels, int ps,
                                        int row_pitch, int8_t* __restrict__ out) {
  const int units = meta.units, nbytes = meta.nbytes, groups = meta.groups;
  int8_t* dst = out + meta.out;
  if (LAYOUT == kHwc) {  // the row as it is: output chunk q is input chunk q
    const int per_group = (nbytes + 15) >> 4;
    const int64_t out_len = int64_t(ps) * channels;
    for (int f = lane; f < groups * per_group; f += 32) {
      const int gi = f / per_group;
      const int q = f - gi * per_group;
      const int head = meta.head[gi];
      const uint4* chunk = reinterpret_cast<const uint4*>(slot + gi * row_pitch);
      uint4 v = chunk[q];
      if (head != 0) {
        const bool next = 16 * (q + 1) < head + nbytes;  // inside the staged span
        v = shift_bytes(v, next ? chunk[q + 1] : make_uint4(0, 0, 0, 0), head);
      }
      v = make_uint4(look_up(table, v.x, lane), look_up(table, v.y, lane),
                     look_up(table, v.z, lane), look_up(table, v.w, lane));
      int8_t* o = dst + gi * out_len + 16 * q;
      store16(o, v, min(16, nbytes - 16 * q), (reinterpret_cast<uintptr_t>(o) & 15) == 0);
    }
  } else if (LAYOUT == kS2d8To4) {
    // output row si takes 96 bytes at si * 96 of each 192-byte cell: its
    // chunk q is input chunk 12 * (q / 6) + 6 * si + q % 6
    const int per_row = 6 * units;
    const int64_t row_out = int64_t(ps) * 96;  // a group's output: 2 rows
    for (int f = lane; f < groups * 2 * per_row; f += 32) {
      const int gi = f / (2 * per_row);
      const int si = f - gi * 2 * per_row >= per_row;
      const int q = f - gi * 2 * per_row - si * per_row;
      const int c = 12 * (q / 6) + 6 * si + q % 6;
      const int head = meta.head[gi];
      const uint4* chunk = reinterpret_cast<const uint4*>(slot + gi * row_pitch);
      uint4 v = chunk[c];
      if (head != 0) v = shift_bytes(v, chunk[c + 1], head);
      v = make_uint4(look_up(table, v.x, lane), look_up(table, v.y, lane),
                     look_up(table, v.z, lane), look_up(table, v.w, lane));
      int8_t* o = dst + (2 * gi + si) * row_out + 16 * q;
      store16(o, v, 16, (reinterpret_cast<uintptr_t>(o) & 15) == 0);
    }
  } else {  // s2d4: a cell's 16C bytes are the 4C-byte pieces of its 4 rows
    const int C = CH > 0 ? CH : channels;
    const int per_group = units * C;  // 16-byte chunks
    const int64_t out_len = int64_t(4) * ps * C;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(slot);
    for (int f = lane; f < groups * per_group; f += 32) {
      const int gi = f / per_group;
      const int q = f - gi * per_group;
      const int j = q / C;
      const int k = q - j * C;
      const int row0 = 4 * gi * row_pitch;
      uint32_t o[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {  // output word 4k + w: word kk of row ry's piece
        const int ry = (4 * k + w) / C;
        const int kk = 4 * k + w - ry * C;
        const int off = row0 + ry * row_pitch + meta.head[4 * gi + ry] + 4 * (C * j + kk);
        o[w] = __funnelshift_r(words[off >> 2], words[(off >> 2) + 1], (off & 3) * 8);
      }
      const uint4 v = make_uint4(look_up(table, o[0], lane), look_up(table, o[1], lane),
                                 look_up(table, o[2], lane), look_up(table, o[3], lane));
      int8_t* dsto = dst + gi * out_len + 16 * q;
      store16(dsto, v, 16, (reinterpret_cast<uintptr_t>(dsto) & 15) == 0);
    }
  }
}

// out[window n, group g] = lut[bank[...]] in LAYOUT (CH: the channels at
// compile time, 0 for any), one block an SM over plan.per_block items each.
// `map` is the bank as a 2-D map of 8-byte elements when plan.box is set.
template <int LAYOUT, int CH>
__global__ void __launch_bounds__(kInt8Threads, 1) gather_quantize_int8_kernel(
    const uint8_t* __restrict__ bank, int slides, int height, int width, int channels,
    const int32_t* __restrict__ slide_idx, const int32_t* __restrict__ coords, int ps,
    const int8_t* __restrict__ lut, const Int8Plan plan, const __grid_constant__ CUtensorMap map,
    int8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int stages = plan.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  SlotMeta* meta = reinterpret_cast<SlotMeta*>(empty + stages);
  uint8_t* ring = smem + ring_offset(stages);
  // after the ring, so the one word s2d4 reads past a slot's last row is in it
  uint32_t* table = reinterpret_cast<uint32_t*>(ring + stages * plan.slot);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t first = blockIdx.x * plan.per_block;
  const int count = int(min(plan.items - first, plan.per_block));

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      flash::mbar_init(flash::smem_addr(full + i), 1);
      flash::mbar_init(flash::smem_addr(empty + i), 1);
    }
    flash::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // the producer
    constexpr int R = LAYOUT == kS2d4 ? 4 : 1;
    const int len = ps * channels;
    const int64_t row_bytes = int64_t(width) * channels;
    const int out_unit = LAYOUT == kS2d4 ? 16 * channels : LAYOUT == kHwc ? 16 : 96;
    const int64_t out_len = LAYOUT == kS2d4 ? int64_t(4) * len : len;  // a group's output
    // the first item's (window, group block, part), then counted on
    int part = int(first % plan.parts);
    int gb = int(first / plan.parts % plan.blocks);
    int64_t n = first / plan.parts / plan.blocks;
    int win_row = -1, win_col = 0;  // the window's first bank row (s * height + y) and byte (x * C)
    // slot it % stages in its round it / stages, counted on
    for (int it = 0, slot = 0, round = 0; it < count; ++it) {
      if (round > 0) flash::mbar_wait_or_trap(flash::smem_addr(empty + slot), (round - 1) & 1);
      if (win_row < 0) {
        const int s = dynamic_slice_start(slide_idx[n], slides, 1);
        const int y = dynamic_slice_start(coords[2 * n], height, ps);
        const int x = dynamic_slice_start(coords[2 * n + 1], width, ps);
        win_row = s * height + y;
        win_col = x * channels;
      }
      const int u0 = part * plan.per_part;
      const int u1 = min(plan.units, u0 + plan.per_part);
      const int col = win_col + u0 * plan.unit;  // the part's first byte in its bank rows
      const int nbytes = min(u1 * plan.unit, len) - u0 * plan.unit;
      const int g0 = gb * plan.per_item;
      const int groups = min(plan.per_item, plan.groups - g0);
      const int row0 = win_row + (LAYOUT == kS2d4 ? 4 * g0 : g0);  // the item's rows: one a lane
      SlotMeta& m = meta[slot];
      const uint8_t* src = nullptr;
      uint32_t span = 0, tx;
      if (plan.box) {  // the whole box, rows past the bank's end read as zeros
        if (lane < groups * R) m.head[lane] = uint8_t(col & 15);
        tx = uint32_t(plan.per_item * R * plan.row_pitch);
      } else {  // each row's aligned-down 16-byte span
        if (lane < groups * R) {
          const uint8_t* a = bank + int64_t(row0 + lane) * row_bytes + col;
          const int head = int(reinterpret_cast<uintptr_t>(a) & 15);
          m.head[lane] = uint8_t(head);
          src = a - head;
          span = uint32_t(align_up(head + nbytes, 16));
        }
        tx = __reduce_add_sync(0xffffffffu, span);
      }
      if (lane == 0) {
        m.out = (n * plan.groups + g0) * out_len + int64_t(u0) * out_unit;
        m.units = u1 - u0;
        m.nbytes = nbytes;
        m.groups = groups;
      }
      __syncwarp();
      const uint32_t bar = flash::smem_addr(full + slot);
      const uint32_t dst = flash::smem_addr(ring + slot * plan.slot);
      if (lane == 0) {
        flash::mbar_arrive_expect_tx(bar, tx);  // releases the SlotMeta with the phase
        if (plan.box) box_load(dst, &map, (col & ~15) >> 3, row0, bar);
      }
      __syncwarp();
      if (src != nullptr) bulk_load(dst + lane * plan.row_pitch, src, span, bar);
      if (++slot == stages) {
        slot = 0;
        ++round;
      }
      if (++part == plan.parts) {
        part = 0;
        if (++gb == plan.blocks) {
          gb = 0;
          ++n;
          win_row = -1;
        }
      }
    }
    return;
  }

  // the consumers: the table (while the first copies fly), then every
  // kConsumers-th slot, each slot always by the same warp
  for (int i = threadIdx.x; i < kTableWords; i += 32 * kConsumers)
    table[i] = uint8_t(lut[i >> 5]);
  flash::named_barrier(1, 32 * kConsumers);
  for (int it = warp, slot = warp, round = 0; it < count; it += kConsumers) {
    flash::mbar_wait_or_trap(flash::smem_addr(full + slot), round & 1);
    consume<LAYOUT, CH>(ring + slot * plan.slot, meta[slot], table, lane, channels, ps,
                        plan.row_pitch, out);
    __syncwarp();
    if (lane == 0) flash::mbar_arrive(flash::smem_addr(empty + slot));
    slot += kConsumers;
    if (slot >= stages) {
      slot -= stages;
      ++round;
    }
  }
}

template <int LAYOUT, int CH>
cudaError_t launch_int8(const void* bank, int slides, int height, int width, int channels,
                        const void* slide_idx, const void* coords, int ps, const void* lut,
                        const Int8Plan& plan, const CUtensorMap& map, int blocks, void* out,
                        cudaStream_t stream) {
  auto kernel = gather_quantize_int8_kernel<LAYOUT, CH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kInt8Threads, plan.smem, stream>>>(
      static_cast<const uint8_t*>(bank), slides, height, width, channels,
      static_cast<const int32_t*>(slide_idx), static_cast<const int32_t*>(coords), ps,
      static_cast<const int8_t*>(lut), plan, map, static_cast<int8_t*>(out));
  return cudaGetLastError();
}

// The bank as a 2-D map of 8-byte elements: (slides * height) rows of
// width * channels / 8, one box an item.
cudaError_t encode_bank_map(CUtensorMap* map, const void* bank, int slides, int height,
                            int width, int channels, const Int8Plan& plan) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const cudaError_t err = flash::tiled_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t row = cuuint64_t(width) * channels;
  const cuuint64_t dims[2] = {row / 8, cuuint64_t(slides) * height}, strides[1] = {row};
  const cuuint32_t box[2] = {cuuint32_t(plan.row_pitch / 8), cuuint32_t(plan.per_item * plan.rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 2, const_cast<void*>(bank), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
  if (layout < kHwc || layout > kS2d8To4 || (layout == kS2d4 && ps % 4 != 0) ||
      (layout == kS2d8To4 && channels != 192)) {
    return cudaErrorInvalidValue;
  }
  if (n <= 0 || ps <= 0) return cudaGetLastError();
  // a box of 8-byte elements needs 16-byte aligned rows and base, and no
  // more columns or rows than the bank has
  const int64_t row = int64_t(width) * channels;
  Int8Plan plan = plan_int8(layout, ps, channels, n, true);
  if (row % 16 != 0 || (reinterpret_cast<uintptr_t>(bank) & 15) != 0 || plan.smem == 0 ||
      plan.row_pitch > row || plan.per_item * plan.rows > int64_t(slides) * height) {
    plan = plan_int8(layout, ps, channels, n, false);
  }
  if (plan.smem == 0) return cudaErrorInvalidValue;
  CUtensorMap map{};
  if (plan.box) {
    const cudaError_t err = encode_bank_map(&map, bank, slides, height, width, channels, plan);
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block an SM, each over a contiguous run of items
  plan.per_block = (plan.items + sms - 1) / sms;
  const int blocks = int((plan.items + plan.per_block - 1) / plan.per_block);
  auto s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kHwc:
      return launch_int8<kHwc, 0>(bank, slides, height, width, channels, slide_idx, coords, ps,
                                  lut, plan, map, blocks, out, s);
    case kS2d4:
      if (channels == 3) {
        return launch_int8<kS2d4, 3>(bank, slides, height, width, channels, slide_idx, coords,
                                     ps, lut, plan, map, blocks, out, s);
      }
      return launch_int8<kS2d4, 0>(bank, slides, height, width, channels, slide_idx, coords, ps,
                                   lut, plan, map, blocks, out, s);
    default:
      return launch_int8<kS2d8To4, 0>(bank, slides, height, width, channels, slide_idx, coords,
                                      ps, lut, plan, map, blocks, out, s);
  }
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
