// Device helpers shared by the flash-attention kernels (K3 in attention.cu,
// K4 and K5 in attention_bwd.cu): cp.async tile loads, ldmatrix, the
// m16n8k16 bf16 mma.sync with f32 accumulators, ex2.approx, bf16 packing,
// the row sums di = Σ O∘dO, operand strides, the kernel designs, the device
// guard of the C entry points, and Hopper's 128-byte swizzled tiles, wgmma
// descriptors, wgmma m64n64k16 (A from shared memory or registers) and its
// fences, mbarriers (and a wait that traps after 4 s), TMA copies,
// setmaxnreg, and the host-side TMA map of an operand (encode_tile_map).
// K6 (conv_int8.cu) and K1's int8 mode (gather.cu) take the mbarriers and
// the device guard from here too.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4·g + c): an accumulator
// d[0..3] holds rows g, g, g+8, g+8 and columns 2c, 2c+1, 2c, 2c+1 of its
// 16×8 tile; an A fragment a[0..3] holds rows g, g+8, g, g+8 and column
// pairs 2c.., 2c.., 8+2c.., 8+2c.. of its 16×16 tile. So the accumulators of
// two neighbouring 8-column tiles, packed to bf16 pairwise, are the A
// fragment of one 16-deep step: that is how P and dS go from one product to
// the next without a trip through shared memory.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;   // rows per block tile and per streamed tile
constexpr int kWarps = 4;   // bf16 paths: 16 rows of the block tile per warp
constexpr int kWgThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// The kernel designs of the three attention kernels, by the codes that
// ops/attention.py:DESIGNS passes (ops/attention.py:attention_design chooses
// one per dtype and head width; an entry point refuses a design that has no
// kernel there).
enum Design : int { kSimt = 0, kMmaSync = 1, kWgmma = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a·b for one m16n8k16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx: relative error ~2^-22; 2^-inf = +0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) x[t][0] = x[t][1] = x[t][2] = x[t][3] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {  // element strides of one (B, H, N, Dh) operand; Dh's is 1
  int64_t b, h, n;
};

// One 64-row tile of a (N, DH) bf16 operand into shared memory rows of LD
// elements, by 16-byte cp.async from all kWarps·32 threads; rows >= n are
// zero-filled.
template <int DH, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int row0, int n) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kWarps * 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const __nv_bfloat16* g = src + int64_t(min(gr, n - 1)) * row_stride + col;
    cp_async16(dst + r * LD + col, g, gr < n ? 16 : 0);
  }
}

// The A fragments (16 rows of this warp × DH) of a tile held in shared
// memory with rows of LD elements.
template <int DH, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DH / 16][4],
                                             const __nv_bfloat16* tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(f[kk], tile + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// acc[t] += A·Bᵀ over DH for 8 column tiles of 8: A is this warp's 16 rows
// (fragments in registers), B the 64 rows of a shared-memory tile (the
// product's columns), e.g. S = Q·Kᵀ.
template <int DH, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[DH / 16][4],
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      uint32_t r[4];  // b0, b1 of column tiles t and t+1
      ldmatrix_x4(r, b + (t * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(acc[t], a[kk], r[0], r[1]);
      mma_bf16(acc[t + 1], a[kk], r[2], r[3]);
    }
  }
}

// acc[d] += P·B over the 64 rows of a shared-memory tile B (64 × DH): P is
// this warp's 16 × 64 operand as the A fragments of 4 steps of 16, e.g.
// O += P·V.
template <int DH, int LD>
__device__ __forceinline__ void mma_pb(float (&acc)[DH / 8][4], const uint32_t (&p)[4][4],
                                       const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int d = 0; d < DH / 8; d += 2) {
      uint32_t r[4];  // b0, b1 of dh column tiles d and d+1, B transposed
      ldmatrix_x4_trans(r, b + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + d * 8 +
                               (lane / 16) * 8);
      mma_bf16(acc[d], p[kk], r[0], r[1]);
      mma_bf16(acc[d + 1], p[kk], r[2], r[3]);
    }
  }
}

// The 16 × 64 accumulators of 8 column tiles as bf16 A fragments of 4
// 16-deep steps (see the layout note at the top).
__device__ __forceinline__ void pack_a_frags(uint32_t (&f)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    f[t / 2][(t % 2) * 2 + 0] = pack_bf16(x[t][0], x[t][1]);
    f[t / 2][(t % 2) * 2 + 1] = pack_bf16(x[t][2], x[t][3]);
  }
}

// Stores rows g and g+8 of this warp's 16 × DH accumulators as bf16 to the
// rows row0 + g (+8) of a (N, DH) operand, rows >= n skipped.
template <int DH>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, int64_t row_stride, int row0,
                                                int n, const float (&acc)[DH / 8][4], int lane,
                                                float scale0 = 1.f, float scale1 = 1.f) {
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    const float s = r ? scale1 : scale0;
    __nv_bfloat16* out = dst + int64_t(row) * row_stride + 2 * c;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      *reinterpret_cast<uint32_t*>(out + d * 8) =
          pack_bf16(acc[d][2 * r] * s, acc[d][2 * r + 1] * s);
  }
}

// di = Σ_d O∘dO in f32 for the 64 rows row0.. of one head, by 128 threads (two
// per row, each half the row, read as 16-byte loads), into sD[0..64) and
// di[row0..row0 + 64) of a buffer padded to a multiple of 64 rows; rows >= n
// get di = 0. O and dO rows are 16-byte aligned.
template <int DH>
__device__ __forceinline__ void row_di(float* sD, float* di, const __nv_bfloat16* o, int64_t so_n,
                                       const __nv_bfloat16* dout, int64_t sdo_n, int row0, int n) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2, row = row0 + r;
  float s = 0.f;
  if (row < n) {
    const __nv_bfloat16* po = o + int64_t(row) * so_n + half * (DH / 2);
    const __nv_bfloat16* pd = dout + int64_t(row) * sdo_n + half * (DH / 2);
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const uint4 a = *reinterpret_cast<const uint4*>(po + c * 8);
      const uint4 b = *reinterpret_cast<const uint4*>(pd + c * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fa = __bfloat1622float2(a2[e]), fb = __bfloat1622float2(b2[e]);
        s = fmaf(fa.x, fb.x, s);
        s = fmaf(fa.y, fb.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0) sD[r] = di[row] = s;
}

// ---- Hopper: 128-byte swizzled tiles and wgmma (sm_90a) ---------------------
//
// A 64 × 64 bf16 tile (a 128-byte row per tile row) lies in shared memory in
// the 128-byte swizzled layout that TMA's SWIZZLE_128B writes and wgmma's B128
// descriptors read: row r at byte r·128, its 16-byte chunk c at chunk
// c ^ (r % 8), the tile's base 1024-byte aligned (the swizzle acts on address
// bits 4-9). One such tile serves as a K-major operand (its rows are the
// product's M or N, its 64 columns the reduction, e.g. Q in S = Q·Kᵀ) and as
// an MN-major one (its rows are the reduction, its columns N, e.g. K in
// dQ = dS·K; the transpose bit of the bf16 wgmma). Both descriptors step from
// one 8-row group to the next by 1024 bytes (SBO). LBO is not read for a
// swizzled K-major operand (1, as CUTLASS writes it); for an MN-major one it
// is the step between 64-column chunks, which a tile only 64 columns wide
// never takes, and it is given 1024 too. A 16-deep k-step moves a K-major
// descriptor 32 bytes along the rows and an MN-major one 16 rows (2048
// bytes) down.
//
// wgmma.m64n64k16 with f32 accumulators: warp w of the warpgroup holds rows
// 16w..16w+15 of the 64 × 64 result in the mma.sync m16n8 accumulator layout
// above (float[8][4]: 8 column tiles of 8), and an A operand in registers is
// the m16n8k16 A fragment of those 16 rows; so pack_a_frags turns one
// product's accumulators into the next one's A operand here too.

constexpr int kSwTileBytes = kTile * 128;  // one 64 × 64 bf16 tile

__device__ __forceinline__ uint32_t align1024(uint32_t a) { return (a + 1023) & ~1023u; }

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo_bytes) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(lbo_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t sw128_desc_k(uint32_t saddr) { return sw128_desc(saddr, 16); }
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t saddr) { return sw128_desc(saddr, 1024); }
constexpr uint64_t kDescKStep = 32 >> 4;     // K-major: 16 columns
constexpr uint64_t kDescMNStep = 2048 >> 4;  // MN-major: 16 rows

// wgmma's ordering: wgmma_fence before a chain of products whose registers
// other instructions wrote, wgmma_commit to close the chain into a group,
// wgmma_wait<N> until at most N groups are in flight. A divergent branch near
// them makes ptxas serialize every wgmma of the function (warning C7520), so
// the code around them is kept free of branches.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulators at this point of the program: the compiler may not
// move their reads or writes across it (so none crosses a wgmma_wait).
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[t][e])::"memory");
}

// The same for A operands in registers: they stay live, and unchanged, until
// the wgmma_wait that covers the products reading them.
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[kk][e])::"memory");
}

#define FLASH_WGMMA_D                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_WGMMA_ROW(d, t) "+f"(d[t][0]), "+f"(d[t][1]), "+f"(d[t][2]), "+f"(d[t][3])
#define FLASH_WGMMA_OUT(d)                                                            \
  FLASH_WGMMA_ROW(d, 0), FLASH_WGMMA_ROW(d, 1), FLASH_WGMMA_ROW(d, 2),                \
      FLASH_WGMMA_ROW(d, 3), FLASH_WGMMA_ROW(d, 4), FLASH_WGMMA_ROW(d, 5),            \
      FLASH_WGMMA_ROW(d, 6), FLASH_WGMMA_ROW(d, 7)

// d += A·B over one 16-deep step, A (64 × 16) and B (16 × 64) both K-major
// in swizzled shared memory (descriptors a, b).
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WGMMA_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_WGMMA_OUT(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A·B over one 16-deep step, A the m16n8k16 fragments of this warp's 16
// rows in registers, B (16 × 64) MN-major in swizzled shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WGMMA_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_WGMMA_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- Hopper: TMA, mbarriers, warp specialisation ----------------------------
//
// A tile of a (B, H, N, Dh) bf16 operand is one TMA box of a 4-d tensor map
// {Dh, N, H, B} (encode_tile_map): 64 rows × 64 columns into the 128-byte
// swizzled layout above, rows >= N filled with zeros by the copy engine. The
// copy reports its bytes to an mbarrier; consumers wait on the barrier's
// phase parity (round r of a barrier completes phase r, parity r & 1).

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes initialised barriers visible to the async proxy (the copy engine).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  // labels are local to the braces' scope, so the asm may be inlined often
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// mbarrier wait that traps after 4 s: a copy that never lands faults the
// launch instead of hanging the card. The clock is read only once the first
// try has failed.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\nsub.u64 t1, t1, t0;\nsetp.lt.u64 p, t1, 4000000000;\n"
      "@p bra LAB_WAIT;\ntrap;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The 64 × 64 box at rows row0.. of head (b, h) into shared address dst.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const void* map, int row0, int h, int b,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(map), "r"(0), "r"(row0), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// Register budgets of a producer and a consumer warpgroup (all four warps
// execute it).
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// A barrier of `threads` threads (a multiple of 32) on hardware barrier id.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A 4-d TMA map {Dh, N, H, B} over a (B, H, N, 64) bf16 operand with unit
// stride along Dh (16-byte aligned, strides of 8 elements: the wrapper
// checks): 64 × 64 boxes into the 128-byte swizzled layout, rows past N read
// as zeros. cuTensorMapEncodeTiled is looked up through the runtime
// (cudaGetDriverEntryPoint, tiled_map_encoder), so the library links no
// libcuda. Host code.
inline cudaError_t tiled_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

inline cudaError_t encode_tile_map(CUtensorMap* map, const void* base, int batch, int heads,
                                   int n, const Strides& s) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const cudaError_t err = tiled_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {64, cuuint64_t(n), cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(s.n) * 2, cuuint64_t(s.h) * 2, cuuint64_t(s.b) * 2};
  const cuuint32_t box[4] = {64, kTile, 1, 1}, elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

}  // namespace flash
