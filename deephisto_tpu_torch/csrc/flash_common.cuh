// Device helpers shared by the flash-attention kernels (K3 in attention.cu,
// K4 and K5 in attention_bwd.cu): cp.async tile loads, ldmatrix, the
// m16n8k16 bf16 mma.sync with f32 accumulators, ex2.approx, bf16 packing,
// operand strides and the device guard of the C entry points.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4·g + c): an accumulator
// d[0..3] holds rows g, g, g+8, g+8 and columns 2c, 2c+1, 2c, 2c+1 of its
// 16×8 tile; an A fragment a[0..3] holds rows g, g+8, g, g+8 and column
// pairs 2c.., 2c.., 8+2c.., 8+2c.. of its 16×16 tile. So the accumulators of
// two neighbouring 8-column tiles, packed to bf16 pairwise, are the A
// fragment of one 16-deep step: that is how P and dS go from one product to
// the next without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;   // rows per block tile and per streamed tile
constexpr int kWarps = 4;   // bf16 paths: 16 rows of the block tile per warp
constexpr float kLog2e = 1.4426950408889634f;

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
