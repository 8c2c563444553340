// K3: flash-attention forward, non-causal softmax(Q·Kᵀ·scale)·V.
//
// Replaces the TPU kernel that deephisto_tpu/models/vit.py:_attention calls
// at N >= FLASH_MIN_SEQ: jax.experimental.pallas.ops.tpu.flash_attention
// (body _flash_attention_kernel_single_batch). Its precision contract is kept:
// Q·Kᵀ accumulates in f32 and is scaled in f32, the online softmax (running
// max and sum) is f32, P is cast to V's dtype before P·V, P·V accumulates in
// f32, and the output is cast to Q's dtype. The TPU path pads N to a multiple
// of 512 and masks the pad tokens with segment ids; here the ragged edge is
// masked in the kernel (key columns >= N score -inf, their V rows load as
// zeros, query rows >= N are not stored), so no padding is needed.
//
// Bound: operations. A call does 4·B·H·N²·Dh tensor-core FLOPs (Q·Kᵀ and P·V)
// and must move Q, K, V and O once: at the ViT-S/8 predict shape
// (256, 6, 784, 64) bf16 that is 241.7 GFLOP, 0.244 ms at 989 TFLOP/s, against
// 616 MB, 0.184 ms at 3.35 TB/s.
//
// The wrapper (ops/attention.py:attention_design, the one place it is
// chosen, for K3, K4 and K5 alike) picks the design by (dtype, Dh) and passes
// it in; a design with no kernel for the (dtype, Dh) it is given is refused,
// never replaced:
//
// - wgmma (bf16 at Dh 64, the ViT-S and ViT-B head width; flash_fwd_tma):
//   a block of two warpgroups per (batch·head, 64-query tile), three blocks
//   an SM. The consumer warpgroup (threads 0-127) owns the tile and runs
//   wgmma.m64n64k16 with f32 accumulators; the producer warpgroup gives up
//   its registers (setmaxnreg: 24 each, the consumer 136) and one of its
//   threads issues every TMA copy: the Q tile once, then each K and V tile
//   into a ring of kStages stages, with full and empty mbarriers between the
//   two warpgroups (no __syncthreads in the loop). TMA writes each 64 × 64
//   tile once, in the 128-byte swizzled layout (flash_common.cuh), zero past
//   N, from the strided q/k/v views through 4-d maps {Dh, N, H, B}. S = Q·Kᵀ
//   reads Q and K K-major from shared memory (SS); the softmax runs on S's
//   accumulators, which are the mma.sync m16n8 layout, so P is packed to
//   bf16 A fragments in registers; O += P·V reads V MN-major from its tile
//   (RS, the transpose bit: no transposed copy). Tile j + 1's S and tile j's
//   P·V are issued together, and tile j + 1's exponentials run while P·V is
//   on the tensor cores (a second set of P fragments; the rescale of O by
//   the new row max waits for P·V). The ragged edge is masked by selects,
//   not a branch: a branch beside the wgmma chain makes ptxas serialize
//   every wgmma (C7520). More warpgroups an SM matter more than sharing the
//   K/V stream: two consumer warpgroups on 128-query tiles, or one at two
//   blocks an SM, were slower on the H100 (PERF.md).
// - mma.sync (bf16 at Dh 16, 32, 128; flash_fwd_bf16, FlashAttention-2
//   style): one block of 4 warps per 64-query tile, each warp 16 query rows
//   whose Q fragments stay in registers; K/V tiles staged by cp.async two
//   deep in shared memory rows padded by 16 bytes (ldmatrix without bank
//   conflicts), ldmatrix feeding K as is and V transposed, S's accumulators
//   packed into P's A fragments.
//
// In both, the scale (> 0) is folded into the row max and, by one FMA, into
// each exponent.
//
// The f32 path is plain SIMT FMA in full f32 (one thread per query row, K/V
// tiles broadcast from shared memory), so float32 models run on the card too;
// it is for correctness, not speed.
//
// Under autograd the wrapper passes an f32 (B, H, N) buffer for each row's
// log-sum-exp of the scaled scores, lse = m + ln(l) of the online softmax:
// the residual from which K4 and K5 (attention_bwd.cu) recompute P. For
// inference it passes null and the kernel writes nothing more.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// One step of the online softmax over a 64-key tile, for this thread's rows
// g and g+8 of its warp's 16 (s: the warp's 16 × 64 scores in the m16n8
// accumulator layout; m_run in log2 units of the scaled scores, l_run this
// thread's partial row sums). Keys >= n score -inf by a select, not a branch
// (a branch beside wgmma serializes it). The scale (> 0) multiplies the row
// max and, in one FMA, each score, so 2^(s·scale·log2e - max) is
// exp(s·scale - max·scale). Leaves P as bf16 A fragments of 4 16-deep steps
// in pf and the factor by which the output rows must be rescaled in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m_run)[2],
                                             float (&l_run)[2], uint32_t (&pf)[4][4],
                                             float (&alpha)[2], int key0, int n, int c,
                                             float scale_log2) {
  const int lim = n - key0 - 2 * c;  // column t·8 + e of this thread is a key iff < lim
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = t * 8 + (e & 1) < lim ? s[t][e] : -CUDART_INF_F;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_run[r], mx[r] * scale_log2);
  }
  // every tile holds a key < n, so mx is finite and 2^(-inf) = 0
  alpha[0] = fast_exp2(m_run[0] - mx[0]);
  alpha[1] = fast_exp2(m_run[1] - mx[1]);
  m_run[0] = mx[0];
  m_run[1] = mx[1];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float p0 = fast_exp2(fmaf(s[t][0], scale_log2, -mx[0]));
    const float p1 = fast_exp2(fmaf(s[t][1], scale_log2, -mx[0]));
    const float p2 = fast_exp2(fmaf(s[t][2], scale_log2, -mx[1]));
    const float p3 = fast_exp2(fmaf(s[t][3], scale_log2, -mx[1]));
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    pf[t / 2][(t % 2) * 2 + 0] = pack_bf16(p0, p1);
    pf[t / 2][(t % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// The output rows g and g+8 times the change of their row max.
template <int DT>
__device__ __forceinline__ void rescale(float (&acc)[DT][4], const float (&alpha)[2]) {
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }
}

// The end of a 64-query tile: each row's sum over its quad, the lse (the
// row's log-sum-exp of the scaled scores, for the backward; rows >= n not
// written), and the normalised bf16 output rows (rows >= n not stored).
template <int DT, bool LSE>
__device__ __forceinline__ void finish_rows(const float (&acc)[DT][4], const float (&m_run)[2],
                                            const float (&l_run)[2], bf16* o, int64_t so_n,
                                            float* lse, int row0, int n, int lane) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    const int row = row0 + lane / 4 + 8 * r;
    if (LSE && lane % 4 == 0 && row < n) lse[row] = (m_run[r] + log2f(l)) * CUDART_LN2_F;
  }
  store_rows_bf16<DT * 8>(o, so_n, row0, n, acc, lane, inv[0], inv[1]);
}

// ---- wgmma: bf16 at Dh 64 ----------------------------------------------------

// S = Q·Kᵀ for one key tile (cK: the shared address of its swizzled K tile),
// both operands K-major in shared memory (SS), committed as one group.
__device__ __forceinline__ void issue_s(float (&s)[8][4], uint64_t descQ, uint32_t cK) {
  const uint64_t kK = sw128_desc_k(cK);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, descQ + kk * kDescKStep, kK + kk * kDescKStep);
  wgmma_commit();
}

// O += P·V for one key tile (cV: its swizzled V tile), P in registers and V
// read MN-major (RS), committed as one group.
__device__ __forceinline__ void issue_pv(float (&acc)[8][4], const uint32_t (&pf)[4][4],
                                         uint32_t cV) {
  const uint64_t mV = sw128_desc_mn(cV);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(acc, pf[kk], mV + kk * kDescMNStep);
  wgmma_commit();
}

// The TMA kernel: a consumer warpgroup (threads 0-127) owning the block's
// 64 query rows and a producer warpgroup that gives up its registers
// (setmaxnreg) and whose first thread issues every TMA copy: the Q tile once,
// then each K and V tile into a ring of kStages stages, full and empty
// mbarriers between the two (no __syncthreads in the loop).

constexpr int kStages = 3;  // tile j + 1 must have landed when tile j's P·V is issued
constexpr int kProducerRegs = 24;
constexpr int kMinBlocks = 3;
// registers a thread: three 256-thread blocks an SM enter with 80 each
// (65,536 / 768, rounded down to a multiple of 8); the producer's 56 spare
// ones go to the consumer
constexpr int kConsumerRegs = 136;
constexpr int kFwdThreads = 2 * kWgThreads;

struct FwdMaps {  // 4-d TMA maps {Dh, N, H, B} of Q, K and V
  CUtensorMap q, k, v;
};

constexpr size_t kFwdTilesBytes = (1 + 2 * kStages) * kSwTileBytes;
constexpr size_t kFwdSmemBytes = 1024 + kFwdTilesBytes + 8 * (1 + 2 * kStages);

template <bool LSE>
__global__ void __launch_bounds__(kFwdThreads, kMinBlocks) flash_fwd_tma(
    const __grid_constant__ FwdMaps maps, bf16* __restrict__ o, float* __restrict__ lse,
    int heads, int n, Strides so, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sQ = align1024(smem_addr(smem));
  const uint32_t sK = sQ + kSwTileBytes;              // kStages tiles
  const uint32_t sV = sK + kStages * kSwTileBytes;    // kStages tiles
  const uint32_t q_bar = sQ + kFwdTilesBytes, full_bar = q_bar + 8,
                 empty_bar = full_bar + 8 * kStages;

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kWgThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWgThreads) {  // one thread issues every copy
      mbar_arrive_expect_tx(q_bar, kSwTileBytes);
      tma_load_tile(sQ, &maps.q, qt * kTile, h, b, q_bar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar + 8 * s, (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(full_bar + 8 * s, 2 * kSwTileBytes);
        tma_load_tile(sK + s * kSwTileBytes, &maps.k, j * kTile, h, b, full_bar + 8 * s);
        tma_load_tile(sV + s * kSwTileBytes, &maps.v, j * kTile, h, b, full_bar + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
    float acc[8][4];
    zero(acc);
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    const uint64_t descQ = sw128_desc_k(sQ);
    // tile 0: S_0 and its softmax (acc is 0, nothing to rescale)
    float s[8][4];
    uint32_t pf[4][4];
    float alpha[2];
    zero(s);
    mbar_wait(q_bar, 0);
    mbar_wait(full_bar, 0);
    wgmma_fence();
    issue_s(s, descQ, sK);
    wgmma_wait<0>();
    fence_acc(s);
    softmax_tile(s, m_run, l_run, pf, alpha, 0, n, c, scale_log2);
    // tile j + 1's S and tile j's P·V in flight together; tile j + 1's
    // exponentials run while P·V is on the tensor cores
    for (int j = 0; j + 1 < n_tiles; ++j) {
      const int st = j % kStages, sn = (j + 1) % kStages;
      mbar_wait(full_bar + 8 * sn, ((j + 1) / kStages) & 1);
      zero(s);
      wgmma_fence();
      issue_s(s, descQ, sK + sn * kSwTileBytes);
      issue_pv(acc, pf, sV + st * kSwTileBytes);
      wgmma_wait<1>();  // S done, P·V may still run
      fence_acc(s);
      uint32_t pn[4][4];
      softmax_tile(s, m_run, l_run, pn, alpha, (j + 1) * kTile, n, c, scale_log2);
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(pf);
      mbar_arrive(empty_bar + 8 * st);  // tile j's K and V are read
      rescale(acc, alpha);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pf[kk][e] = pn[kk][e];
    }
    wgmma_fence();
    issue_pv(acc, pf, sV + (n_tiles - 1) % kStages * kSwTileBytes);
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pf);
    finish_rows<8, LSE>(acc, m_run, l_run, o + b * so.b + h * so.h, so.n, lse + int64_t(bh) * n,
                        qt * kTile + warp * 16, n, lane);
  }
}

// ---- mma.sync: bf16 at Dh 16, 32, 128 ---------------------------------------

template <int DH, bool LSE>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides so, float scale_log2) {
  constexpr int LD = DH + 8;  // padded row, elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * LD;      // two buffers
  bf16* sV = sK + 2 * kTile * LD;  // two buffers

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % 4;  // mma fragment column pair

  load_tile<DH, LD>(sQ, q, sq.n, qt * kTile, n);
  load_tile<DH, LD>(sK, k, sk.n, 0, n);
  load_tile<DH, LD>(sV, v, sv.n, 0, n);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g+8, log2 units
  float l_run[2] = {0.f, 0.f};                      // this thread's partial row sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile<DH, LD>(sK + nb * kTile * LD, k, sk.n, (j + 1) * kTile, n);
      load_tile<DH, LD>(sV + nb * kTile * LD, v, sv.n, (j + 1) * kTile, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) load_a_frags<DH, LD>(qf, sQ, warp, lane);
    const bf16* cK = sK + (j & 1) * kTile * LD;
    const bf16* cV = sV + (j & 1) * kTile * LD;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 64 keys: 8 n-tiles of 8
    float s[8][4];
    zero(s);
    mma_abt<DH, LD>(s, qf, cK, lane);
    uint32_t pf[4][4];
    float alpha[2];
    softmax_tile(s, m_run, l_run, pf, alpha, j * kTile, n, c, scale_log2);
    rescale(acc, alpha);
    mma_pb<DH, LD>(acc, pf, cV, lane);  // O += P·V
    __syncthreads();  // the next iteration's loads overwrite this tile's buffers
  }
  finish_rows<DH / 8, LSE>(acc, m_run, l_run, o, so.n, lse + int64_t(bh) * n,
                           qt * kTile + warp * 16, n, lane);
}

// f32: one thread per query row; Q rows in shared memory padded to DH + 1
// floats (conflict-free per-thread reads), K/V tiles read as broadcasts.
constexpr int kChunk = 16;  // keys per online-softmax step

template <int DH, bool LSE>
__global__ void __launch_bounds__(kTile) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides so, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // kTile x (DH + 1)
  float* sK = sQ + kTile * (DH + 1);            // kTile x DH
  float* sV = sK + kTile * DH;                  // kTile x DH

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  o += b * so.b + h * so.h;
  const int t = threadIdx.x;
  const int q0 = qt * kTile;

  for (int i = t; i < kTile * DH; i += kTile) {
    const int r = i / DH, d = i % DH;
    sQ[r * (DH + 1) + d] = q0 + r < n ? q[int64_t(q0 + r) * sq.n + d] : 0.f;
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;
  const float* qrow = sQ + t * (DH + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kTile;
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int i = t; i < kTile * DH; i += kTile) {
      const int r = i / DH, d = i % DH;
      const bool in = key0 + r < n;
      sK[i] = in ? k[int64_t(key0 + r) * sk.n + d] : 0.f;
      sV[i] = in ? v[int64_t(key0 + r) * sv.n + d] : 0.f;
    }
    __syncthreads();
    const int keys = min(kTile, n - key0);
    for (int c0 = 0; c0 < keys; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e) s[e] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float qd = qrow[d];
#pragma unroll
        for (int e = 0; e < kChunk; ++e) s[e] = fmaf(qd, sK[(c0 + e) * DH + d], s[e]);
      }
      float mx = m_run;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        s[e] = c0 + e < keys ? s[e] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[e]);
      }
      const float alpha = fast_exp2(m_run - mx);
      m_run = mx;
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const float p = fast_exp2(s[e] - mx);
        l_run += p;
        const float* vr = sV + (c0 + e) * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
  }
  if (q0 + t < n) {
    const float inv = 1.f / l_run;
    float* dst = o + int64_t(q0 + t) * so.n;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = acc[d] * inv;
    if (LSE) lse[int64_t(bh) * n + q0 + t] = (m_run + log2f(l_run)) * CUDART_LN2_F;
  }
}

// ---- launch ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;  // null without the residual
  int batch, heads, n;
  Strides s[4];  // q, k, v, o
  float scale_log2;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// One launch in `design` at head width DH, with the lse residual if LSE.
template <int DH, bool LSE>
cudaError_t launch_one(Design design, cudaStream_t st, const Args& a) {
  cudaError_t err;
  const int64_t blocks64 = int64_t(a.batch) * a.heads * ((a.n + kTile - 1) / kTile);
  if (blocks64 > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = int(blocks64);
  const auto q = static_cast<const bf16*>(a.q), k = static_cast<const bf16*>(a.k),
             v = static_cast<const bf16*>(a.v);
  const auto o = static_cast<bf16*>(a.o);
  if (design == kWgmma) {
    if constexpr (DH == 64) {
      FwdMaps maps;
      if ((err = encode_tile_map(&maps.q, a.q, a.batch, a.heads, a.n, a.s[0])) != cudaSuccess ||
          (err = encode_tile_map(&maps.k, a.k, a.batch, a.heads, a.n, a.s[1])) != cudaSuccess ||
          (err = encode_tile_map(&maps.v, a.v, a.batch, a.heads, a.n, a.s[2])) != cudaSuccess)
        return err;
      if ((err = set_smem(flash_fwd_tma<LSE>, kFwdSmemBytes)) != cudaSuccess) return err;
      flash_fwd_tma<LSE><<<blocks, kFwdThreads, kFwdSmemBytes, st>>>(
          maps, o, a.lse, a.heads, a.n, a.s[3], a.scale_log2);
    } else {
      return cudaErrorInvalidValue;  // wgmma is written for Dh 64 only
    }
  } else if (design == kMmaSync) {
    if constexpr (DH == 64) {
      return cudaErrorInvalidValue;  // Dh 64 runs on wgmma
    } else {
      const size_t smem = size_t(5) * kTile * (DH + 8) * sizeof(bf16);
      if ((err = set_smem(flash_fwd_bf16<DH, LSE>, smem)) != cudaSuccess) return err;
      flash_fwd_bf16<DH, LSE><<<blocks, kWarps * 32, smem, st>>>(
          q, k, v, o, a.lse, a.heads, a.n, a.s[0], a.s[1], a.s[2], a.s[3], a.scale_log2);
    }
  } else {
    const size_t smem = size_t(kTile) * (3 * DH + 1) * sizeof(float);
    if ((err = set_smem(flash_fwd_f32<DH, LSE>, smem)) != cudaSuccess) return err;
    flash_fwd_f32<DH, LSE><<<blocks, kTile, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.heads, a.n, a.s[0],
        a.s[1], a.s[2], a.s[3], a.scale_log2);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(Design design, cudaStream_t st, const Args& a) {
  return a.lse ? launch_one<DH, true>(design, st, a) : launch_one<DH, false>(design, st, a);
}

}  // namespace

// q, k, v, o: (batch, heads, n, dh) with unit stride along dh and element
// strides `strides` = {b, h, n} for q, k, v and o in turn (12 values); bf16
// rows 16-byte aligned (the wrapper checks). lse: null, or a contiguous f32
// (batch, heads, n) that receives each row's log-sum-exp of the scaled
// scores (the residual of the backward). elem_bytes: 2 (bf16) or 4 (f32).
// dh: 16, 32, 64 or 128. design: 0 SIMT (f32), 1 mma.sync (bf16, Dh 16, 32,
// 128), 2 wgmma (bf16, Dh 64), as ops/attention.py:attention_design chooses
// it; any other is refused. scale > 0 (the bf16 paths scale the row max).
extern "C" int dh_flash_attention(int device, const void* q, const void* k, const void* v,
                                  void* o, void* lse, int batch, int heads, int n, int dh,
                                  int elem_bytes, int design, const int64_t* strides,
                                  float scale, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaGetLastError();
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  if (design != kSimt && design != kMmaSync && design != kWgmma) return cudaErrorInvalidValue;
  if ((design == kSimt) != (elem_bytes == 4)) return cudaErrorInvalidValue;  // SIMT takes f32
  Args a{q, k, v, o, static_cast<float*>(lse), batch, heads, n, {}, scale * kLog2e};
  for (int i = 0; i < 4; ++i) a.s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Design chosen = static_cast<Design>(design);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(chosen, st, a);
    case 32: return launch<32>(chosen, st, a);
    case 64: return launch<64>(chosen, st, a);
    case 128: return launch<128>(chosen, st, a);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
