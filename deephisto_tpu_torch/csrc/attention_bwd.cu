// K4 and K5: flash-attention backward, the gradients of non-causal
// O = softmax(Q·Kᵀ·scale)·V.
//
// Replace the two TPU kernels that jax.experimental.pallas.ops.tpu.
// flash_attention runs when deephisto_tpu/models/vit.py:_attention is
// differentiated at N >= FLASH_MIN_SEQ: K4 the dK/dV kernel
// (_flash_attention_bwd_dkv, body _flash_attention_dkv_kernel), K5 the dQ
// kernel (_flash_attention_bwd_dq, body _flash_attention_dq_kernel). The work
// is split as there, with no float atomics: K4 owns a 64-key tile and walks
// the queries, K5 owns a 64-query tile and walks the keys, so every gradient
// is summed by one block in a fixed order and is the same from run to run.
//
// K5 runs first. Inputs: Q, K, V, dO, O (B, H, N, Dh) with unit stride along
// Dh and lse (B, H, N) f32 from K3 (each row's log-sum-exp of the scaled
// scores). K5 also computes di = Σ_d O∘dO in f32 for the rows of its query
// tile (the TPU path computes it in XLA) and writes it to a (B, H, N64) f32
// buffer padded to a multiple of 64 rows, di = 0 past N; K4 reads it there.
// The TPU kernels' precision contract is kept: S = Q·Kᵀ accumulates in f32
// and is scaled in f32, P = exp(S - lse) in f32, P is cast to dO's dtype
// before Pᵀ·dO, dP = dO·Vᵀ accumulates in f32, dS = (dP - di)∘P·scale in f32
// is cast to the inputs' dtype before dSᵀ·Q and dS·K, every product
// accumulates in f32, and dQ, dK, dV are written in the inputs' dtype. The
// TPU path pads N to a multiple of 512 and masks the pad tokens with segment
// ids; here the ragged edge is masked in the kernels: queries >= N load as
// zero rows with lse = +inf (so P = 0) and di = 0, keys >= N have P = 0 in
// K5, and no row >= N is written.
//
// Bound: operations. The backward does 5 products of 2·B·H·N²·Dh FLOPs
// (S, dP, dV, dK, dQ; these kernels recompute S and dP in both, 7 in all):
// at the ViT-S/8 training shape (256, 6, 784, 64) bf16, 604 GFLOP, 0.611 ms at
// 989 TFLOP/s, against ~1.2 GB of Q, K, V, O, dO, dQ, dK, dV, lse and di
// moved once, 0.36 ms at 3.35 TB/s.
//
// The wrapper (ops/attention.py:attention_design, the one place it is chosen)
// picks the design by (dtype, Dh) and passes it in; a design with no kernel
// for the (dtype, Dh) it is given is refused, never replaced:
//
// - wgmma (bf16 at Dh 64, the ViT-S and ViT-B head width): a block of two
//   warpgroups per 64-row tile. The consumer warpgroup (threads 0-127) owns
//   the tile and runs wgmma.m64n64k16; the producer warpgroup gives up its
//   registers (setmaxnreg: 24 each, the consumer 232) and one of its threads
//   issues every TMA copy: the block's two resident tiles once, then each
//   streamed tile pair into a ring of kStages stages, with full and empty
//   mbarriers between the two warpgroups (no __syncthreads in the loop). TMA
//   writes each 64 × 64 tile once, in the 128-byte swizzled layout
//   (flash_common.cuh), zero past N, and wgmma reads it there both as a
//   K-major and as an MN-major operand: no tile is copied or transposed a
//   second time. K4 keeps its K and V tiles and streams Q and dO (the
//   producer warp writes their lse and di rows beside them); per streamed
//   tile it computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both operands in shared
//   memory (SS), rounds Pᵀ and dSᵀ to bf16 in registers, where the
//   accumulators are already the A operands of dV += Pᵀ·dO and dK += dSᵀ·Q,
//   and reads dO and Q for those (RS) as MN-major B operands. K5 keeps its Q
//   and dO tiles (and sums di from O and dO first) and streams K and V:
//   S = Q·Kᵀ and dP = dO·Vᵀ (SS), then dQ += dS·K (RS, K MN-major).
// - mma.sync (bf16 at Dh 16, 32, 128), K3's shape: one block of 4 warps per
//   64-row tile, each warp 16 rows whose operands stay in registers as
//   mma.sync m16n8k16 A fragments; the streamed tiles in padded shared
//   memory by cp.async two deep; ldmatrix.trans feeds the transposed B
//   operands.
// - SIMT (f32, every Dh): plain FMA in full f32 (one thread per key row in
//   K4, per query row in K5, the streamed tiles broadcast from shared
//   memory), so float32 models train on the card too; for correctness, not
//   speed.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

// The lse (in log2 units) and di of query rows row0.. of one head into
// shared memory: rows >= n get lse = +inf and di = 0, so P = dS = 0 there.
__device__ __forceinline__ void load_row_stats(float* sl, float* sd, const float* lse,
                                               const float* di, int row0, int n, int threads) {
  for (int i = threadIdx.x; i < 2 * kTile; i += threads) {
    const int r = i % kTile, row = row0 + r;
    if (i < kTile)
      sl[r] = row < n ? lse[row] * kLog2e : CUDART_INF_F;
    else
      sd[r] = row < n ? di[row] : 0.f;
  }
}

// Pᵀ = exp(Sᵀ·scale - lse) and dSᵀ = (dPᵀ - di)∘Pᵀ·scale in place, per query
// column of this thread's accumulators (K4).
__device__ __forceinline__ void dkv_scores(float (&st)[8][4], float (&dpt)[8][4], const float* cL,
                                           const float* cD, int c, float scale, float scale_log2) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = t * 8 + 2 * c + (e & 1);
      const float p = fast_exp2(fmaf(st[t][e], scale_log2, -cL[col]));
      st[t][e] = p;
      dpt[t][e] = (dpt[t][e] - cD[col]) * p * scale;
    }
  }
}

// dS = (dP - di)∘P·scale in place with P = exp(S·scale - lse) for this
// thread's rows g and g+8; keys >= n have P = 0 (K5).
__device__ __forceinline__ void dq_scores(const float (&s)[8][4], float (&dp)[8][4],
                                          const float (&lse2)[2], const float (&dsub)[2], int key0,
                                          int n, int c, float scale, float scale_log2) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float p = key0 + t * 8 + 2 * c + (e & 1) < n
                          ? fast_exp2(fmaf(s[t][e], scale_log2, -lse2[r]))
                          : 0.f;
      dp[t][e] = (dp[t][e] - dsub[r]) * p * scale;
    }
  }
}

// ---- wgmma: bf16 at Dh 64 ---------------------------------------------------

// One streamed query tile of the wgmma K4 (cQ, cO: its Q and dO tiles; cL,
// cD: their lse and di): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ from shared memory (SS),
// Pᵀ and dSᵀ rounded to bf16 in registers, then dV += Pᵀ·dO and
// dK += dSᵀ·Q (RS) with dO and Q read MN-major from the same tiles. Returns
// when the tensor cores have read the tiles.
__device__ __forceinline__ void dkv_tile_wgmma(float (&dk_acc)[8][4], float (&dv_acc)[8][4],
                                               uint64_t descK, uint64_t descV, uint32_t cQ,
                                               uint32_t cO, const float* cL, const float* cD,
                                               int c, float scale, float scale_log2) {
  float st[8][4], dpt[8][4];
  zero(st);
  zero(dpt);
  const uint64_t kQ = sw128_desc_k(cQ), kO = sw128_desc_k(cO);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(st, descK + kk * kDescKStep, kQ + kk * kDescKStep);
    wgmma_ss(dpt, descV + kk * kDescKStep, kO + kk * kDescKStep);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(st);
  fence_acc(dpt);

  dkv_scores(st, dpt, cL, cD, c, scale, scale_log2);
  uint32_t pf[4][4], sf[4][4];
  pack_a_frags(pf, st);
  pack_a_frags(sf, dpt);

  const uint64_t mQ = sw128_desc_mn(cQ), mO = sw128_desc_mn(cO);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_mn(dv_acc, pf[kk], mO + kk * kDescMNStep);
    wgmma_rs_mn(dk_acc, sf[kk], mQ + kk * kDescMNStep);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dv_acc);
  fence_acc(dk_acc);
  fence_frag(pf);
  fence_frag(sf);
}

// One streamed key tile (cK, cV, keys key0..) of the wgmma K5: S = Q·Kᵀ and
// dP = dO·Vᵀ (SS), dS in registers, then dQ += dS·K (RS, K read MN-major
// from the same tile). Returns when the tensor cores have read the tiles.
__device__ __forceinline__ void dq_tile_wgmma(float (&acc)[8][4], uint64_t descQ, uint64_t descO,
                                              uint32_t cK, uint32_t cV, const float (&lse2)[2],
                                              const float (&dsub)[2], int key0, int n, int c,
                                              float scale, float scale_log2) {
  float s[8][4], dp[8][4];
  zero(s);
  zero(dp);
  const uint64_t kK = sw128_desc_k(cK), kV = sw128_desc_k(cV);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(s, descQ + kk * kDescKStep, kK + kk * kDescKStep);
    wgmma_ss(dp, descO + kk * kDescKStep, kV + kk * kDescKStep);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);

  dq_scores(s, dp, lse2, dsub, key0, n, c, scale, scale_log2);
  uint32_t af[4][4];
  pack_a_frags(af, dp);

  const uint64_t mK = sw128_desc_mn(cK);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(acc, af[kk], mK + kk * kDescMNStep);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(af);
}

// The kernels: every tile copied by TMA (one thread of the producer
// warpgroup, which setmaxnreg leaves kProducerRegs registers) into a ring of
// kStages streamed tiles, full and empty mbarriers between it and the
// consumer warpgroup (threads 0-127, kConsumerRegs registers). In K4 the
// producer's first warp also writes each streamed tile's lse and di rows.

constexpr int kStages = 2;
constexpr int kConsumerRegs = 232;  // 2 blocks of 256 threads an SM: 2 · (232 + 24) · 128
constexpr int kTmaThreads = 2 * kWgThreads;  // consumer warpgroup, producer warpgroup
constexpr int kProducerRegs = 24;

struct TileMaps {  // 4-d TMA maps {Dh, N, H, B} of the four bf16 operands
  CUtensorMap q, k, v, dout;
};

// Shared memory of the TMA kernels past the 1024-aligned tiles: the
// barriers (resident tiles, then full and empty per stage), then floats.
constexpr size_t kTmaTilesBytes = (2 + 2 * kStages) * kSwTileBytes;
constexpr size_t kTmaBarBytes = 8 * (1 + 2 * kStages);

__global__ void __launch_bounds__(kTmaThreads, 2) flash_bwd_dkv_tma(
    const __grid_constant__ TileMaps maps, const float* __restrict__ lse,
    const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n,
    Strides sdk, Strides sdv, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_addr(smem), base = align1024(raw);
  const uint32_t sK = base, sV = sK + kSwTileBytes;
  const uint32_t sQ = sV + kSwTileBytes, sO = sQ + kStages * kSwTileBytes;  // kStages each
  const uint32_t res_bar = base + kTmaTilesBytes, full_bar = res_bar + 8,
                 empty_bar = full_bar + 8 * kStages;
  float* sL = reinterpret_cast<float*>(smem + (res_bar - raw) + kTmaBarBytes);  // kStages
  float* sD = sL + kStages * kTile;                                              // kStages

  const int n_tiles = (n + kTile - 1) / kTile;
  const int kt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);  // the producer warp's lanes, one with the bytes
      mbar_init(empty_bar + 8 * s, kWgThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kWgThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kWgThreads / 32) {  // the producer warp
      const int lane = threadIdx.x % 32;
      lse += int64_t(bh) * n;
      di += int64_t(bh) * n_tiles * kTile;
      if (lane == 0) {
        mbar_arrive_expect_tx(res_bar, 2 * kSwTileBytes);
        tma_load_tile(sK, &maps.k, kt * kTile, h, b, res_bar);
        tma_load_tile(sV, &maps.v, kt * kTile, h, b, res_bar);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty_bar + 8 * s, (j / kStages - 1) & 1);
#pragma unroll
        for (int r = lane; r < kTile; r += 32) {  // rows >= n: lse = +inf, di = 0
          const int row = j * kTile + r;
          sL[s * kTile + r] = row < n ? lse[row] * kLog2e : CUDART_INF_F;
          sD[s * kTile + r] = row < n ? di[row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full_bar + 8 * s, 2 * kSwTileBytes);
          tma_load_tile(sQ + s * kSwTileBytes, &maps.q, j * kTile, h, b, full_bar + 8 * s);
          tma_load_tile(sO + s * kSwTileBytes, &maps.dout, j * kTile, h, b, full_bar + 8 * s);
        } else {
          mbar_arrive(full_bar + 8 * s);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = lane % 4;
    float dk_acc[8][4], dv_acc[8][4];
    zero(dk_acc);
    zero(dv_acc);
    const uint64_t descK = sw128_desc_k(sK), descV = sw128_desc_k(sV);
    mbar_wait(res_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full_bar + 8 * s, (j / kStages) & 1);
      dkv_tile_wgmma(dk_acc, dv_acc, descK, descV, sQ + s * kSwTileBytes, sO + s * kSwTileBytes,
                     sL + s * kTile, sD + s * kTile, c, scale, scale_log2);
      mbar_arrive(empty_bar + 8 * s);
    }
    dk += b * sdk.b + h * sdk.h;
    dv += b * sdv.b + h * sdv.h;
    store_rows_bf16<64>(dk, sdk.n, kt * kTile + warp * 16, n, dk_acc, lane);
    store_rows_bf16<64>(dv, sdv.n, kt * kTile + warp * 16, n, dv_acc, lane);
  }
}

__global__ void __launch_bounds__(kTmaThreads, 2) flash_bwd_dq_tma(
    const __grid_constant__ TileMaps maps, const bf16* __restrict__ dout,
    const bf16* __restrict__ o, const float* __restrict__ lse, float* __restrict__ di,
    bf16* __restrict__ dq, int heads, int n, Strides sdo, Strides sdq, Strides so, float scale,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_addr(smem), base = align1024(raw);
  const uint32_t sQ = base, sO = sQ + kSwTileBytes;  // sO: dO
  const uint32_t sK = sO + kSwTileBytes, sV = sK + kStages * kSwTileBytes;  // kStages each
  const uint32_t res_bar = base + kTmaTilesBytes, full_bar = res_bar + 8,
                 empty_bar = full_bar + 8 * kStages;
  float* sD = reinterpret_cast<float*>(smem + (res_bar - raw) + kTmaBarBytes);

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
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
      mbar_arrive_expect_tx(res_bar, 2 * kSwTileBytes);
      tma_load_tile(sQ, &maps.q, qt * kTile, h, b, res_bar);
      tma_load_tile(sO, &maps.dout, qt * kTile, h, b, res_bar);
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
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    dout += b * sdo.b + h * sdo.h;
    o += b * so.b + h * so.h;
    row_di<64>(sD, di + int64_t(bh) * n_tiles * kTile, o, so.n, dout, sdo.n, qt * kTile, n);
    named_barrier(1, kWgThreads);
    float lse2[2], dsub[2];  // rows g and g+8 of this warp: lse in log2 units, di
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * kTile + warp * 16 + g + 8 * r;
      lse2[r] = row < n ? lse[int64_t(bh) * n + row] * kLog2e : CUDART_INF_F;
      dsub[r] = sD[warp * 16 + g + 8 * r];
    }
    float acc[8][4];
    zero(acc);
    const uint64_t descQ = sw128_desc_k(sQ), descO = sw128_desc_k(sO);
    mbar_wait(res_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(full_bar + 8 * s, (j / kStages) & 1);
      dq_tile_wgmma(acc, descQ, descO, sK + s * kSwTileBytes, sV + s * kSwTileBytes, lse2, dsub,
                    j * kTile, n, c, scale, scale_log2);
      mbar_arrive(empty_bar + 8 * s);
    }
    dq += b * sdq.b + h * sdq.h;
    store_rows_bf16<64>(dq, sdq.n, qt * kTile + warp * 16, n, acc, lane);
  }
}

// ---- mma.sync: bf16 at Dh 16, 32, 128 ---------------------------------------

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale, float scale_log2) {
  constexpr int LD = DH + 8;  // padded row, elements
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;        // two buffers
  bf16* sO = sQ + 2 * kTile * LD;    // dO, two buffers
  float* sL = reinterpret_cast<float*>(sO + 2 * kTile * LD);  // two buffers
  float* sD = sL + 2 * kTile;                                  // two buffers

  const int n_tiles = (n + kTile - 1) / kTile;
  const int kt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dk += b * sdk.b + h * sdk.h;
  dv += b * sdv.b + h * sdv.h;
  lse += int64_t(bh) * n;
  di += int64_t(bh) * n_tiles * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = lane % 4;

  load_tile<DH, LD>(sK, k, sk.n, kt * kTile, n);
  load_tile<DH, LD>(sV, v, sv.n, kt * kTile, n);
  load_tile<DH, LD>(sQ, q, sq.n, 0, n);
  load_tile<DH, LD>(sO, dout, sdo.n, 0, n);
  cp_async_commit();
  load_row_stats(sL, sD, lse, di, 0, n, kWarps * 32);

  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile<DH, LD>(sQ + nb * kTile * LD, q, sq.n, (j + 1) * kTile, n);
      load_tile<DH, LD>(sO + nb * kTile * LD, dout, sdo.n, (j + 1) * kTile, n);
      cp_async_commit();
      load_row_stats(sL + nb * kTile, sD + nb * kTile, lse, di, (j + 1) * kTile, n, kWarps * 32);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      load_a_frags<DH, LD>(kf, sK, warp, lane);
      load_a_frags<DH, LD>(vf, sV, warp, lane);
    }
    const bf16* cQ = sQ + (j & 1) * kTile * LD;
    const bf16* cO = sO + (j & 1) * kTile * LD;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 keys and the tile's 64
    // queries (8 column tiles of 8)
    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    mma_abt<DH, LD>(st, kf, cQ, lane);
    mma_abt<DH, LD>(dpt, vf, cO, lane);
    dkv_scores(st, dpt, sL + (j & 1) * kTile, sD + (j & 1) * kTile, c, scale, scale_log2);
    uint32_t af[4][4];
    pack_a_frags(af, st);
    mma_pb<DH, LD>(dv_acc, af, cO, lane);  // dV += Pᵀ·dO
    pack_a_frags(af, dpt);
    mma_pb<DH, LD>(dk_acc, af, cQ, lane);  // dK += dSᵀ·Q
    __syncthreads();  // the next iteration's loads overwrite this tile's buffers
  }
  store_rows_bf16<DH>(dk, sdk.n, kt * kTile + warp * 16, n, dk_acc, lane);
  store_rows_bf16<DH>(dv, sdv.n, kt * kTile + warp * 16, n, dv_acc, lane);
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const bf16* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ di, bf16* __restrict__ dq, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdq, Strides so, float scale, float scale_log2) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kTile * LD;        // dO
  bf16* sK = sO + kTile * LD;        // two buffers
  bf16* sV = sK + 2 * kTile * LD;    // two buffers
  float* sD = reinterpret_cast<float*>(sV + 2 * kTile * LD);

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
  o += b * so.b + h * so.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;

  load_tile<DH, LD>(sQ, q, sq.n, qt * kTile, n);
  load_tile<DH, LD>(sO, dout, sdo.n, qt * kTile, n);
  load_tile<DH, LD>(sK, k, sk.n, 0, n);
  load_tile<DH, LD>(sV, v, sv.n, 0, n);
  cp_async_commit();

  float lse2[2], dsub[2];  // rows g and g+8: lse in log2 units, di
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qt * kTile + warp * 16 + g + 8 * r;
    lse2[r] = row < n ? lse[int64_t(bh) * n + row] * kLog2e : CUDART_INF_F;
  }

  uint32_t qf[DH / 16][4], of[DH / 16][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      load_tile<DH, LD>(sK + nb * kTile * LD, k, sk.n, (j + 1) * kTile, n);
      load_tile<DH, LD>(sV + nb * kTile * LD, v, sv.n, (j + 1) * kTile, n);
      cp_async_commit();
    }
    // di of this block's rows, read from O and dO in memory while the first
    // two key tiles are copied; warp w sums its own rows 16w..16w+15
    if (j == 0) row_di<DH>(sD, di + int64_t(bh) * n_tiles * kTile, o, so.n, dout, sdo.n,
                           qt * kTile, n);
    if (j + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {
      load_a_frags<DH, LD>(qf, sQ, warp, lane);
      load_a_frags<DH, LD>(of, sO, warp, lane);
      dsub[0] = sD[warp * 16 + g];
      dsub[1] = sD[warp * 16 + g + 8];
    }
    const bf16* cK = sK + (j & 1) * kTile * LD;
    const bf16* cV = sV + (j & 1) * kTile * LD;

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 queries and the tile's 64 keys
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt<DH, LD>(s, qf, cK, lane);
    mma_abt<DH, LD>(dp, of, cV, lane);
    dq_scores(s, dp, lse2, dsub, j * kTile, n, c, scale, scale_log2);
    uint32_t af[4][4];
    pack_a_frags(af, dp);
    mma_pb<DH, LD>(acc, af, cK, lane);  // dQ += dS·K
    __syncthreads();
  }
  store_rows_bf16<DH>(dq, sdq.n, qt * kTile + warp * 16, n, acc, lane);
}

// ---- SIMT: f32 --------------------------------------------------------------

// f32 K4: one thread per key row; its K and V rows in shared memory padded
// to DH + 1 floats, the streamed Q and dO tiles read as broadcasts.
template <int DH>
__global__ void __launch_bounds__(kTile) flash_bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dk, float* __restrict__ dv, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdk, Strides sdv, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // kTile x (DH + 1)
  float* sV = sK + kTile * (DH + 1);            // kTile x (DH + 1)
  float* sQ = sV + kTile * (DH + 1);            // kTile x DH
  float* sO = sQ + kTile * DH;                  // kTile x DH
  float* sL = sO + kTile * DH;                  // kTile
  float* sD = sL + kTile;                       // kTile

  const int n_tiles = (n + kTile - 1) / kTile;
  const int kt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dk += b * sdk.b + h * sdk.h;
  dv += b * sdv.b + h * sdv.h;
  lse += int64_t(bh) * n;
  di += int64_t(bh) * n_tiles * kTile;
  const int t = threadIdx.x;
  const int k0 = kt * kTile;

  for (int i = t; i < kTile * DH; i += kTile) {
    const int r = i / DH, d = i % DH;
    const bool in = k0 + r < n;
    sK[r * (DH + 1) + d] = in ? k[int64_t(k0 + r) * sk.n + d] : 0.f;
    sV[r * (DH + 1) + d] = in ? v[int64_t(k0 + r) * sv.n + d] : 0.f;
  }
  float gk[DH], gv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) gk[d] = gv[d] = 0.f;
  const float* krow = sK + t * (DH + 1);
  const float* vrow = sV + t * (DH + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * kTile;
    __syncthreads();  // the previous tile is consumed (and sK, sV are written)
    for (int i = t; i < kTile * DH; i += kTile) {
      const int r = i / DH, d = i % DH;
      const bool in = q0 + r < n;
      sQ[i] = in ? q[int64_t(q0 + r) * sq.n + d] : 0.f;
      sO[i] = in ? dout[int64_t(q0 + r) * sdo.n + d] : 0.f;
    }
    load_row_stats(sL, sD, lse, di, q0, n, kTile);
    __syncthreads();
    const int rows = min(kTile, n - q0);
    for (int i = 0; i < rows; ++i) {
      const float* qi = sQ + i * DH;
      const float* oi = sO + i * DH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(krow[d], qi[d], s);
        dp = fmaf(vrow[d], oi[d], dp);
      }
      const float p = fast_exp2(fmaf(s, scale_log2, -sL[i]));
      const float ds = (dp - sD[i]) * p * scale;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        gv[d] = fmaf(p, oi[d], gv[d]);
        gk[d] = fmaf(ds, qi[d], gk[d]);
      }
    }
  }
  if (k0 + t < n) {
    float* gkr = dk + int64_t(k0 + t) * sdk.n;
    float* gvr = dv + int64_t(k0 + t) * sdv.n;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      gkr[d] = gk[d];
      gvr[d] = gv[d];
    }
  }
}

// f32 K5: one thread per query row; its Q and dO rows in shared memory
// padded to DH + 1 floats, the streamed K and V tiles read as broadcasts.
// The thread also sums its row's di = Σ O∘dO (0 past n) into the di buffer.
template <int DH>
__global__ void __launch_bounds__(kTile) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ di, float* __restrict__ dq, int heads, int n, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdq, Strides so, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // kTile x (DH + 1)
  float* sO = sQ + kTile * (DH + 1);            // kTile x (DH + 1)
  float* sK = sO + kTile * (DH + 1);            // kTile x DH
  float* sV = sK + kTile * DH;                  // kTile x DH

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
  o += b * so.b + h * so.h;
  const int t = threadIdx.x;
  const int q0 = qt * kTile;
  const int row = q0 + t;

  for (int i = t; i < kTile * DH; i += kTile) {
    const int r = i / DH, d = i % DH;
    const bool in = q0 + r < n;
    sQ[r * (DH + 1) + d] = in ? q[int64_t(q0 + r) * sq.n + d] : 0.f;
    sO[r * (DH + 1) + d] = in ? dout[int64_t(q0 + r) * sdo.n + d] : 0.f;
  }
  __syncthreads();
  const float* qrow = sQ + t * (DH + 1);
  const float* orow = sO + t * (DH + 1);
  float dsub = 0.f;
  if (row < n) {
    const float* orow_g = o + int64_t(row) * so.n;
#pragma unroll
    for (int d = 0; d < DH; ++d) dsub = fmaf(orow_g[d], orow[d], dsub);
  }
  di[int64_t(bh) * n_tiles * kTile + row] = dsub;
  const float lse2 = row < n ? lse[int64_t(bh) * n + row] * kLog2e : CUDART_INF_F;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kTile;
    __syncthreads();
    for (int i = t; i < kTile * DH; i += kTile) {
      const int r = i / DH, d = i % DH;
      const bool in = key0 + r < n;
      sK[i] = in ? k[int64_t(key0 + r) * sk.n + d] : 0.f;
      sV[i] = in ? v[int64_t(key0 + r) * sv.n + d] : 0.f;
    }
    __syncthreads();
    const int keys = min(kTile, n - key0);
    for (int e = 0; e < keys; ++e) {
      const float* kr = sK + e * DH;
      const float* vr = sV + e * DH;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qrow[d], kr[d], s);
        dp = fmaf(orow[d], vr[d], dp);
      }
      const float ds = (dp - dsub) * fast_exp2(fmaf(s, scale_log2, -lse2)) * scale;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, kr[d], acc[d]);
    }
  }
  if (row < n) {
    float* dst = dq + int64_t(row) * sdq.n;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = acc[d];
  }
}

// ---- launch ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const void* o;  // K5 only
  const float* lse;
  float* di;      // (B, H, N64): K5 writes it, K4 reads it
  void *g0, *g1;  // K4: dK, dV; K5: dQ, unused
  int batch, heads, n;
  Strides s[6];   // q, k, v, dO, then K4: dK, dV; K5: dQ, O
  float scale, scale_log2;
};

cudaError_t encode_maps(TileMaps& maps, const Args& a) {
  cudaError_t err;
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  CUtensorMap* out[4] = {&maps.q, &maps.k, &maps.v, &maps.dout};
  for (int i = 0; i < 4; ++i)
    if ((err = encode_tile_map(out[i], ptrs[i], a.batch, a.heads, a.n, a.s[i])) != cudaSuccess)
      return err;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int DH>
cudaError_t launch_dkv(Design design, int blocks, cudaStream_t st, const Args& a) {
  cudaError_t err;
  const auto q = static_cast<const bf16*>(a.q), k = static_cast<const bf16*>(a.k),
             v = static_cast<const bf16*>(a.v), dout = static_cast<const bf16*>(a.dout);
  const auto dk = static_cast<bf16*>(a.g0), dv = static_cast<bf16*>(a.g1);
  if (design == kWgmma) {
    if constexpr (DH == 64) {
      TileMaps maps;
      if ((err = encode_maps(maps, a)) != cudaSuccess) return err;
      const size_t smem = kTmaTilesBytes + 1024 + kTmaBarBytes + 2 * kStages * kTile * 4;
      if ((err = set_smem(flash_bwd_dkv_tma, smem)) != cudaSuccess) return err;
      flash_bwd_dkv_tma<<<blocks, kTmaThreads, smem, st>>>(
          maps, a.lse, a.di, dk, dv, a.heads, a.n, a.s[4], a.s[5], a.scale, a.scale_log2);
    } else {
      return cudaErrorInvalidValue;  // wgmma is written for Dh 64 only
    }
  } else if (design == kMmaSync) {
    if constexpr (DH == 64) {
      return cudaErrorInvalidValue;  // Dh 64 runs on wgmma
    } else {
      const size_t smem = size_t(6) * kTile * (DH + 8) * sizeof(bf16) + 4 * kTile * sizeof(float);
      if ((err = set_smem(flash_bwd_dkv_bf16<DH>, smem)) != cudaSuccess) return err;
      flash_bwd_dkv_bf16<DH><<<blocks, kWarps * 32, smem, st>>>(
          q, k, v, dout, a.lse, a.di, dk, dv, a.heads, a.n, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
          a.s[5], a.scale, a.scale_log2);
    }
  } else {
    const size_t smem = (size_t(kTile) * (4 * DH + 2) + 2 * kTile) * sizeof(float);
    if ((err = set_smem(flash_bwd_dkv_f32<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_f32<DH><<<blocks, kTile, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.di,
        static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.heads, a.n, a.s[0], a.s[1],
        a.s[2], a.s[3], a.s[4], a.s[5], a.scale, a.scale_log2);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(Design design, int blocks, cudaStream_t st, const Args& a) {
  cudaError_t err;
  const auto q = static_cast<const bf16*>(a.q), k = static_cast<const bf16*>(a.k),
             v = static_cast<const bf16*>(a.v), dout = static_cast<const bf16*>(a.dout),
             o = static_cast<const bf16*>(a.o);
  const auto dq = static_cast<bf16*>(a.g0);
  if (design == kWgmma) {
    if constexpr (DH == 64) {
      TileMaps maps;
      if ((err = encode_maps(maps, a)) != cudaSuccess) return err;
      const size_t smem = kTmaTilesBytes + 1024 + kTmaBarBytes + kTile * 4;
      if ((err = set_smem(flash_bwd_dq_tma, smem)) != cudaSuccess) return err;
      flash_bwd_dq_tma<<<blocks, kTmaThreads, smem, st>>>(
          maps, dout, o, a.lse, a.di, dq, a.heads, a.n, a.s[3], a.s[4], a.s[5], a.scale,
          a.scale_log2);
    } else {
      return cudaErrorInvalidValue;  // wgmma is written for Dh 64 only
    }
  } else if (design == kMmaSync) {
    if constexpr (DH == 64) {
      return cudaErrorInvalidValue;  // Dh 64 runs on wgmma
    } else {
      const size_t smem = size_t(6) * kTile * (DH + 8) * sizeof(bf16) + kTile * sizeof(float);
      if ((err = set_smem(flash_bwd_dq_bf16<DH>, smem)) != cudaSuccess) return err;
      flash_bwd_dq_bf16<DH><<<blocks, kWarps * 32, smem, st>>>(
          q, k, v, dout, o, a.lse, a.di, dq, a.heads, a.n, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
          a.s[5], a.scale, a.scale_log2);
    }
  } else {
    const size_t smem = size_t(kTile) * (4 * DH + 2) * sizeof(float);
    if ((err = set_smem(flash_bwd_dq_f32<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_f32<DH><<<blocks, kTile, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.o), a.lse, a.di, static_cast<float*>(a.g0), a.heads, a.n,
        a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale, a.scale_log2);
  }
  return cudaGetLastError();
}

// Shared checks and argument packing of the two entry points.
int run(bool dkv, int device, const void* q, const void* k, const void* v, const void* dout,
        const void* o, const void* lse, void* di, void* g0, void* g1, int batch, int heads, int n,
        int dh, int elem_bytes, int design, const int64_t* strides, float scale, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaGetLastError();
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  if (dh != 16 && dh != 32 && dh != 64 && dh != 128) return cudaErrorInvalidValue;
  if (design != kSimt && design != kMmaSync && design != kWgmma) return cudaErrorInvalidValue;
  if ((design == kSimt) != (elem_bytes == 4)) return cudaErrorInvalidValue;  // SIMT takes f32
  const Design chosen = static_cast<Design>(design);
  Args a{q, k, v, dout, o, static_cast<const float*>(lse), static_cast<float*>(di), g0, g1,
         batch, heads, n, {}, scale, scale * kLog2e};
  for (int i = 0; i < 6; ++i) a.s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int64_t blocks64 = int64_t(batch) * heads * ((n + kTile - 1) / kTile);
  if (blocks64 > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = int(blocks64);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return dkv ? launch_dkv<16>(chosen, blocks, st, a) : launch_dq<16>(chosen, blocks, st, a);
    case 32: return dkv ? launch_dkv<32>(chosen, blocks, st, a) : launch_dq<32>(chosen, blocks, st, a);
    case 64: return dkv ? launch_dkv<64>(chosen, blocks, st, a) : launch_dq<64>(chosen, blocks, st, a);
    default:
      return dkv ? launch_dkv<128>(chosen, blocks, st, a) : launch_dq<128>(chosen, blocks, st, a);
  }
}

}  // namespace

// K5, launched first. q, k, v, dout, dq, o: (batch, heads, n, dh) with unit
// stride along dh and element strides {b, h, n} for each in that order (18
// values); bf16 rows 16-byte aligned (the wrapper checks). lse: contiguous
// f32 (batch, heads, n). di: contiguous f32 (batch, heads, n rounded up to a
// multiple of 64), written here. elem_bytes: 2 (bf16) or 4 (f32); dh: 16,
// 32, 64, 128; design: 0 SIMT (f32), 1 mma.sync (bf16, Dh 16, 32, 128), 2
// wgmma (bf16, Dh 64), as ops/attention.py:attention_design chooses it.
extern "C" int dh_flash_attention_bwd_dq(int device, const void* q, const void* k,
                                         const void* v, const void* dout, const void* o,
                                         const void* lse, void* di, void* dq, int batch,
                                         int heads, int n, int dh, int elem_bytes, int design,
                                         const int64_t* strides, float scale, void* stream) {
  return run(false, device, q, k, v, dout, o, lse, di, dq, nullptr, batch, heads, n, dh,
             elem_bytes, design, strides, scale, stream);
}

// K4, after K5. As K5 with the outputs dk, dv (strides of q, k, v, dout, dk,
// dv) and di read, not written.
extern "C" int dh_flash_attention_bwd_dkv(int device, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* di, void* dk, void* dv, int batch,
                                          int heads, int n, int dh, int elem_bytes, int design,
                                          const int64_t* strides, float scale, void* stream) {
  return run(true, device, q, k, v, dout, nullptr, lse, const_cast<void*>(di), dk, dv, batch,
             heads, n, dh, elem_bytes, design, strides, scale, stream);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
