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
// Inputs: Q, K, V, dO (B, H, N, Dh) with unit stride along Dh, lse (B, H, N)
// f32 from K3 (each row's log-sum-exp of the scaled scores) and
// di = Σ_d O∘dO (B, H, N) f32, which the wrapper computes as a torch op, as
// the TPU path computes it in XLA. The TPU kernels' precision contract is
// kept: S = Q·Kᵀ accumulates in f32 and is scaled in f32, P = exp(S - lse) in
// f32, P is cast to dO's dtype before Pᵀ·dO, dP = dO·Vᵀ accumulates in f32,
// dS = (dP - di)∘P·scale in f32 is cast to the inputs' dtype before dSᵀ·Q and
// dS·K, every product accumulates in f32, and dQ, dK, dV are written in the
// inputs' dtype. The TPU path pads N to a multiple of 512 and masks the pad
// tokens with segment ids; here the ragged edge is masked in the kernels:
// queries >= N load as zero rows with lse = +inf (so P = 0) and di = 0, keys
// >= N have P = 0 in K5, and no row >= N is written.
//
// Bound: operations. The backward does 5 products of 2·B·H·N²·Dh FLOPs
// (S, dP, dV, dK, dQ; these kernels recompute S and dP in both, 7 in all):
// at the ViT-S/8 training shape (256, 6, 784, 64) bf16, 604 GFLOP, 0.611 ms at
// 989 TFLOP/s, against ~1.1 GB of Q, K, V, dO, dQ, dK, dV, lse and di moved
// once, 0.33 ms at 3.35 TB/s.
//
// Design (bf16), K3's shape: one block of 4 warps per (batch·head, 64-row
// tile), each warp 16 rows of the block's tile whose operands stay in
// registers as mma.sync m16n8k16 A fragments; the streamed 64-row tiles are
// staged in shared memory by cp.async two tiles deep. In K4 a warp computes
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for its 16 keys (so P and dS come out transposed,
// already the A operands of Pᵀ·dO and dSᵀ·Q), and ldmatrix.trans feeds dO and Q
// as the B operands. In K5 a warp computes S = Q·Kᵀ and dP = dO·Vᵀ for its 16
// queries and dQ += dS·K with K transposed by ldmatrix. The per-query lse and
// di of a streamed query tile sit in shared memory beside it. wgmma and TMA
// are left for a later version.
//
// The f32 paths are plain SIMT FMA in full f32 (one thread per key row in K4,
// per query row in K5, the streamed tiles broadcast from shared memory), so
// float32 models train on the card too; they are for correctness, not speed.

#include "flash_common.cuh"

namespace {

using namespace flash;

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

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int heads, int n, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdk, Strides sdv, float scale, float scale_log2) {
  constexpr int LD = DH + 8;  // padded row, elements
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sQ = sV + kTile * LD;        // two buffers
  __nv_bfloat16* sO = sQ + 2 * kTile * LD;    // dO, two buffers
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
  di += int64_t(bh) * n;
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
    const __nv_bfloat16* cQ = sQ + (j & 1) * kTile * LD;
    const __nv_bfloat16* cO = sO + (j & 1) * kTile * LD;
    const float* cL = sL + (j & 1) * kTile;
    const float* cD = sD + (j & 1) * kTile;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 keys and the tile's 64
    // queries (8 column tiles of 8)
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
    mma_abt<DH, LD>(st, kf, cQ, lane);
    mma_abt<DH, LD>(dpt, vf, cO, lane);

    // Pᵀ = exp(Sᵀ·scale - lse) and dSᵀ = (dPᵀ - di)∘Pᵀ·scale, per query column
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
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ di, __nv_bfloat16* __restrict__ dq,
    int heads, int n, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, float scale,
    float scale_log2) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + kTile * LD;        // dO
  __nv_bfloat16* sK = sO + kTile * LD;        // two buffers
  __nv_bfloat16* sV = sK + 2 * kTile * LD;    // two buffers

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / heads, h = bh % heads;
  q += b * sq.b + h * sq.h;
  k += b * sk.b + h * sk.h;
  v += b * sv.b + h * sv.h;
  dout += b * sdo.b + h * sdo.h;
  dq += b * sdq.b + h * sdq.h;
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
    dsub[r] = row < n ? di[int64_t(bh) * n + row] : 0.f;
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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      load_a_frags<DH, LD>(qf, sQ, warp, lane);
      load_a_frags<DH, LD>(of, sO, warp, lane);
    }
    const __nv_bfloat16* cK = sK + (j & 1) * kTile * LD;
    const __nv_bfloat16* cV = sV + (j & 1) * kTile * LD;

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 queries and the tile's 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
    mma_abt<DH, LD>(s, qf, cK, lane);
    mma_abt<DH, LD>(dp, of, cV, lane);

    // dS = (dP - di)∘P·scale with P = exp(S·scale - lse); keys >= n have P = 0
    const int key0 = j * kTile;
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
    uint32_t af[4][4];
    pack_a_frags(af, dp);
    mma_pb<DH, LD>(acc, af, cK, lane);  // dQ += dS·K
    __syncthreads();
  }
  store_rows_bf16<DH>(dq, sdq.n, qt * kTile + warp * 16, n, acc, lane);
}

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
  di += int64_t(bh) * n;
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
template <int DH>
__global__ void __launch_bounds__(kTile) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int heads, int n, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdq, float scale, float scale_log2) {
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
  const int t = threadIdx.x;
  const int q0 = qt * kTile;
  const int row = q0 + t;

  for (int i = t; i < kTile * DH; i += kTile) {
    const int r = i / DH, d = i % DH;
    const bool in = q0 + r < n;
    sQ[r * (DH + 1) + d] = in ? q[int64_t(q0 + r) * sq.n + d] : 0.f;
    sO[r * (DH + 1) + d] = in ? dout[int64_t(q0 + r) * sdo.n + d] : 0.f;
  }
  const float lse2 = row < n ? lse[int64_t(bh) * n + row] * kLog2e : CUDART_INF_F;
  const float dsub = row < n ? di[int64_t(bh) * n + row] : 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const float* qrow = sQ + t * (DH + 1);
  const float* orow = sO + t * (DH + 1);

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

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *g0, *g1;  // K4: dK, dV; K5: dQ, unused
  int heads, n;
  Strides s[6];   // q, k, v, dO, then the outputs' in the same order
  float scale, scale_log2;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int DH>
cudaError_t launch_dkv(bool bf16, int blocks, cudaStream_t st, const Args& a) {
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    const size_t smem = size_t(6) * kTile * (DH + 8) * sizeof(T) + 4 * kTile * sizeof(float);
    if ((err = set_smem(flash_bwd_dkv_bf16<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dkv_bf16<DH><<<blocks, kWarps * 32, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.g0), static_cast<T*>(a.g1),
        a.heads, a.n, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale, a.scale_log2);
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
cudaError_t launch_dq(bool bf16, int blocks, cudaStream_t st, const Args& a) {
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    const size_t smem = size_t(6) * kTile * (DH + 8) * sizeof(T);
    if ((err = set_smem(flash_bwd_dq_bf16<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_bf16<DH><<<blocks, kWarps * 32, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.g0), a.heads, a.n, a.s[0],
        a.s[1], a.s[2], a.s[3], a.s[4], a.scale, a.scale_log2);
  } else {
    const size_t smem = size_t(kTile) * (4 * DH + 2) * sizeof(float);
    if ((err = set_smem(flash_bwd_dq_f32<DH>, smem)) != cudaSuccess) return err;
    flash_bwd_dq_f32<DH><<<blocks, kTile, smem, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.di,
        static_cast<float*>(a.g0), a.heads, a.n, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], a.scale,
        a.scale_log2);
  }
  return cudaGetLastError();
}

// Shared checks and argument packing of the two entry points.
int run(bool dkv, int device, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* di, void* g0, void* g1, int batch, int heads, int n, int dh,
        int elem_bytes, const int64_t* strides, float scale, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaGetLastError();
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(di), g0, g1,
         heads, n, {}, scale, scale * kLog2e};
  const int n_ops = dkv ? 6 : 5;
  for (int i = 0; i < n_ops; ++i)
    a.s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int64_t blocks64 = int64_t(batch) * heads * ((n + kTile - 1) / kTile);
  if (blocks64 > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = int(blocks64);
  const bool bf16 = elem_bytes == 2;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return dkv ? launch_dkv<16>(bf16, blocks, st, a) : launch_dq<16>(bf16, blocks, st, a);
    case 32: return dkv ? launch_dkv<32>(bf16, blocks, st, a) : launch_dq<32>(bf16, blocks, st, a);
    case 64: return dkv ? launch_dkv<64>(bf16, blocks, st, a) : launch_dq<64>(bf16, blocks, st, a);
    case 128:
      return dkv ? launch_dkv<128>(bf16, blocks, st, a) : launch_dq<128>(bf16, blocks, st, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K4. q, k, v, dout, dk, dv: (batch, heads, n, dh) with unit stride along dh
// and element strides {b, h, n} for each in that order (18 values); bf16 rows
// 16-byte aligned (the wrapper checks). lse, di: contiguous f32
// (batch, heads, n). elem_bytes: 2 (bf16) or 4 (f32); dh: 16, 32, 64, 128.
extern "C" int dh_flash_attention_bwd_dkv(int device, const void* q, const void* k,
                                          const void* v, const void* dout, const void* lse,
                                          const void* di, void* dk, void* dv, int batch,
                                          int heads, int n, int dh, int elem_bytes,
                                          const int64_t* strides, float scale, void* stream) {
  return run(true, device, q, k, v, dout, lse, di, dk, dv, batch, heads, n, dh, elem_bytes,
             strides, scale, stream);
}

// K5. As K4 with one output, dq (strides of q, k, v, dout, dq: 15 values).
extern "C" int dh_flash_attention_bwd_dq(int device, const void* q, const void* k,
                                         const void* v, const void* dout, const void* lse,
                                         const void* di, void* dq, int batch, int heads, int n,
                                         int dh, int elem_bytes, const int64_t* strides,
                                         float scale, void* stream) {
  return run(false, device, q, k, v, dout, lse, di, dq, nullptr, batch, heads, n, dh, elem_bytes,
             strides, scale, stream);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
