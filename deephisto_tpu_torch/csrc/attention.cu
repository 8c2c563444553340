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
// Design (bf16, FlashAttention-2 style). One block of 4 warps per
// (batch·head, 64-query tile); each warp owns 16 query rows, whose Q fragments
// stay in registers. The block walks the 64-row K/V tiles in order, staged in
// shared memory with cp.async two tiles deep (the next tile loads while this
// one is computed). S = Q·Kᵀ and O += P·V run on mma.sync m16n8k16 bf16 with
// f32 accumulators; ldmatrix feeds K as is and V transposed; the S
// accumulators become P's A fragments in registers without a trip through
// shared memory. Shared-memory rows are padded by 16 bytes so ldmatrix is
// free of bank conflicts. Only the last K/V tile is masked, and the scale
// (> 0) is folded into the row max and, by one FMA, into each exponent.
// (8 warps on 128-query tiles were slower at (256, 6, 784, 64) on the H100:
// 784 tokens fill 13 tiles of 64 better than 7 of 128.) wgmma and TMA are
// left for a later version.
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

template <int DH, bool LSE>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int heads, int n, Strides sq, Strides sk, Strides sv, Strides so,
    float scale_log2) {
  constexpr int LD = DH + 8;  // padded row, elements
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kTile * LD;      // two buffers
  __nv_bfloat16* sV = sK + 2 * kTile * LD;  // two buffers

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
    const __nv_bfloat16* cK = sK + (j & 1) * kTile * LD;
    const __nv_bfloat16* cV = sV + (j & 1) * kTile * LD;

    // S = Q·Kᵀ for this warp's 16 rows and the tile's 64 keys: 8 n-tiles of 8
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    mma_abt<DH, LD>(s, qf, cK, lane);

    // mask the ragged edge (the last tile only), then the online softmax in
    // log2 units: the scale (> 0) multiplies the row max and, in one FMA,
    // each score, so 2^(s·scale·log2e - max) is exp(s·scale - max·scale)
    const int key0 = j * kTile;
    if (key0 + kTile > n) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + t * 8 + 2 * c + (e & 1) >= n) s[t][e] = -CUDART_INF_F;
    }
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
    const float alpha[2] = {fast_exp2(m_run[0] - mx[0]), fast_exp2(m_run[1] - mx[1])};
    m_run[0] = mx[0];
    m_run[1] = mx[1];

    uint32_t pf[4][4];  // P as the A fragments of 4 k16 steps over the 64 keys
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
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    mma_pb<DH, LD>(acc, pf, cV, lane);  // O += P·V
    __syncthreads();  // the next iteration's loads overwrite this tile's buffers
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    // the row's log-sum-exp of the scaled scores, for the backward
    const int row = qt * kTile + warp * 16 + lane / 4 + 8 * r;
    if (LSE && c == 0 && row < n)
      lse[int64_t(bh) * n + row] = (m_run[r] + log2f(l)) * CUDART_LN2_F;
  }
  store_rows_bf16<DH>(o, so.n, qt * kTile + warp * 16, n, acc, lane, inv[0], inv[1]);
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

template <int DH, bool LSE>
cudaError_t launch_bf16(int blocks, cudaStream_t stream, const void* q, const void* k,
                        const void* v, void* o, float* lse, int heads, int n, const Strides* s,
                        float scale_log2) {
  const size_t smem = size_t(5) * kTile * (DH + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DH, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_bf16<DH, LSE><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, heads, n, s[0],
      s[1], s[2], s[3], scale_log2);
  return cudaGetLastError();
}

template <int DH, bool LSE>
cudaError_t launch_f32(int blocks, cudaStream_t stream, const void* q, const void* k,
                       const void* v, void* o, float* lse, int heads, int n, const Strides* s,
                       float scale_log2) {
  const size_t smem = size_t(kTile) * (3 * DH + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_f32<DH, LSE><<<blocks, kTile, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, heads, n, s[0], s[1], s[2], s[3], scale_log2);
  return cudaGetLastError();
}

// One (dtype, with or without lse) launch at head width DH.
template <int DH>
cudaError_t launch(bool bf16, int blocks, cudaStream_t st, const void* q, const void* k,
                   const void* v, void* o, float* lse, int heads, int n, const Strides* s,
                   float scale_log2) {
  if (bf16)
    return lse ? launch_bf16<DH, true>(blocks, st, q, k, v, o, lse, heads, n, s, scale_log2)
               : launch_bf16<DH, false>(blocks, st, q, k, v, o, lse, heads, n, s, scale_log2);
  return lse ? launch_f32<DH, true>(blocks, st, q, k, v, o, lse, heads, n, s, scale_log2)
             : launch_f32<DH, false>(blocks, st, q, k, v, o, lse, heads, n, s, scale_log2);
}

}  // namespace

// q, k, v, o: (batch, heads, n, dh) with unit stride along dh and element
// strides `strides` = {b, h, n} for q, k, v and o in turn (12 values); bf16
// rows 16-byte aligned (the wrapper checks). lse: null, or a contiguous f32
// (batch, heads, n) that receives each row's log-sum-exp of the scaled
// scores (the residual of the backward). elem_bytes: 2 (bf16) or 4 (f32).
// dh: 16, 32, 64 or 128. scale > 0 (the bf16 path scales the row max).
extern "C" int dh_flash_attention(int device, const void* q, const void* k, const void* v,
                                  void* o, void* lse, int batch, int heads, int n, int dh,
                                  int elem_bytes, const int64_t* strides, float scale,
                                  void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaGetLastError();
  Strides s[4];
  for (int i = 0; i < 4; ++i) s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int64_t blocks64 = int64_t(batch) * heads * ((n + kTile - 1) / kTile);
  if (blocks64 > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = int(blocks64);
  const float scale_log2 = scale * kLog2e;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (elem_bytes != 2 && elem_bytes != 4) return cudaErrorInvalidValue;
  const bool bf16 = elem_bytes == 2;
  switch (dh) {
    case 16: return launch<16>(bf16, blocks, st, q, k, v, o, l, heads, n, s, scale_log2);
    case 32: return launch<32>(bf16, blocks, st, q, k, v, o, l, heads, n, s, scale_log2);
    case 64: return launch<64>(bf16, blocks, st, q, k, v, o, l, heads, n, s, scale_log2);
    case 128: return launch<128>(bf16, blocks, st, q, k, v, o, l, heads, n, s, scale_log2);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
