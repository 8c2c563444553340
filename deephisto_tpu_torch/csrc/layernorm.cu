// K8: a residual add (with LayerScale's γ) and the LayerNorm after it, in one pass:
//   s = x + r  or  s = x + γ⊙r,          rounded once to the activation type,
//   y = (s − μ)·rsqrt(σ² + eps)·w + b,   rounded once,
// μ and σ² the mean and the biased variance of s's row, in float32; x, r, γ, s and y
// bf16 or f32, w and b the LayerNorm's float32 parameters. Without r it is the
// LayerNorm alone (y of x; no s), which the first block's ln1 takes.
//
// Replaces no TPU kernel: XLA fused the JAX ViT's LayerNorm (the flax LayerNorm in
// deephisto_tpu/models/vit.py) into its neighbours. On the card PyTorch runs a
// residual add and the LayerNorm after it as four passes: the add (or LayerScale's
// addcmul), a cast of s to float32, the LayerNorm in float32 and a cast back.
//
// Numerics follow those passes: s is formed in float32 as x + r, or as fma(γ, r, x)
// (ATen's addcmul contracts to one), and rounded once, as they store it; the statistics
// are taken of the rounded s; y is w·(rstd·(s − μ)) + b with rstd = rsqrtf(σ² + eps),
// the order of ATen's LayerNorm kernel. Only the order of the sums of μ and σ²
// differs (a sum a lane, then a butterfly across the row's lanes; ATen merges
// Welford partials), which moves y by a float32 ulp or so and, where that crosses a
// rounding boundary, a bf16 value by one ulp.
//
// Bound: bytes. A call reads x and r and writes s and y once: at bf16, 200,704 rows
// of 384 (a ViT-S/8 batch of 256 patches) are 617 MB, 0.184 ms at 3.35 TB/s; 67,840
// rows of 1536 (a UNI2-h batch) 834 MB, 0.249 ms. The four passes move 3.3 times the
// bytes.
//
// Design: one HBM read of x and r and one write of s and y, in 16-byte vectors. A
// row is split over `lanes` neighbouring lanes of a warp, the largest power of two
// up to 32 that divides the row's vectors (dim 384 bf16: 48 vectors, 16 lanes × 3,
// two rows a warp; dim 1536: 192 vectors, 32 lanes × 6), and held in registers (as s
// in its own type) from the loads through the statistics to the stores. Mean and
// variance are warp-shuffle butterflies within the lanes of the row, the variance
// as Σ(s − μ)² from the registers. w, b and γ are read through the read-only cache
// at each row (12 KB at dim 1536: they stay in L1); held in registers as well they
// would take a thread at dim 1536 to ~190 registers, one block an SM. x and r are
// streaming loads (read once). A persistent grid of as many blocks as fit the SMs
// walks the rows, so every SM keeps several rows a warp in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // a cap of 128 registers a thread
constexpr int kMaxVecs = 16;   // 16-byte vectors a lane holds of a row

enum Mode { kNorm, kAdd, kAddScaled };

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;  // elements in 16 bytes
  __device__ __forceinline__ static float get(const uint4& v, int i) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[i]);
  }
  __device__ __forceinline__ static void put(uint4& v, int i, float f) {
    reinterpret_cast<__nv_bfloat16*>(&v)[i] = __float2bfloat16_rn(f);
  }
};

template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static float get(const uint4& v, int i) {
    return reinterpret_cast<const float*>(&v)[i];
  }
  __device__ __forceinline__ static void put(uint4& v, int i, float f) {
    reinterpret_cast<float*>(&v)[i] = f;
  }
};

// the sum over the `lanes` neighbouring lanes (a power of two) that hold one row
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x, r, s, y: (rows, vecs) 16-byte vectors; gamma: (vecs); weight, bias: (dim) f32.
// Each warp takes 32 / lanes rows at a time, every lane of it through every
// iteration (the shuffles need the whole warp), a row past the end masked.
template <typename T, int V, int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    add_layernorm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ r,
                         const uint4* __restrict__ gamma, const float4* __restrict__ weight,
                         const float4* __restrict__ bias, uint4* __restrict__ s_out,
                         uint4* __restrict__ y_out, int64_t rows, int vecs, int lanes, float dim,
                         float eps) {
  using P = Pack<T>;
  constexpr int kF4 = P::n / 4;  // float4s of w (and of b) a vector covers
  const int lane = threadIdx.x & (lanes - 1);
  const int rows_per_warp = 32 / lanes;
  const int64_t warp = (int64_t(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t warps = int64_t(gridDim.x) * (kThreads / 32);
  const int sub = (threadIdx.x & 31) / lanes;
  for (int64_t base = warp * rows_per_warp; base < rows; base += warps * rows_per_warp) {
    const int64_t row = base + sub;
    const bool live = row < rows;
    const int64_t off = row * vecs;
    uint4 sv[V], rv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + k * lanes;
      if (live && c < vecs) {
        sv[k] = __ldcs(x + off + c);
        if (M != kNorm) rv[k] = __ldcs(r + off + c);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + k * lanes;
      if (live && c < vecs) {
        if (M != kNorm) {
          uint4 g;
          if (M == kAddScaled) g = __ldg(gamma + c);
#pragma unroll
          for (int i = 0; i < P::n; ++i) {
            const float a = P::get(sv[k], i), b = P::get(rv[k], i);
            P::put(sv[k], i,
                   M == kAddScaled ? fmaf(P::get(g, i), b, a) : __fadd_rn(a, b));
          }
        }
#pragma unroll
        for (int i = 0; i < P::n; ++i) sum += P::get(sv[k], i);
      }
    }
    const float mean = row_sum(sum, lanes) / dim;
    float m2 = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + k * lanes;
      if (live && c < vecs) {
#pragma unroll
        for (int i = 0; i < P::n; ++i) {
          const float d = P::get(sv[k], i) - mean;
          m2 = fmaf(d, d, m2);
        }
      }
    }
    const float rstd = rsqrtf(row_sum(m2, lanes) / dim + eps);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + k * lanes;
      if (live && c < vecs) {
        if (M != kNorm) s_out[off + c] = sv[k];
        uint4 out;
#pragma unroll
        for (int j = 0; j < kF4; ++j) {
          const float4 w = __ldg(weight + c * kF4 + j), b = __ldg(bias + c * kF4 + j);
          const float wj[4] = {w.x, w.y, w.z, w.w}, bj[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * j + q;
            P::put(out, i, fmaf(wj[q], rstd * (P::get(sv[k], i) - mean), bj[q]));
          }
        }
        y_out[off + c] = out;
      }
    }
  }
}

struct Args {
  const void *x, *r, *gamma, *weight, *bias;
  void *s, *y;
  int64_t rows;
  int vecs, lanes, sms;
  float dim, eps;
  cudaStream_t stream;
};

template <typename T, int V, int M>
cudaError_t launch(const Args& a) {
  auto kernel = add_layernorm_kernel<T, V, M>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = int64_t(kThreads / 32) * (32 / a.lanes);
  const int64_t need = (a.rows + rows_per_block - 1) / rows_per_block;
  const int64_t fit = int64_t(a.sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < fit ? need : fit);
  kernel<<<grid, kThreads, 0, a.stream>>>(
      static_cast<const uint4*>(a.x), static_cast<const uint4*>(a.r),
      static_cast<const uint4*>(a.gamma), static_cast<const float4*>(a.weight),
      static_cast<const float4*>(a.bias), static_cast<uint4*>(a.s), static_cast<uint4*>(a.y),
      a.rows, a.vecs, a.lanes, a.dim, a.eps);
  return cudaGetLastError();
}

// V rounded up to an instantiated count; the lanes past the row's vectors are masked
template <typename T, int M>
cudaError_t launch_mode(int v, const Args& a) {
  if (v <= 1) return launch<T, 1, M>(a);
  if (v <= 2) return launch<T, 2, M>(a);
  if (v <= 3) return launch<T, 3, M>(a);
  if (v <= 4) return launch<T, 4, M>(a);
  if (v <= 6) return launch<T, 6, M>(a);
  if (v <= 8) return launch<T, 8, M>(a);
  if (v <= 12) return launch<T, 12, M>(a);
  return launch<T, 16, M>(a);
}

template <typename T>
cudaError_t launch_type(int v, const Args& a) {
  if (a.r == nullptr) return launch_mode<T, kNorm>(v, a);
  if (a.gamma == nullptr) return launch_mode<T, kAdd>(v, a);
  return launch_mode<T, kAddScaled>(v, a);
}

struct DeviceGuard {
  int prev = -1;
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

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// x, y: (rows, dim) contiguous; r and s the same or both null (the LayerNorm alone);
// gamma (dim) or null; weight, bias (dim) float32; every pointer 16-byte aligned;
// elem_bytes 2 (bf16) or 4 (f32); dim a multiple of 8 and at most 512 vectors of 16
// bytes (the wrapper checks all of it).
extern "C" int dh_add_layernorm(int device, const void* x, const void* r, const void* gamma,
                                const void* weight, const void* bias, void* s, void* y,
                                int64_t rows, int dim, int elem_bytes, float eps, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  const int vecs = dim * elem_bytes / 16;
  if ((elem_bytes != 2 && elem_bytes != 4) || dim <= 0 || dim % 8 != 0 ||
      vecs > 32 * kMaxVecs || (r == nullptr) != (s == nullptr) ||
      (r == nullptr && gamma != nullptr) || misaligned(x) || misaligned(r) ||
      misaligned(gamma) || misaligned(weight) || misaligned(bias) || misaligned(s) ||
      misaligned(y)) {
    return cudaErrorInvalidValue;
  }
  if (rows <= 0) return cudaGetLastError();
  int lanes = 32;
  while (vecs % lanes) lanes >>= 1;
  int v = vecs / lanes;
  if (v > kMaxVecs) {  // no power of two fits the row evenly: 32 lanes, the last ragged
    lanes = 32;
    v = (vecs + 31) / 32;
  }
  Args a{x, r, gamma, weight, bias, s, y, rows, vecs, lanes, 0, float(dim), eps,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return elem_bytes == 2 ? launch_type<__nv_bfloat16>(v, a) : launch_type<float>(v, a);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
