// K7: the SwiGLU gate of a packed fc1 output (timm's SwiGLUPacked, gate first):
//   out[r, j] = silu(u[r, j]) * u[r, h + j],   silu(a) = a / (1 + exp(-a)),
// for a row-major (rows, 2h) input and a (rows, h) output, in float32 and
// rounded once to the output's type (round to nearest even).
//
// Replaces no TPU kernel: the JAX package has no gated MLP. It was added for
// the UNI2-h ViT (models/vit.py:GatedBlock), whose MLP is 65 % of the model's
// operations; stock PyTorch runs the gate as two passes (silu, then mul) with a
// (rows, h) intermediate between them.
//
// Bound: bytes. A call reads 2h and writes h elements a row once: at bf16,
// rows = 67,840 (256 patches of 265 tokens) and h = 4096, 1.67 GB, 0.50 ms at
// 3.35 TB/s. The arithmetic (an exp, a division and a product an element)
// keeps well under that time only while it overlaps the memory traffic.
//
// Design: one pass of 16-byte vectors. A block walks whole rows; its threads
// take the row's vectors side by side, so a warp reads 512 contiguous bytes
// of each half and writes 512 of the output. Each thread issues the loads of
// its vectors of both halves before it computes. The loads and stores are
// streaming (evict-first): no byte is read twice. Four blocks of 256 threads
// an SM: on an H100 80GB HBM3 at 700 W eight read 75 % of the bound, four
// 85 % (as many as eight with exp and the division as fast intrinsics).
// silu is computed as torch's float kernel computes it (expf, then an IEEE
// division, then the product), so the kernel and its plain version agree
// bit for bit where both round the same float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 2;  // vectors of each half a thread has in flight

__device__ __forceinline__ float silu_mul(float a, float b) {
  return a / (1.0f + expf(-a)) * b;
}

// 8 bf16 of a and b → 8 bf16 of out
__device__ __forceinline__ uint4 gate(uint4 a, uint4 b, __nv_bfloat16) {
  uint4 out;
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    po[i] = __floats2bfloat162_rn(silu_mul(fa.x, fb.x), silu_mul(fa.y, fb.y));
  }
  return out;
}

// 4 f32 of a and b → 4 f32 of out
__device__ __forceinline__ uint4 gate(uint4 a, uint4 b, float) {
  uint4 out;
  const float* pa = reinterpret_cast<const float*>(&a);
  const float* pb = reinterpret_cast<const float*>(&b);
  float* po = reinterpret_cast<float*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) po[i] = silu_mul(pa[i], pb[i]);
  return out;
}

// in: (rows, 2 * vecs) 16-byte vectors; out: (rows, vecs)
template <typename T>
__global__ void __launch_bounds__(kThreads) swiglu_kernel(const uint4* __restrict__ in,
                                                          uint4* __restrict__ out, int rows,
                                                          int vecs) {
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint4* a = in + int64_t(r) * 2 * vecs;
    const uint4* b = a + vecs;
    uint4* o = out + int64_t(r) * vecs;
    for (int c0 = threadIdx.x; c0 < vecs; c0 += kThreads * kUnroll) {
      uint4 va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = c0 + k * kThreads;
        if (c < vecs) {
          va[k] = __ldcs(a + c);
          vb[k] = __ldcs(b + c);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = c0 + k * kThreads;
        if (c < vecs) __stcs(o + c, gate(va[k], vb[k], T()));
      }
    }
  }
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

}  // namespace

// in: (rows, 2h) contiguous, 16-byte aligned; out: (rows, h) contiguous,
// 16-byte aligned; elem_bytes 2 (bf16) or 4 (f32); h a multiple of the
// elements in 16 bytes (the wrapper checks all of it).
extern "C" int dh_swiglu(int device, const void* in, void* out, int rows, int h, int elem_bytes,
                         void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if ((elem_bytes != 2 && elem_bytes != 4) || (h * elem_bytes) % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(in) & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (rows <= 0 || h <= 0) return cudaGetLastError();
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int grid = rows < sms * kBlocksPerSm ? rows : sms * kBlocksPerSm;
  const int vecs = h * elem_bytes / 16;
  auto s = static_cast<cudaStream_t>(stream);
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  if (elem_bytes == 2) {
    swiglu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(src, dst, rows, vecs);
  } else {
    swiglu_kernel<float><<<grid, kThreads, 0, s>>>(src, dst, rows, vecs);
  }
  return cudaGetLastError();
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
