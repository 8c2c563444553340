// K6: int8 convolution with its per-output-channel f32 epilogue.
//
// Replaces the inner convs of deephisto_tpu/models/quantize.py:
// QuantizedResNet.apply, conv_s32 / conv_f32 / conv_to_int8 (:460-481), which
// XLA lowered on the TPU (ROADMAP item B3). PyTorch's CUDA build has no
// s8 x s8 -> s32 convolution. With y the s32 sum of an NHWC s8 input and a
// (Cout, KH, KW, Cin) s8 kernel at stride s and explicit pads (top, left; the
// bottom and right pads are implied by the output extent the wrapper gives):
//   f32 mode:  out[m, c] = y[m, c] * a[c] + b[c]                      (conv_f32)
//   int8 mode: out[m, c] = int8(min(rint(max(y[m, c] * a[c] + b[c], 0)), 127))
//                                                               (conv_to_int8)
// with the s32 sum rounded to f32 to nearest (__int2float_rn, as XLA's
// convert), the product and the sum rounded each on its own (__fmul_rn,
// __fadd_rn: nvcc would contract a*b + c to one FMA, which the JAX program
// does not do) and rint half to even (__float2int_rn, as jnp.round). So the
// kernel is bit-equal to its plain PyTorch version (ops/conv_int8.py).
//
// Bound: operations. A ResNet-18 conv at the patch shape, (256, 56, 56, 64) x
// (3, 3, 64, 64), is a GEMM of M = 802,816 output pixels, N = 64 channels and
// K = 576 taps: 59.2 G operations (2 a multiply-add), 29.9 us at the dense
// int8 tensor-core peak of 1,979 TOP/s, while its 51 MB of input and 51 MB
// (int8) or 206 MB (f32) of output take 30-77 us at 3.35 TB/s, so the larger
// layers are bound by bytes at this card's int8 rate.
//
// Design: a simple implicit GEMM, right first (a wgmma + TMA redesign is
// queued). A block computes a 128 x 64 tile of (output pixel, channel) with
// four warps of 64 x 32, each on mma.sync.m16n8k32 s8 x s8 -> s32. The A
// tile (128 pixels x 64 taps) is gathered from the NHWC input on the fly:
// with Cin a multiple of 16, 16 consecutive taps share one (kh, kw) and are
// 16 contiguous bytes, so one cp.async of 16 bytes, zero-filled where the
// pixel falls in the padding, moves each; the B tile (64 channels x 64 taps)
// is 16-byte rows of the kernel. Three stages of cp.async keep two tiles in
// flight; shared rows are padded to 80 bytes so that the fragment loads hit
// 32 distinct banks. Other Cin (the imagenet stem's 3) take a byte-wise
// gather into the same tiles. The epilogue reads the per-channel constants
// once per thread and writes two neighbouring channels per store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kLd = kBK + 16;  // padded shared row, bytes
constexpr int kStages = 3;
constexpr int kThreads = 128;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* a;
  const float* b;
  void* out;
  int n, h, w_in, cin, cout, kh, kw, stride, pad_top, pad_left, oh, ow;
  int64_t m;  // n * oh * ow
  int k;      // kh * kw * cin
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The output pixel a thread gathers for its A row: image base and the input
// row and column of tap (0, 0), or valid = false past the last pixel.
struct Row {
  const int8_t* base;
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ Row make_row(const Params& p, int64_t m) {
  Row r;
  r.valid = m < p.m;
  const int64_t mm = r.valid ? m : 0;
  const int64_t per_img = int64_t(p.oh) * p.ow;
  const int64_t img = mm / per_img;
  const int rem = int(mm - img * per_img);
  const int oh = rem / p.ow, ow = rem - (rem / p.ow) * p.ow;
  r.base = p.x + img * p.h * int64_t(p.w_in) * p.cin;
  r.ih0 = oh * p.stride - p.pad_top;
  r.iw0 = ow * p.stride - p.pad_left;
  return r;
}

// One k tile into shared stage (sa, sb). VEC: Cin % 16 == 0, 16-byte aligned
// x and w (then K % 16 == 0 and each 16-tap chunk is one pixel's bytes).
template <bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, const Row& row, int64_t n0, int k0,
                                          int8_t (*sa)[kLd], int8_t (*sb)[kLd]) {
  const int t = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      const int k = k0 + c * 16;
      const int tap = k / p.cin;
      const int ci = k - tap * p.cin;
      const int r = tap / p.kw;
      const int ih = row.ih0 + r, iw = row.iw0 + (tap - r * p.kw);
      const bool ok = row.valid && k < p.k && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in;
      const int8_t* src = ok ? row.base + (int64_t(ih) * p.w_in + iw) * p.cin + ci : p.x;
      cp_async16(&sa[t][c * 16], src, ok);
    }
    const int co_l = t >> 1;
    const int64_t co = n0 + co_l;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = (t & 1) * 2 + j;
      const int k = k0 + c * 16;
      const bool ok = co < p.cout && k < p.k;
      cp_async16(&sb[co_l][c * 16], ok ? p.w + co * p.k + k : p.w, ok);
    }
  } else {
    int k = k0;
    int tap = k / p.cin;
    int ci = k - tap * p.cin;
    for (int j = 0; j < kBK; ++j, ++k) {
      int8_t v = 0;
      if (row.valid && k < p.k) {
        const int r = tap / p.kw;
        const int ih = row.ih0 + r, iw = row.iw0 + (tap - r * p.kw);
        if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_in) {
          v = row.base[(int64_t(ih) * p.w_in + iw) * p.cin + ci];
        }
      }
      sa[t][j] = v;
      if (++ci == p.cin) {
        ci = 0;
        ++tap;
      }
    }
    const int co_l = t >> 1;
    const int64_t co = n0 + co_l;
    for (int j = 0; j < kBK / 2; ++j) {
      const int kk = (t & 1) * (kBK / 2) + j;
      const int kg = k0 + kk;
      sb[co_l][kk] = (co < p.cout && kg < p.k) ? p.w[co * p.k + kg] : int8_t(0);
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool VEC, bool TO_INT8>
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(const Params p) {
  __shared__ __align__(16) int8_t sa[kStages][kBM][kLd];
  __shared__ __align__(16) int8_t sb[kStages][kBN][kLd];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 2 x 2 warps of 64 x 32
  const int g = lane >> 2, q = lane & 3;     // mma fragment row group, column quad
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int64_t n0 = int64_t(blockIdx.y) * kBN;
  const Row row = make_row(p, m0 + t);

  int32_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int ktiles = (p.k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile<VEC>(p, row, n0, s * kBK, sa[s], sb[s]);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in, and every warp is done with tile kt - 1
    const int nt = kt + kStages - 1;
    if (nt < ktiles) load_tile<VEC>(p, row, n0, nt * kBK, sa[nt % kStages], sb[nt % kStages]);
    cp_async_commit();
    const int s = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + g;
        af[i][0] = lds32(&sa[s][r][kk + q * 4]);
        af[i][1] = lds32(&sa[s][r + 8][kk + q * 4]);
        af[i][2] = lds32(&sa[s][r][kk + 16 + q * 4]);
        af[i][3] = lds32(&sa[s][r + 8][kk + 16 + q * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + g;
        bf[j][0] = lds32(&sb[s][c][kk + q * 4]);
        bf[j][1] = lds32(&sb[s][c][kk + 16 + q * 4]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: rows m0 + wm*64 + i*16 + g (+ 8), channels n0 + wn*32 + j*8 + 2q (+ 1)
  float ea[4][2], eb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t co = n0 + wn * 32 + j * 8 + 2 * q + e;
      ea[j][e] = co < p.cout ? p.a[co] : 0.f;
      eb[j][e] = co < p.cout ? p.b[co] : 0.f;
    }
  const bool pair = (p.cout & 1) == 0;  // two channels per store stay aligned
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * 64 + i * 16 + g + h * 8;
      if (m >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t co = n0 + wn * 32 + j * 8 + 2 * q;
        if (co >= p.cout) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), ea[j][e]), eb[j][e]);
        }
        const int64_t o = m * p.cout + co;
        if (TO_INT8) {
          int8_t r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            r[e] = int8_t(min(max(__float2int_rn(fmaxf(v[e], 0.f)), -127), 127));
          }
          int8_t* out = static_cast<int8_t*>(p.out);
          if (pair) {
            *reinterpret_cast<char2*>(out + o) = make_char2(r[0], r[1]);
          } else {
            out[o] = r[0];
            if (co + 1 < p.cout) out[o + 1] = r[1];
          }
        } else {
          float* out = static_cast<float*>(p.out);
          if (pair) {
            *reinterpret_cast<float2*>(out + o) = make_float2(v[0], v[1]);
          } else {
            out[o] = v[0];
            if (co + 1 < p.cout) out[o + 1] = v[1];
          }
        }
      }
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

template <bool VEC>
void launch(const Params& p, bool to_int8, cudaStream_t stream) {
  const dim3 grid(unsigned((p.m + kBM - 1) / kBM), unsigned((p.cout + kBN - 1) / kBN));
  if (to_int8) {
    conv_int8_kernel<VEC, true><<<grid, kThreads, 0, stream>>>(p);
  } else {
    conv_int8_kernel<VEC, false><<<grid, kThreads, 0, stream>>>(p);
  }
}

}  // namespace

// x: (n, h, w, cin) int8 contiguous; w: (cout, kh, kw, cin) int8 contiguous;
// a, b: (cout,) f32; out: (n, oh, ow, cout) f32 (to_int8 = 0) or int8
// (to_int8 = 1), contiguous. pad_top/pad_left: the leading pads of XLA's
// explicit padding; oh, ow: the output extents (the wrapper checks them).
extern "C" int dh_conv_int8(int device, const void* x, int n, int h, int w_in, int cin,
                            const void* w, int cout, int kh, int kw, int stride, int pad_top,
                            int pad_left, int oh, int ow, const void* a, const void* b,
                            int to_int8, void* out, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (n <= 0 || oh <= 0 || ow <= 0 || cout <= 0) return cudaGetLastError();
  if (stride < 1 || cin < 1 || kh < 1 || kw < 1) return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = out;
  p.n = n, p.h = h, p.w_in = w_in, p.cin = cin, p.cout = cout, p.kh = kh, p.kw = kw;
  p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left, p.oh = oh, p.ow = ow;
  p.m = int64_t(n) * oh * ow;
  p.k = kh * kw * cin;
  if ((p.m + kBM - 1) / kBM > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    launch<true>(p, to_int8 != 0, s);
  } else {
    launch<false>(p, to_int8 != 0, s);
  }
  return cudaGetLastError();
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
