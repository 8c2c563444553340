// K6: int8 convolution with its per-output-channel f32 epilogue, and the
// ResNet block's epilogue fused into it.
//
// Replaces the inner convs of deephisto_tpu/models/quantize.py:
// QuantizedResNet.apply, conv_s32 / conv_f32 / conv_to_int8 (:460-481), which
// XLA lowered on the TPU (ROADMAP item B3), and the residual add, relu, bf16
// carry and requant that follow a block's last conv (:669-684; the s2d stem's
// relu, :530), which XLA fused into that conv there. PyTorch's CUDA build has
// no s8 x s8 -> s32 convolution. With acc the s32 sum of an NHWC s8 input and
// a (Cout, KH, KW, Cin) s8 kernel at stride s and explicit pads (top, left;
// the bottom and right pads are implied by the output extent the wrapper
// gives), per output element (m, c) and y = acc * a[c] + b[c]:
//   f32 mode:   out = y                                          (conv_f32)
//   int8 mode:  out = int8(clip(rint(relu(y)), +-127))           (conv_to_int8)
//   block mode: o = relu(y + r), r the residual, one of
//                 none (no add: the s2d stem), bf16 (the carry, converted),
//                 f32 (the downsample conv's output), int8 (res8 * s_in);
//               then the outputs, one of
//                 carry: bf16(o) and int8(clip(rint(f32(bf16(o)) * next_inv)))
//                 int8:  int8(clip(rint(o * next_inv)))
//                 f32:   o                       (a block whose output is kept)
// with the s32 sum rounded to f32 to nearest (__int2float_rn, as XLA's
// convert), every product and sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc would contract a*b + c to one FMA, which the JAX program does not do)
// and rint half to even (__float2int_rn, as jnp.round). So the kernel is
// bit-equal to its plain PyTorch version (ops/conv_int8.py). Every scale
// (a, b, s_in, next_inv) is read from device memory: no host sync.
//
// Bound: operations on the deep layers, bytes on the wide ones. A ResNet-18
// conv at the patch shape, (256, 56, 56, 64) x (3, 3, 64, 64), is a GEMM of
// M = 802,816 output pixels, N = 64 channels and K = 576 taps: 59.2 G
// operations (2 a multiply-add), 29.9 us at the dense int8 tensor-core peak
// of 1,979 TOP/s; its 51 MB of input and, fused, the bf16 residual read and
// the bf16 carry and int8 input written (5 bytes an element, 257 MB in all)
// take 77 us at 3.35 TB/s.
//
// Designs, chosen per conv by ops/conv_int8.py:conv_design (the one place)
// and passed in; a design with no kernel for the conv is refused, never
// replaced:
//
// - wgmma (Cin % 64 == 0: every conv of a ResNet block and its downsample):
//   a persistent grid, one block of three warpgroups an SM, walks tiles of
//   128 output pixels x BN channels (BN 64 at Cout <= 64, else 128; the
//   channel tiles of one pixel tile are neighbours in the walk, so its A is
//   read from device memory once). The producer warpgroup gives up its
//   registers (setmaxnreg) and one of its threads issues every copy into a
//   ring of (A, B) stages, full and empty mbarriers between it and the
//   consumers: A by TMA's im2col mode, one box a (kh, kw) tap and KB
//   channels: the 128 pixels of the tile, wrapping across rows and images,
//   the stride taken as the traversal step and the pads and the pixels past
//   M zero-filled as out of bounds; B as an ordinary KB x BN box of the
//   (Cout, K) kernel. im2col over the tiled alternative (a box a tap over
//   whole output rows): a tile of any 128 pixels, with no waste at the
//   56-, 28-, 14- and 7-pixel rows of the patch path or at the fcn tile's
//   288. Both operands are K-major, the only form 8-bit wgmma takes, in the
//   swizzled layout whose row is KB bytes: 128 (flash_common.cuh's, the
//   byte geometry of K3-K5's bf16 tiles) at Cin % 128 == 0, 64 at Cin 64,
//   where one tap's channels fill 64 bytes and a 128-byte row would take
//   two taps, which one im2col box cannot. A k32 step moves 32 bytes along
//   the row. The two consumer warpgroups take whole tiles in turn
//   (ping-pong): each issues wgmma.mma_async m64nBNk32 s32.s8.s8 for two
//   m64 halves, and its epilogue runs beside the other's products; a named
//   barrier hands the ring from one to the other at each tile, so neither
//   waits on a stage a phase ahead of its last reading. Measured on the
//   H100 (PERF.md): these beat two warpgroups sharing each tile (1.12x),
//   one consumer warpgroup (1.19x over that), 64-byte rows everywhere
//   (1.06x) and a cp.async ring filled by all threads (1.45x). No branch
//   sits beside the wgmma chain (C7520): each tile's first stage release
//   goes to a spare barrier by a select. Waits trap after 4 s, so a copy
//   that never lands faults the launch instead of hanging the card.
// - mma.sync (other Cin: the s2d stem's 48 and the imagenet stem's 3): the
//   first design of K6, a 128 x 64 tile of four warps of 64 x 32 on
//   mma.sync.m16n8k32 s8, a 3-stage cp.async ring of 16-byte chunks (Cin %
//   16 == 0, shared rows padded to 80 bytes) or a byte-wise gather (other
//   Cin).
//
// The epilogue is one function (store_tile) that both designs call: a tile's
// s32 sums go through shared memory (64 channels at a time in the wgmma
// design), and each thread then takes 16 channels of one pixel, reads their
// constants and residual and writes each output as 16-byte stores (Cout % 16
// == 0, aligned; element-wise at other Cout).

#include "flash_common.cuh"

namespace {

using flash::align1024;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::DeviceGuard;
using flash::mbar_arrive;
using flash::mbar_arrive_expect_tx;
using flash::mbar_fence_init;
using flash::mbar_init;
using flash::named_barrier;
using flash::setmaxnreg_dec;
using flash::setmaxnreg_inc;
using flash::smem_addr;
using flash::sw128_desc_k;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_wait;

// codes of ops/conv_int8.py:DESIGNS, MODES, RES_KINDS and OUT_KINDS
enum Design : int { kMmaSync = 1, kWgmma = 2 };
enum Mode : int { kModeF32 = 0, kModeInt8 = 1, kModeBlock = 2 };
enum Res : int { kResNone = 0, kResBf16 = 1, kResF32 = 2, kResInt8 = 3 };
enum Out : int { kOutCarry = 0, kOutInt8 = 1, kOutF32 = 2 };

struct Conv {
  const int8_t* x;
  const int8_t* w;
  int n, h, w_in, cin, cout, kh, kw, stride, pad_top, pad_left, oh, ow;
  int64_t m;  // n * oh * ow
  int k;      // kh * kw * cin
};

struct Epi {
  const float* a;
  const float* b;
  int mode, res_kind, out_kind;
  const void* res;         // (m, cout) residual, block mode
  const float* res_scale;  // s_in of an int8 residual
  const float* next_inv;   // the next conv's input scale (carry, int8 outputs)
  void* out;               // f32, int8 or the bf16 carry
  void* out2;              // the int8 input beside the carry
  int cout;
  int64_t m;
  bool vec;  // Cout % 16 == 0 and every pointer above 16-byte aligned
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// ---- the epilogue, shared by both designs ------------------------------------

union V16 {  // 16 channels of 4 bytes
  int4 q[4];
  int32_t i[16];
  float f[16];
};
union H16 {  // 16 channels of bf16, as their bits
  int4 q[2];
  uint16_t u[16];
};
union B16 {  // 16 channels of int8
  int4 q;
  int8_t c[16];
};

__device__ __forceinline__ int8_t requant(float v) {
  return int8_t(min(max(__float2int_rn(v), -127), 127));
}

// The 16 channels co.. of output pixel m, from their s32 sums s (shared
// memory, 16-byte aligned); channels >= cout are neither read nor written.
__device__ __forceinline__ void epi_chunk(const Epi& e, const int32_t* s, int64_t m, int co) {
  const bool vec = e.vec;
  const int nv = vec ? 16 : min(16, e.cout - co);
  const int64_t o = m * e.cout + co;
  V16 y, a, b;
  if (vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y.q[i] = reinterpret_cast<const int4*>(s)[i];
      a.q[i] = __ldg(reinterpret_cast<const int4*>(e.a + co) + i);
      b.q[i] = __ldg(reinterpret_cast<const int4*>(e.b + co) + i);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      y.i[j] = j < nv ? s[j] : 0;
      a.f[j] = j < nv ? e.a[co + j] : 0.f;
      b.f[j] = j < nv ? e.b[co + j] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    y.f[j] = __fadd_rn(__fmul_rn(__int2float_rn(y.i[j]), a.f[j]), b.f[j]);

  if (e.mode == kModeBlock) {  // o = relu(y + r)
    if (e.res_kind != kResNone) {
      V16 r;
      if (e.res_kind == kResF32) {
        const float* src = static_cast<const float*>(e.res) + o;
        if (vec) {
#pragma unroll
          for (int i = 0; i < 4; ++i) r.q[i] = reinterpret_cast<const int4*>(src)[i];
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) r.f[j] = j < nv ? src[j] : 0.f;
        }
      } else if (e.res_kind == kResBf16) {
        const uint16_t* src = static_cast<const uint16_t*>(e.res) + o;
        H16 h;
        if (vec) {
          h.q[0] = reinterpret_cast<const int4*>(src)[0];
          h.q[1] = reinterpret_cast<const int4*>(src)[1];
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) h.u[j] = j < nv ? src[j] : uint16_t(0);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) r.f[j] = __bfloat162float(__ushort_as_bfloat16(h.u[j]));
      } else {  // kResInt8: res8 * s_in
        const int8_t* src = static_cast<const int8_t*>(e.res) + o;
        B16 c;
        if (vec) {
          c.q = *reinterpret_cast<const int4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) c.c[j] = j < nv ? src[j] : int8_t(0);
        }
        const float s_in = *e.res_scale;
#pragma unroll
        for (int j = 0; j < 16; ++j) r.f[j] = __fmul_rn(__int2float_rn(c.c[j]), s_in);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) y.f[j] = __fadd_rn(y.f[j], r.f[j]);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) y.f[j] = fmaxf(y.f[j], 0.f);
  }

  if (e.mode == kModeF32 || (e.mode == kModeBlock && e.out_kind == kOutF32)) {
    float* dst = static_cast<float*>(e.out) + o;
    if (vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) reinterpret_cast<int4*>(dst)[i] = y.q[i];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < nv) dst[j] = y.f[j];
    }
    return;
  }
  B16 x8;
  int8_t* dst8;
  if (e.mode == kModeInt8) {
#pragma unroll
    for (int j = 0; j < 16; ++j) x8.c[j] = requant(fmaxf(y.f[j], 0.f));
    dst8 = static_cast<int8_t*>(e.out) + o;
  } else if (e.out_kind == kOutInt8) {
    const float inv = *e.next_inv;
#pragma unroll
    for (int j = 0; j < 16; ++j) x8.c[j] = requant(__fmul_rn(y.f[j], inv));
    dst8 = static_cast<int8_t*>(e.out) + o;
  } else {  // the carry and the next conv's input
    const float inv = *e.next_inv;
    H16 carry;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const __nv_bfloat16 h = __float2bfloat16_rn(y.f[j]);
      carry.u[j] = __bfloat16_as_ushort(h);
      x8.c[j] = requant(__fmul_rn(__bfloat162float(h), inv));
    }
    uint16_t* dst = static_cast<uint16_t*>(e.out) + o;
    if (vec) {
      reinterpret_cast<int4*>(dst)[0] = carry.q[0];
      reinterpret_cast<int4*>(dst)[1] = carry.q[1];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j < nv) dst[j] = carry.u[j];
    }
    dst8 = static_cast<int8_t*>(e.out2) + o;
  }
  if (vec) {
    *reinterpret_cast<int4*>(dst8) = x8.q;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < nv) dst8[j] = x8.c[j];
  }
}

// The epilogue of a BM x BN tile of s32 sums in shared memory (rows of ld
// int32, 16-byte aligned) at output pixel m0 and channel n0, by nthreads
// threads: each takes 16 channels of one pixel, neighbouring threads
// neighbouring channels.
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const Epi& e, const int32_t* sacc, int ld, int64_t m0,
                                           int n0, int tid, int nthreads) {
  constexpr int kChunks = BN / 16;
  for (int i = tid; i < BM * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const int64_t m = m0 + r;
    if (m < e.m && n0 + c < e.cout) epi_chunk(e, sacc + r * ld + c, m, n0 + c);
  }
}

// The output pixel a thread gathers for its A row: image base and the input
// row and column of tap (0, 0), or valid = false past the last pixel.
struct Row {
  const int8_t* base;
  int ih0, iw0;
  bool valid;
};

__device__ __forceinline__ Row make_row(const Conv& p, int64_t m) {
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

// ---- mma.sync: Cin % 64 != 0 ---------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kLd = kBK + 16;  // padded shared row, bytes
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kAccLd = kBN + 8;  // int32 row of the staged sums
static_assert(kBM * kAccLd * 4 <= kStages * (kBM + kBN) * kLd, "staged sums fit the ring");

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k tile into shared stage (sa, sb). VEC: Cin % 16 == 0, 16-byte aligned
// x and w (then K % 16 == 0 and each 16-tap chunk is one pixel's bytes).
template <bool VEC>
__device__ __forceinline__ void load_tile(const Conv& p, const Row& row, int64_t n0, int k0,
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
      cp_async16(smem_addr(&sa[t][c * 16]), src, ok ? 16 : 0);
    }
    const int co_l = t >> 1;
    const int64_t co = n0 + co_l;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = (t & 1) * 2 + j;
      const int k = k0 + c * 16;
      const bool ok = co < p.cout && k < p.k;
      cp_async16(smem_addr(&sb[co_l][c * 16]), ok ? p.w + co * p.k + k : p.w, ok ? 16 : 0);
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

template <bool VEC>
__global__ void __launch_bounds__(kThreads) conv_int8_mma(const Conv p, const Epi e) {
  __shared__ __align__(16) int8_t smem[kStages * (kBM + kBN) * kLd];
  auto sa = reinterpret_cast<int8_t(*)[kBM][kLd]>(smem);
  auto sb = reinterpret_cast<int8_t(*)[kBN][kLd]>(smem + kStages * kBM * kLd);

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
  __syncthreads();  // the ring is free: stage the sums there

  // sums of rows wm*64 + i*16 + g (+ 8), channels wn*32 + j*8 + 2q (+ 1)
  int32_t* sacc = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + i * 16 + g + h * 8, c = wn * 32 + j * 8 + 2 * q;
        *reinterpret_cast<int2*>(&sacc[r * kAccLd + c]) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __syncthreads();
  store_tile<kBM, kBN>(e, sacc, kAccLd, m0, int(n0), t, kThreads);
}

// ---- wgmma fed by TMA: Cin % 64 == 0 ----------------------------------------------

constexpr int kWgBM = 128;          // output pixels a tile: two m64 products
constexpr int kWgThreads = 3 * 128;  // a producer and two consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128·40 + 256·232 <= 65,536
constexpr int kSliceLd = 64 + 8;    // int32 row of one staged 64-channel slice of sums
constexpr int kSliceBytes = kWgBM * kSliceLd * 4;
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may have

// BN output channels a tile; KB taps a stage, one swizzled row of K-major s8:
// 128 bytes (SWIZZLE_128B) at Cin % 128 == 0, 64 (SWIZZLE_64B) at Cin 64.
template <int BN, int KB>
struct TmaTile {
  static constexpr int kABytes = kWgBM * KB;
  static constexpr int kStageBytes = kABytes + BN * KB;
  static constexpr int kFixed = 1024 + 2 * kSliceBytes + 8 * 17;  // slack, slices, barriers
  static constexpr int kFit = (kSmemMax - kFixed) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem = kFixed + size_t(kStages) * kStageBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
};

struct ConvMaps {  // A: im2col over the (N, H, W, Cin) input; B: the (Cout, K) kernel
  CUtensorMap a, b;
};

#define K6_ROW(d, t) "+r"(d[t][0]), "+r"(d[t][1]), "+r"(d[t][2]), "+r"(d[t][3])
#define K6_ROWS8(d, t)                                                                 \
  K6_ROW(d, t), K6_ROW(d, t + 1), K6_ROW(d, t + 2), K6_ROW(d, t + 3), K6_ROW(d, t + 4), \
      K6_ROW(d, t + 5), K6_ROW(d, t + 6), K6_ROW(d, t + 7)

// d += A·B over one 32-deep step: A (64 × 32) and B (32 × BN), s8, both
// K-major in swizzled shared memory (descriptors a, b), s32 accumulators in
// the m16n8 layout (d[t]: column tile t of 8).
template <int BN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[BN / 8][4], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int32_t (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : K6_ROWS8(d, 0)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int32_t (&d)[16][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : K6_ROWS8(d, 0), K6_ROWS8(d, 8)
      : "l"(a), "l"(b), "r"(1));
}

// Pins the accumulators here: no read or write of them crosses a wgmma_wait.
template <int BN>
__device__ __forceinline__ void fence_acc(int32_t (&d)[BN / 8][4]) {
#pragma unroll
  for (int t = 0; t < BN / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[t][e])::"memory");
}

// The descriptor of a K-major operand whose rows are KB bytes in the KB-byte
// swizzled layout: 8-row groups 8·KB bytes apart; a k32 step adds 32 bytes
// (2 in the descriptor's 16-byte units).
template <int KB>
__device__ __forceinline__ uint64_t desc_k(uint32_t saddr) {
  if constexpr (KB == 128) {
    return sw128_desc_k(saddr);
  } else {
    return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) |
           (uint64_t(2) << 62);
  }
}

__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const void* map, int c, int w, int h,
                                                int n, uint16_t off_w, uint16_t off_h,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::"r"(dst),
      "l"(map), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar), "h"(off_w), "h"(off_h)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// mbarrier wait that traps after 4 s: a copy that never lands faults the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\nmov.u64 t0, %%globaltimer;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\nsub.u64 t1, t1, t0;\nsetp.lt.u64 p, t1, 4000000000;\n"
      "@p bra LAB_WAIT;\ntrap;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Signals a named barrier of `threads` threads without waiting on it.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int BN, int KB>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv_int8_wgmma(const __grid_constant__ ConvMaps maps, const Conv p, const Epi e) {
  using T = TmaTile<BN, KB>;
  constexpr int kS = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = align1024(raw);
  const uint32_t slices = base + kS * T::kStageBytes;  // a staging slice per consumer
  const uint32_t full_bar = slices + 2 * kSliceBytes, empty_bar = full_bar + 8 * kS,
                 spare_bar = empty_bar + 8 * kS;  // takes each tile's first no-op release

  const int ntn = (p.cout + BN - 1) / BN;
  const int64_t tiles = (p.m + kWgBM - 1) / kWgBM * ntn;
  const int ktiles = p.k / KB;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128);
    }
    mbar_init(spare_bar, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (t < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (t == 0) {  // one thread issues every copy, tile after tile
      const int64_t per_img = int64_t(p.oh) * p.ow;
      uint32_t it = 0;
      for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t m0 = tile / ntn * kWgBM;
        const int n0 = int(tile % ntn) * BN;
        const int img = int(m0 / per_img);
        const int rem = int(m0 - img * per_img);
        const int oh = rem / p.ow, ow = rem - (rem / p.ow) * p.ow;
        const int w0 = ow * p.stride - p.pad_left, h0 = oh * p.stride - p.pad_top;
        int ci = 0, r = 0, s = 0;  // tap (r, s), channels ci.. of k tile kt
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const uint32_t st = it % kS;
          if (it >= kS) mbar_wait_or_trap(empty_bar + 8 * st, (it / kS - 1) & 1);
          const uint32_t dst = base + st * T::kStageBytes, bar = full_bar + 8 * st;
          mbar_arrive_expect_tx(bar, T::kStageBytes);
          tma_load_im2col(dst, &maps.a, ci, w0, h0, img, uint16_t(s), uint16_t(r), bar);
          tma_load_2d(dst + T::kABytes, &maps.b, kt * KB, n0, bar);
          ci += KB;
          if (ci == p.cin) {
            ci = 0;
            if (++s == p.kw) {
              s = 0;
              ++r;
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = (t - 128) / 128, tt = t % 128;  // consumer warpgroup, its thread
    int32_t* sacc = reinterpret_cast<int32_t*>(smem_raw + (slices - raw)) + wg * (kSliceBytes / 4);
    const int lane = tt & 31, r0 = (tt / 32) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
    for (int64_t j = wg;; j += 2) {  // this block's tiles j, j + 2, ...
      const int64_t tile = blockIdx.x + j * gridDim.x;
      if (tile >= tiles) break;
      const int64_t m0 = tile / ntn * kWgBM;
      const int n0 = int(tile % ntn) * BN;
      uint32_t it = uint32_t(j) * ktiles;
      // the other warpgroup has waited on every stage of tile j - 1, so no
      // stage this tile waits on is a phase ahead of its last reading
      if (j > 0) named_barrier(3 + wg, 256);
      int32_t acc[2][BN / 8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          acc[mi][i][0] = acc[mi][i][1] = acc[mi][i][2] = acc[mi][i][3] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const uint32_t st = it % kS;
        mbar_wait_or_trap(full_bar + 8 * st, (it / kS) & 1);
        const uint32_t sb = base + st * T::kStageBytes;
        const uint64_t db = desc_k<KB>(sb + T::kABytes);
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint64_t da = desc_k<KB>(sb + mi * 64 * KB);
#pragma unroll
          for (int kk = 0; kk < KB / 32; ++kk) wgmma_s8<BN>(acc[mi], da + 2 * kk, db + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: free it
        fence_acc<BN>(acc[0]);
        fence_acc<BN>(acc[1]);
        mbar_arrive(kt > 0 ? empty_bar + 8 * ((it + kS - 1) % kS) : spare_bar);
      }
      wgmma_wait<0>();
      fence_acc<BN>(acc[0]);
      fence_acc<BN>(acc[1]);
      mbar_arrive(empty_bar + 8 * ((it + kS - 1) % kS));
      if (tile + gridDim.x < tiles) named_barrier_arrive(4 - wg, 256);  // tile j + 1 may start
      // the epilogue, 64 channels at a time: stage the sums of rows r0 +
      // 64·mi (+ 8) of this thread's fragments, then store_tile
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int r = r0 + mi * 64, c = jj * 8 + c0;
            *reinterpret_cast<int2*>(&sacc[r * kSliceLd + c]) =
                make_int2(acc[mi][h * 8 + jj][0], acc[mi][h * 8 + jj][1]);
            *reinterpret_cast<int2*>(&sacc[(r + 8) * kSliceLd + c]) =
                make_int2(acc[mi][h * 8 + jj][2], acc[mi][h * 8 + jj][3]);
          }
        named_barrier(1 + wg, 128);
        store_tile<kWgBM, 64>(e, sacc, kSliceLd, m0, n0 + 64 * h, tt, 128);
        named_barrier(1 + wg, 128);  // the slice is read before the next one is written
      }
    }
  }
}

// The TMA maps of a conv (host code): A, im2col over {Cin, W, H, N} with the
// bounding box of the window starts (lower corner -pad, upper corner
// pad_hi - (k - 1), stepping by the stride), KB channels x 128 pixels a box;
// B, {K, Cout} tiles of KB x BN. Both KB-byte swizzled. The encoders are
// looked up through the runtime, so the library links no libcuda.
cudaError_t encode_conv_maps(ConvMaps* maps, const Conv& p, int bn, int kb) {
  static PFN_cuTensorMapEncodeTiled_v12000 tiled = nullptr;
  static PFN_cuTensorMapEncodeIm2col_v12000 im2col = nullptr;
  if (tiled == nullptr || im2col == nullptr) {
    void* fn[2] = {nullptr, nullptr};
    const char* names[2] = {"cuTensorMapEncodeTiled", "cuTensorMapEncodeIm2col"};
    for (int i = 0; i < 2; ++i) {
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err = cudaGetDriverEntryPoint(names[i], &fn[i], cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || fn[i] == nullptr) return cudaErrorSymbolNotFound;
    }
    tiled = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn[0]);
    im2col = reinterpret_cast<PFN_cuTensorMapEncodeIm2col_v12000>(fn[1]);
  }
  const auto swizzle = kb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int pad_bottom = (p.oh - 1) * p.stride + p.kh - p.h - p.pad_top;
  const int pad_right = (p.ow - 1) * p.stride + p.kw - p.w_in - p.pad_left;
  const int lower[2] = {-p.pad_left, -p.pad_top};  // {W, H}
  const int upper[2] = {pad_right - (p.kw - 1), pad_bottom - (p.kh - 1)};
  for (int i = 0; i < 2; ++i)
    if (lower[i] < -128 || lower[i] > 127 || upper[i] < -128 || upper[i] > 127)
      return cudaErrorInvalidValue;
  const cuuint64_t adims[4] = {cuuint64_t(p.cin), cuuint64_t(p.w_in), cuuint64_t(p.h),
                               cuuint64_t(p.n)};
  const cuuint64_t astrides[3] = {cuuint64_t(p.cin), cuuint64_t(p.w_in) * p.cin,
                                  cuuint64_t(p.h) * p.w_in * p.cin};
  const cuuint32_t aelem[4] = {1, cuuint32_t(p.stride), cuuint32_t(p.stride), 1};
  CUresult r = im2col(&maps->a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.x), adims,
                      astrides, lower, upper, kb, kWgBM, aelem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t bdims[2] = {cuuint64_t(p.k), cuuint64_t(p.cout)};
  const cuuint64_t bstrides[1] = {cuuint64_t(p.k)};
  const cuuint32_t box[2] = {cuuint32_t(kb), cuuint32_t(bn)}, belem[2] = {1, 1};
  r = tiled(&maps->b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.w), bdims, bstrides,
            box, belem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- launch ------------------------------------------------------------------

cudaError_t launch_mma(const Conv& p, const Epi& e, cudaStream_t st) {
  const int64_t mt = (p.m + kBM - 1) / kBM;
  if (mt > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(mt), unsigned((p.cout + kBN - 1) / kBN));
  const bool vec = p.cin % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  if (vec) {
    conv_int8_mma<true><<<grid, kThreads, 0, st>>>(p, e);
  } else {
    conv_int8_mma<false><<<grid, kThreads, 0, st>>>(p, e);
  }
  return cudaGetLastError();
}

// A persistent grid: one block an SM, at most one a tile.
template <int BN, int KB>
cudaError_t launch_wgmma(const Conv& p, const Epi& e, cudaStream_t st) {
  using T = TmaTile<BN, KB>;
  static int sms = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
  }
  ConvMaps maps;
  if ((err = encode_conv_maps(&maps, p, BN, KB)) != cudaSuccess) return err;
  const int64_t tiles = (p.m + kWgBM - 1) / kWgBM * ((p.cout + BN - 1) / BN);
  const unsigned grid = unsigned(tiles < sms ? tiles : sms);
  if ((err = cudaFuncSetAttribute(conv_int8_wgmma<BN, KB>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::kSmem))) !=
      cudaSuccess)
    return err;
  conv_int8_wgmma<BN, KB><<<grid, kWgThreads, T::kSmem, st>>>(maps, p, e);
  return cudaGetLastError();
}

// The wgmma kernel for a conv: BN 64 at Cout <= 64, else 128 (the channel
// tiles of one pixel tile are neighbours in the tile order, so its A is read
// from device memory once); KB 128 at Cin % 128 == 0, else 64.
cudaError_t launch_wgmma(const Conv& p, const Epi& e, cudaStream_t st) {
  const bool kb128 = p.cin % 128 == 0;
  if (p.cout <= 64) return kb128 ? launch_wgmma<64, 128>(p, e, st) : launch_wgmma<64, 64>(p, e, st);
  return kb128 ? launch_wgmma<128, 128>(p, e, st) : launch_wgmma<128, 64>(p, e, st);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// x: (n, h, w, cin) int8 contiguous; w: (cout, kh, kw, cin) int8 contiguous;
// a, b: (cout,) f32. pad_top/pad_left: the leading pads of XLA's explicit
// padding; oh, ow: the output extents (the wrapper checks them). design: 1
// mma.sync, 2 wgmma (Cin % 64 == 0, x and w 16-byte aligned), as
// ops/conv_int8.py:conv_design chooses it. mode: 0 f32 (out f32), 1 int8
// (out int8), 2 block: res_kind 0 none (res null), 1 bf16, 2 f32, 3 int8
// (res_scale: the f32 s_in on the card), res (n, oh, ow, cout) contiguous;
// out_kind 0 carry (out bf16, out2 int8), 1 int8 (out), 2 f32 (out), with
// next_inv the f32 scale of the int8 output on the card. Any other code, or a
// pointer missing for the mode, is refused.
extern "C" int dh_conv_int8(int device, const void* x, int n, int h, int w_in, int cin,
                            const void* w, int cout, int kh, int kw, int stride, int pad_top,
                            int pad_left, int oh, int ow, const void* a, const void* b,
                            int design, int mode, const void* res, int res_kind,
                            const void* res_scale, const void* next_inv, int out_kind, void* out,
                            void* out2, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  if (design != kMmaSync && design != kWgmma) return cudaErrorInvalidValue;
  if (mode != kModeF32 && mode != kModeInt8 && mode != kModeBlock) return cudaErrorInvalidValue;
  if (mode == kModeBlock) {
    if (res_kind < kResNone || res_kind > kResInt8) return cudaErrorInvalidValue;
    if (out_kind < kOutCarry || out_kind > kOutF32) return cudaErrorInvalidValue;
    if ((res == nullptr) != (res_kind == kResNone)) return cudaErrorInvalidValue;
    if (res_kind == kResInt8 && res_scale == nullptr) return cudaErrorInvalidValue;
    if (out_kind != kOutF32 && next_inv == nullptr) return cudaErrorInvalidValue;
    if ((out2 == nullptr) != (out_kind != kOutCarry)) return cudaErrorInvalidValue;
  }
  if (out == nullptr) return cudaErrorInvalidValue;
  if (stride < 1 || cin < 1 || kh < 1 || kw < 1) return cudaErrorInvalidValue;
  if (design == kWgmma && (cin % 64 != 0 || !aligned16(x) || !aligned16(w)))
    return cudaErrorInvalidValue;  // wgmma is written for Cin % 64 == 0
  if (n <= 0 || oh <= 0 || ow <= 0 || cout <= 0) return cudaGetLastError();
  Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.n = n, p.h = h, p.w_in = w_in, p.cin = cin, p.cout = cout, p.kh = kh, p.kw = kw;
  p.stride = stride, p.pad_top = pad_top, p.pad_left = pad_left, p.oh = oh, p.ow = ow;
  p.m = int64_t(n) * oh * ow;
  p.k = kh * kw * cin;
  Epi e;
  e.a = static_cast<const float*>(a);
  e.b = static_cast<const float*>(b);
  e.mode = mode;
  e.res_kind = mode == kModeBlock ? res_kind : kResNone;
  e.out_kind = mode == kModeBlock ? out_kind : kOutF32;
  e.res = res;
  e.res_scale = static_cast<const float*>(res_scale);
  e.next_inv = static_cast<const float*>(next_inv);
  e.out = out;
  e.out2 = out2;
  e.cout = cout;
  e.m = p.m;
  e.vec = cout % 16 == 0 && aligned16(a) && aligned16(b) && aligned16(out) &&
          (out2 == nullptr || aligned16(out2)) && (res == nullptr || aligned16(res));
  auto st = static_cast<cudaStream_t>(stream);
  if (design == kWgmma) return launch_wgmma(p, e, st);
  return launch_mma(p, e, st);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
