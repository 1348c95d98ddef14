// int8 x int8 -> int32 convolution with the dequantization fused into its
// epilogue: the conv of the int8 quantized fitness (ops/quant.py).
//
//   acc[b,oy,ox,o] = sum_{ky,kx,i} xq[b, iy, ix, i] * wq[o, (ky*kw + kx)*I + i]
//   out[b,oy,ox,o] = round_to_out(float(acc) * scale[o])      (or acc itself)
//
// where the input is dilated by `dil` (dil-1 zeros between samples) and
// padded by pad0 before (negative: cropped): output row oy reads dilated row
// p = oy*stride + ky - pad0, which holds input row p/dil iff p >= 0,
// p % dil == 0 and p/dil < H (else zero); the same for columns.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (clip_glass_tpu/ops/quant.py:137, lax.conv_general_dilated with
// preferred_element_type=int32). PyTorch has no int8 conv on CUDA.
//
// Bound: operations at the int8 tensor-core rate (1,979 TOPS dense on an
// H100 SXM) for the wide sites, bytes (x + wq read once, out written once,
// over 3.35 TB/s) for the narrow ones; at the int8 flagship's sites bytes.
//
// Two routes; the wrapper picks one from the shapes (ops/conv_s8.py,
// conv_s8_variant):
//
// 1. wgmma (I % 16 == 0; stride 1 if dilated, lhs_dilation 1 or 2): the
//    Hopper design further down, which quantizes a float x in its gather and
//    splits a 2-dilated conv by output phase.
// 2. mma_sync (every other geometry: I % 16 != 0, as D's last conv with its
//    minibatch-std channel, I = 513; other dilations), on int8 x: an
//    implicit GEMM, M = B*Ho*Wo output pixels, N = O, K = kh*kw*I. A block
//    of 4 warps computes a 128 x 64 output tile; each warp a 64 x 32 quarter
//    as 4 x 4 mma.sync.m16n8k32 (s8 x s8 -> s32) per 32 K values, with int32
//    accumulators in registers. A K step is 64 deep: the A tile (128 pixels
//    x 64 K values) is gathered from xq into shared memory with zeros for
//    padding and dilation holes, when I % 16 == 0 by 16-byte cp.async
//    (zero-filled where invalid), else byte by byte; the B tile (64 x 64 of
//    the K-major weights, whose rows the wrapper pads to a multiple of 64)
//    by 16-byte cp.async. A ring of three stages keeps two steps' loads in
//    flight while one multiplies. Each thread walks its K positions (tap and
//    channel) incrementally, without divisions. Shared rows are 80 bytes
//    apart, so each warp's 32-bit fragment loads hit 32 distinct banks.
//    Offsets into xq and out are 64-bit. The epilogue converts each int32 to
//    fp32 (round to nearest), multiplies by scale[o] and rounds once to the
//    output type.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int LDS = BK + 16;  // bytes between two shared rows

enum OutCode : int { kOutFloat32 = 0, kOutBFloat16 = 1, kOutInt32 = 2 };

struct Geometry {
  int64_t M;     // B * Ho * Wo
  int64_t HoWo;  // Ho * Wo
  int64_t ldw;
  int H, W, I, Wo, O, K, kw, stride, pad0, dil;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The dilated, padded coordinate p of one axis -> the input index, or -1
// for padding and dilation holes.
__device__ __forceinline__ int source_index(int p, int n, int dil) {
  if (p < 0) return -1;
  if (dil == 1) return p < n ? p : -1;
  if (p % dil) return -1;
  const int s = p / dil;
  return s < n ? s : -1;
}

// One output pixel's place: the batch's first input element and the
// dilated coordinates of its (ky, kx) = (0, 0) tap. base < 0: past M.
struct Pixel {
  int64_t base;
  int py0, px0;
};

__device__ __forceinline__ Pixel pixel_of(int64_t m, const Geometry& g) {
  Pixel px;
  if (m >= g.M) {
    px.base = -1;
    px.py0 = px.px0 = 0;
    return px;
  }
  const int64_t b = m / g.HoWo;
  const int r = static_cast<int>(m - b * g.HoWo);
  const int oy = r / g.Wo;
  const int ox = r - oy * g.Wo;
  px.base = b * g.H * g.W * g.I;
  px.py0 = oy * g.stride - g.pad0;
  px.px0 = ox * g.stride - g.pad0;
  return px;
}

// A position k of the K axis as (ky, kx, i), advanced without divisions.
struct KPos {
  int k, ky, kx, i;
  __device__ __forceinline__ void init(int k0, const Geometry& g) {
    k = k0;
    const int tap = k0 / g.I;
    i = k0 - tap * g.I;
    ky = tap / g.kw;
    kx = tap - ky * g.kw;
  }
  __device__ __forceinline__ void advance(int n, const Geometry& g) {
    k += n;
    i += n;
    while (i >= g.I) {
      i -= g.I;
      if (++kx == g.kw) {
        kx = 0;
        ++ky;
      }
    }
  }
};

template <typename OutT>
__device__ __forceinline__ OutT dequant(int acc, float s);
template <>
__device__ __forceinline__ float dequant<float>(int acc, float s) {
  return __fmul_rn(__int2float_rn(acc), s);
}
template <>
__device__ __forceinline__ __nv_bfloat16 dequant<__nv_bfloat16>(int acc, float s) {
  return __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), s));
}
template <>
__device__ __forceinline__ int dequant<int>(int acc, float) {
  return acc;
}

// two neighbouring outputs in one aligned store
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
__device__ __forceinline__ void store_pair(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

template <typename OutT, bool VEC16>
__global__ void __launch_bounds__(THREADS)
    conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, OutT* __restrict__ out, Geometry g) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // the warp's 64-row half of the tile
  const int wn = warp & 1;   // its 32-column half
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;

  // A loads: VEC16, 16 bytes of rows tid/4 + 32j (j < 4) at K offset
  // 16*(tid%4) of each step; else the BK bytes of row tid. B loads: 16
  // bytes of weight rows n0 + tid/4 + 32j (j < 2) at K offset 16*(tid%4).
  const int quarter = tid & 3;
  constexpr int A_ROWS = VEC16 ? 4 : 1;
  Pixel pa[A_ROWS];
#pragma unroll
  for (int j = 0; j < A_ROWS; ++j)
    pa[j] = pixel_of(m0 + (VEC16 ? (tid >> 2) + 32 * j : tid), g);
  const int8_t* b_src[2];
  bool b_valid[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t n = n0 + (tid >> 2) + 32 * j;
    b_valid[j] = n < g.O;
    b_src[j] = w + (b_valid[j] ? n * g.ldw : 0) + 16 * quarter;
  }
  KPos kp;
  kp.init(VEC16 ? 16 * quarter : 0, g);

  // the loads of the K step at k0 into `stage`; advances kp by one step
  auto load_tile = [&](int stage, int k0) {
    if (VEC16) {
      // I % 16 == 0: the 16 K values of a chunk share one tap
      const bool k_ok = kp.k < g.K;
#pragma unroll
      for (int j = 0; j < A_ROWS; ++j) {
        const int row = (tid >> 2) + 32 * j;
        const int sy = source_index(pa[j].py0 + kp.ky, g.H, g.dil);
        const int sx = source_index(pa[j].px0 + kp.kx, g.W, g.dil);
        const bool ok = k_ok && pa[j].base >= 0 && sy >= 0 && sx >= 0;
        const int8_t* src =
            ok ? x + pa[j].base + (static_cast<int64_t>(sy) * g.W + sx) * g.I + kp.i : x;
        cp_async16(cg::smem_addr(&As[stage][row * LDS + 16 * quarter]), src, ok);
      }
      kp.advance(BK, g);
    } else {
      uint32_t words[BK / 4];
#pragma unroll
      for (int wi = 0; wi < BK / 4; ++wi) words[wi] = 0;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kp.k < g.K && pa[0].base >= 0) {
          const int sy = source_index(pa[0].py0 + kp.ky, g.H, g.dil);
          const int sx = source_index(pa[0].px0 + kp.kx, g.W, g.dil);
          if (sy >= 0 && sx >= 0) {
            const uint32_t v = static_cast<uint8_t>(
                x[pa[0].base + (static_cast<int64_t>(sy) * g.W + sx) * g.I + kp.i]);
            words[kk >> 2] |= v << (8 * (kk & 3));
          }
        }
        kp.advance(1, g);
      }
      uint4* dst = reinterpret_cast<uint4*>(&As[stage][tid * LDS]);
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        dst[c] = make_uint4(words[4 * c], words[4 * c + 1], words[4 * c + 2], words[4 * c + 3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      cp_async16(cg::smem_addr(&Bs[stage][((tid >> 2) + 32 * j) * LDS + 16 * quarter]),
                 b_src[j] + k0, b_valid[j]);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int gq = lane >> 2;  // groupID of the mma fragments
  const int tq = lane & 3;   // thread in group
  const int n_steps = (g.K + BK - 1) / BK;
  // a ring of STAGES steps: step s waits for its own group, then issues
  // step s + STAGES - 1 into the stage that step s - 1 has left
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_steps) load_tile(st, st * BK);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = s + STAGES - 1;
    if (next < n_steps) load_tile(next % STAGES, next * BK);
    cp_async_commit();
    const int stage = s % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* ar = &As[stage][(wm * 64 + mi * 16 + gq) * LDS + ks + tq * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(ar);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* br = &Bs[stage][(wn * 32 + ni * 8 + gq) * LDS + ks + tq * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 16);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int64_t c = n0 + wn * 32 + ni * 8 + tq * 2;
    const float s0 = c < g.O ? scale[c] : 0.f;
    const float s1 = c + 1 < g.O ? scale[c + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = m0 + wm * 64 + mi * 16 + gq + 8 * h;
        if (r >= g.M) continue;
        OutT* o = out + r * g.O + c;
        if (c < g.O) o[0] = dequant<OutT>(acc[mi][ni][2 * h], s0);
        if (c + 1 < g.O) o[1] = dequant<OutT>(acc[mi][ni][2 * h + 1], s1);
      }
    }
  }
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* scale, void* out, const Geometry& g,
           bool vec16, cudaStream_t st) {
  const int64_t mt = (g.M + BM - 1) / BM;
  const int64_t nt = (g.O + BN - 1) / BN;
  if (mt > 0x7fffffffLL || nt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt));
  if (vec16) {
    conv_s8_kernel<OutT, true><<<grid, THREADS, 0, st>>>(x, w, scale, static_cast<OutT*>(out), g);
  } else {
    conv_s8_kernel<OutT, false><<<grid, THREADS, 0, st>>>(x, w, scale, static_cast<OutT*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------------------ the wgmma route
//
// Bound: the sites of the int8 flagship are bound by bytes (each input value
// read once, the weights, each output written once), since the products
// with real inputs take less time at 1,979 TOPS than those bytes at 3.35
// TB/s. The design keeps the bytes close to that:
//
// - Quantization in the gather. The activation comes in its float type (bf16
//   or fp32; int8 is copied as it is); producer threads load 8 channels of
//   one tap at a time, compute rint(float(x) * x_inv_scale) in fp32 (a
//   product rounded once, then the clamp to +-127, then the rounding to an
//   integer by adding 1.5 * 2^23, which rounds half to even), pack the bytes
//   and store them straight into the 128-byte-swizzled A tile. No int8 copy
//   of the activation exists in device memory.
// - No products on dilation holes. A 2-dilated stride-1 conv is split by
//   output phase (oy mod 2, ox mod 2): each phase is a stride-1 conv of the
//   undilated input with the taps whose dilated position meets a sample,
//   with weights packed per phase by the wrapper. One launch runs every
//   phase: a phase table, the tiles of the phases back to back.
// - wgmma s8. Block = 4 warpgroups: two consumers, each m64n128k32 s8 x s8
//   -> s32 on 64 rows of a 128 x 128 tile, and two producers that gather
//   and quantize A;
//   the first producer thread also brings each B tile (128 output channels x
//   128 K bytes of the packed weights) by TMA. A ring of 6 stages (16 KB of
//   A + 16 KB of B each) under mbarriers: A full when the 8 producer warps
//   have stored and fenced their bytes (count 8), B full when its
//   TMA bytes have landed, empty when both consumers' wgmmas are done with
//   it. Sixteen producer threads gather one tile row, 8 channels each, so
//   that a warp's loads cover whole lines of two rows. The grid is
//   persistent (one block an SM, tiles strided over the blocks), so the
//   producers run on into the next tile's steps while the consumers
//   dequantize the last one: float(acc) * scale[o], rounded once, stored as
//   pairs.
//
// Where it stands (NVIDIA H100 80GB HBM3, the int8 flagship's sites): about a
// fifth of the bytes bound. The gather re-reads and re-quantizes each input
// value once per tap (4 times at the [2,2] folds, 9 at the 3x3 convs) from
// L2. scripts/conv_s8_ablation.py times copies of this route with one part
// cut: the gather's loads cost the most, the ring's depth and a third
// producer warpgroup nothing. A window of the input quantized once a tile
// and shared by its taps is the next step.
namespace wgs8 {

constexpr int BM = 128, BN = 128, BKB = 128;  // K bytes a step: one swizzle row
constexpr int TILE_BYTES = BM * BKB;           // A and B stages alike: 16 KB
constexpr int CONSUMERS = 2, PRODUCERS = 2;
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int PTHREADS = PRODUCERS * 128;
constexpr int MAX_PHASES = 4;

enum XCode : int { kXFloat32 = 0, kXBFloat16 = 1, kXInt8 = 2 };

// One output phase: a stride-`stride` conv of the undilated input with kh x
// kw taps (input row u * stride + ky - pad_y), writing output rows
// oy0 + u * ostep.
struct Phase {
  int kh, kw, pad_y, pad_x, Ho, Wo, oy0, ox0, K;
  int64_t M, tile0;  // B * Ho * Wo; its first tile among all phases'
};

struct Params {
  Phase ph[MAX_PHASES];
  int n_phases, H, W, I, O, stride, ostep, Ho, Wo, n_tiles_n;
  int64_t total_tiles;
  float inv_scale;
};

__device__ __forceinline__ int phase_of(const Params& p, int64_t t) {
  int q = 0;
  while (q + 1 < p.n_phases && t >= p.ph[q + 1].tile0) ++q;
  return q;
}

// four fp32 values quantized to int8 and packed, a in the low byte
__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float inv) {
  const auto q = [inv](float v) {
    v = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(v, 12582912.f));  // low byte: rint(v), two's complement
  };
  return __byte_perm(__byte_perm(q(a), q(b), 0x0040), __byte_perm(q(c), q(d), 0x0040), 0x5410);
}

// 8 consecutive channels of x: one load (8, 16 or 32 bytes) -> 8 int8
template <typename T>
struct Gather8;
template <>
struct Gather8<int8_t> {
  using V = uint2;
  static __device__ __forceinline__ V load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ V zero() { return make_uint2(0, 0); }
  static __device__ __forceinline__ uint2 quantize(const V& v, float) { return v; }
};
template <>
struct Gather8<__nv_bfloat16> {
  using V = int4;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
  static __device__ __forceinline__ V zero() { return make_int4(0, 0, 0, 0); }
  static __device__ __forceinline__ uint2 quantize(const V& v, float inv) {
    float f[8];
    cg::Pack16<__nv_bfloat16>::unpack(v, f);
    return make_uint2(quant4(f[0], f[1], f[2], f[3], inv), quant4(f[4], f[5], f[6], f[7], inv));
  }
};
template <>
struct Gather8<float> {
  struct V {
    int4 a, b;
  };
  static __device__ __forceinline__ V load(const float* p) {
    const int4* q = reinterpret_cast<const int4*>(p);
    return V{__ldg(q), __ldg(q + 1)};
  }
  static __device__ __forceinline__ V zero() { return V{make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)}; }
  static __device__ __forceinline__ uint2 quantize(const V& v, float inv) {
    return make_uint2(quant4(__int_as_float(v.a.x), __int_as_float(v.a.y), __int_as_float(v.a.z),
                             __int_as_float(v.a.w), inv),
                      quant4(__int_as_float(v.b.x), __int_as_float(v.b.y), __int_as_float(v.b.z),
                             __int_as_float(v.b.w), inv));
  }
};

// The producers' gather: 16 threads a tile row, each 8 consecutive K values
// (8 channels of one tap) of every step, so that a warp's loads cover two
// rows' contiguous channels (coalesced); PASSES rows a thread, RPP apart.
constexpr int TPR = BKB / 8;
constexpr int RPP = PTHREADS / TPR;               // rows a pass
constexpr int PASSES = (BM + RPP - 1) / RPP;
constexpr int STAGES = 6;
constexpr int SMEM_BYTES = 2 * STAGES * TILE_BYTES + 3 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "over the 227 KB shared-memory opt-in");

#define CG_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define CG_R16(i) CG_R4(i), CG_R4(i + 4), CG_R4(i + 8), CG_R4(i + 12)

// d (+)= A[64 x 32] B[32 x 128], s8 x s8 -> s32; both operands K-major in
// shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : CG_R16(0), CG_R16(16), CG_R16(32), CG_R16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef CG_R16
#undef CG_R4

__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <typename XT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    conv_s8_wgmma_kernel(const XT* __restrict__ x, const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ scale, OutT* __restrict__ out,
                         const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = cg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_s = base, b_s = base + STAGES * TILE_BYTES;
  const uint32_t a_full = b_s + STAGES * TILE_BYTES;  // STAGES barriers: A stored
  const uint32_t b_full = a_full + 8 * STAGES;        // B landed
  const uint32_t empty = b_full + 8 * STAGES;         // stage consumed by both warpgroups
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      cg::mbar_init(a_full + 8 * s, PTHREADS / 32);
      cg::mbar_init(b_full + 8 * s, 1);
      cg::mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group >= CONSUMERS) {
    // producers: thread pt gathers K values [8 (pt % TPR), +8) of every step
    // for tile rows pt / TPR + RPP r (r < PASSES, below BM)
    using G = Gather8<XT>;
    const int pt = threadIdx.x - CONSUMERS * 128;
    const int lane16 = pt % TPR, row0 = pt / TPR;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = blockIdx.x; t < p.total_tiles; t += gridDim.x) {
      const int q = phase_of(p, t);
      const Phase& ph = p.ph[q];
      const int steps = (ph.K + BKB - 1) / BKB;
      if (steps == 0) continue;  // a phase that meets no tap: the consumers write zeros
      const int64_t local = t - ph.tile0;
      const int64_t m0 = (local / p.n_tiles_n) * BM;
      const int n0 = static_cast<int>(local % p.n_tiles_n) * BN;
      // the rows' pixels: first input pixel of the batch (-1 past M) and the
      // (0, 0) tap's input coordinates
      int pix[PASSES], y0[PASSES], x0[PASSES];
#pragma unroll
      for (int r = 0; r < PASSES; ++r) {
        const int row = row0 + RPP * r;
        const int64_t m = m0 + row;
        pix[r] = -1;
        y0[r] = x0[r] = 0;
        if (row < BM && m < ph.M) {
          const int hw = ph.Ho * ph.Wo;
          const int b = static_cast<int>(m / hw);
          const int rem = static_cast<int>(m - static_cast<int64_t>(b) * hw);
          const int u = rem / ph.Wo;
          pix[r] = b * p.H * p.W;
          y0[r] = u * p.stride - ph.pad_y;
          x0[r] = (rem - u * ph.Wo) * p.stride - ph.pad_x;
        }
      }
      // this thread's K position of the step: (ky, kx, i), advanced without
      // divisions
      int ky = 0, kx = 0, i = 8 * lane16, k = 8 * lane16;
      while (i >= p.I) {
        i -= p.I;
        if (++kx == ph.kw) {
          kx = 0;
          ++ky;
        }
      }
      for (int ks = 0; ks < steps; ++ks) {
        typename G::V v[PASSES];
#pragma unroll
        for (int r = 0; r < PASSES; ++r) {
          const int iy = y0[r] + ky, ix = x0[r] + kx;
          const bool ok = pix[r] >= 0 && k < ph.K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
          v[r] = ok ? G::load(x + (static_cast<int64_t>(pix[r] + iy * p.W + ix) * p.I + i))
                    : G::zero();
        }
        k += BKB;
        i += BKB;
        while (i >= p.I) {
          i -= p.I;
          if (++kx == ph.kw) {
            kx = 0;
            ++ky;
          }
        }
        cg::mbar_wait(empty + 8 * stage, phase ^ 1);
        if (pt == 0) {
          cg::mbar_expect_tx(b_full + 8 * stage, TILE_BYTES);
          cg::tma_load_3d(b_s + stage * TILE_BYTES, &wmap, b_full + 8 * stage, ks * BKB, n0, q);
        }
        unsigned char* a_tile = smem + stage * TILE_BYTES;
#pragma unroll
        for (int r = 0; r < PASSES; ++r) {
          const int row = row0 + RPP * r;
          if (RPP * PASSES > BM && row >= BM) break;
          const int c = lane16 >> 1;  // 16-byte chunk of the 128-byte row
          *reinterpret_cast<uint2*>(a_tile + row * BKB + ((c ^ (row & 7)) << 4) +
                                    8 * (lane16 & 1)) = G::quantize(v[r], p.inv_scale);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (pt % 32 == 0) cg::mbar_arrive(a_full + 8 * stage);  // one arrival a warp
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup `group` owns tile rows [64 group, 64 group + 64)
  int acc[64];
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const bool leader = threadIdx.x % 128 == 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t t = blockIdx.x; t < p.total_tiles; t += gridDim.x) {
    const Phase& ph = p.ph[phase_of(p, t)];
    const int64_t local = t - ph.tile0;
    const int64_t m0 = (local / p.n_tiles_n) * BM + group * 64;
    const int n0 = static_cast<int>(local % p.n_tiles_n) * BN;
    const int steps = (ph.K + BKB - 1) / BKB;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;  // a phase without taps writes zeros
    int prev = -1;
    for (int ks = 0; ks < steps; ++ks) {
      cg::mbar_wait(a_full + 8 * stage, phase);
      cg::mbar_wait(b_full + 8 * stage, phase);
      fence_operands(acc);
      cg::wgmma_fence();
      const uint32_t a = a_s + stage * TILE_BYTES + group * 64 * BKB;
      const uint32_t w = b_s + stage * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKB / 32; ++kk)
        wgmma_s8(acc, cg::sw128_desc(a + 32 * kk), cg::sw128_desc(w + 32 * kk), ks > 0 || kk > 0);
      cg::wgmma_commit();
      fence_operands(acc);
      if (prev >= 0) {
        cg::wgmma_wait<1>();  // the previous step's products are done with it
        if (leader) cg::mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    cg::wgmma_wait<0>();
    fence_operands(acc);
    if (leader && prev >= 0) cg::mbar_arrive(empty + 8 * prev);

    // epilogue: accumulator rows r0 and r0 + 8 of the warpgroup's 64, columns
    // n0 + 8 j + 2 (lane % 4) + {0, 1}
    const int r0 = warp * 16 + lane / 4;
    int64_t orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + r0 + 8 * h;
      orow[h] = -1;
      if (m < ph.M) {
        const int64_t hw = static_cast<int64_t>(ph.Ho) * ph.Wo;
        const int64_t b = m / hw;
        const int r = static_cast<int>(m - b * hw);
        const int u = r / ph.Wo, v = r - (r / ph.Wo) * ph.Wo;
        orow[h] = ((b * p.Ho + ph.oy0 + u * p.ostep) * p.Wo + ph.ox0 + v * p.ostep) * p.O;
      }
    }
    const bool pairs = (p.O & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = n0 + 8 * j + 2 * (lane % 4);
      if (o >= p.O) continue;
      const bool two = o + 1 < p.O;
      const float s0 = scale[o], s1 = two ? scale[o + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (orow[h] < 0) continue;
        OutT* dst = out + orow[h] + o;
        const OutT v0 = dequant<OutT>(acc[4 * j + 2 * h], s0);
        if (pairs) {
          const OutT v1 = dequant<OutT>(acc[4 * j + 2 * h + 1], s1);
          store_pair(dst, v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = dequant<OutT>(acc[4 * j + 2 * h + 1], s1);
        }
      }
    }
  }
}

template <typename OutT>
int launch_out(const void* x, int x_code, const CUtensorMap& wmap, const float* scale, void* out,
               const Params& p, int blocks, cudaStream_t st) {
  OutT* o = static_cast<OutT*>(out);
  cudaError_t e = cudaSuccess;
  switch (x_code) {
    case kXFloat32:
      e = cudaFuncSetAttribute(conv_s8_wgmma_kernel<float, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e == cudaSuccess)
        conv_s8_wgmma_kernel<float, OutT><<<blocks, THREADS, SMEM_BYTES, st>>>(
            static_cast<const float*>(x), wmap, scale, o, p);
      break;
    case kXBFloat16:
      e = cudaFuncSetAttribute(conv_s8_wgmma_kernel<__nv_bfloat16, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e == cudaSuccess)
        conv_s8_wgmma_kernel<__nv_bfloat16, OutT><<<blocks, THREADS, SMEM_BYTES, st>>>(
            static_cast<const __nv_bfloat16*>(x), wmap, scale, o, p);
      break;
    case kXInt8:
      e = cudaFuncSetAttribute(conv_s8_wgmma_kernel<int8_t, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e == cudaSuccess)
        conv_s8_wgmma_kernel<int8_t, OutT><<<blocks, THREADS, SMEM_BYTES, st>>>(
            static_cast<const int8_t*>(x), wmap, scale, o, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgs8

}  // namespace

// The mma_sync route. x: int8 [B, H, W, I]; w: int8 [O, ldw], row o = the K = kh*kw*I weights of
// output channel o in (ky, kx, i) order, zero past K, ldw a multiple of 32;
// scale: fp32 [O]; out: [B, Ho, Wo, O] of out_dtype (0 fp32, 1 bf16, 2 the
// int32 accumulators). vec16 = 1 takes 16-byte gathers (the caller
// guarantees I % 16 == 0 and a 16-byte aligned x); w must be 16-byte
// aligned.
extern "C" int cg_conv_s8(const void* x, const void* w, const void* scale, void* out, int64_t B,
                          int64_t H, int64_t W, int64_t I, int64_t Ho, int64_t Wo, int64_t O,
                          int64_t kh, int64_t kw, int64_t ldw, int stride, int pad0, int dil,
                          int out_dtype, int vec16, void* stream) {
  const int64_t K = kh * kw * I;
  // every extent but M and the element offsets fits 32 bits
  if (H * W > INT32_MAX || Ho * Wo > INT32_MAX || K > INT32_MAX / 2 || O > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.M = B * Ho * Wo;
  g.HoWo = Ho * Wo;
  g.ldw = ldw;
  g.H = static_cast<int>(H);
  g.W = static_cast<int>(W);
  g.I = static_cast<int>(I);
  g.Wo = static_cast<int>(Wo);
  g.O = static_cast<int>(O);
  g.K = static_cast<int>(K);
  g.kw = static_cast<int>(kw);
  g.stride = stride;
  g.pad0 = pad0;
  g.dil = dil;
  if (g.M == 0 || O == 0) return 0;
  if (stride < 1 || dil < 1 || ldw % BK || ldw < K || (vec16 && I % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kOutFloat32:
      return launch<float>(xp, wp, sp, out, g, vec16 != 0, st);
    case kOutBFloat16:
      return launch<__nv_bfloat16>(xp, wp, sp, out, g, vec16 != 0, st);
    case kOutInt32:
      return launch<int>(xp, wp, sp, out, g, vec16 != 0, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma route. x: [B, H, W, I] fp32, bf16 (quantized in the gather by
// x_inv_scale) or int8 (x_code 0, 1, 2), I % 16 == 0, 16-byte aligned; w:
// int8 [n_phases, O, ldw], phase q's row o the K = kh*kw*I weights of its
// taps in (ky, kx, i) order, zero past K, ldw a multiple of 128, 16-byte
// aligned; phases: n_phases x 8 ints (kh, kw, pad_y, pad_x, Ho, Wo, oy0,
// ox0) of the output phases (one, with stride `stride` and ostep 1, for an
// undilated conv; for lhs_dilation 2 at stride 1 those of the output phases
// (oy mod 2, ox mod 2), ostep 2); scale fp32 [O]; out [B, Ho, Wo, O] of
// out_dtype (0 fp32, 1 bf16, 2 int32).
extern "C" int cg_conv_s8_wgmma(const void* x, const void* w, const void* scale, void* out,
                                int64_t B, int64_t H, int64_t W, int64_t I, int64_t Ho, int64_t Wo,
                                int64_t O, int64_t ldw, int stride, int ostep, int n_phases,
                                const int* phases, int x_code, float x_inv_scale, int out_dtype,
                                void* stream) {
  namespace k8 = wgs8;
  if (B * Ho * Wo == 0 || O == 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B * H * W > INT32_MAX || Ho * Wo > INT32_MAX || I % 16 || I > (1 << 20) || O > (1 << 24) ||
      ldw % k8::BKB || n_phases < 1 || n_phases > k8::MAX_PHASES || stride < 1 || ostep < 1 ||
      misaligned(x) || misaligned(w))
    return static_cast<int>(cudaErrorInvalidValue);
  k8::Params p;
  p.n_phases = n_phases;
  p.H = static_cast<int>(H);
  p.W = static_cast<int>(W);
  p.I = static_cast<int>(I);
  p.O = static_cast<int>(O);
  p.stride = stride;
  p.ostep = ostep;
  p.Ho = static_cast<int>(Ho);
  p.Wo = static_cast<int>(Wo);
  p.n_tiles_n = static_cast<int>((O + k8::BN - 1) / k8::BN);
  p.inv_scale = x_inv_scale;
  int64_t tiles = 0;
  for (int q = 0; q < n_phases; ++q) {
    k8::Phase& ph = p.ph[q];
    const int* f = phases + 8 * q;
    ph.kh = f[0];
    ph.kw = f[1];
    ph.pad_y = f[2];
    ph.pad_x = f[3];
    ph.Ho = f[4];
    ph.Wo = f[5];
    ph.oy0 = f[6];
    ph.ox0 = f[7];
    ph.K = static_cast<int>(ph.kh * ph.kw * I);
    if (ph.kh < 0 || ph.kw < 0 || ph.Ho < 1 || ph.Wo < 1 || ph.K > ldw ||
        ph.oy0 + static_cast<int64_t>(ph.Ho - 1) * ostep >= Ho ||
        ph.ox0 + static_cast<int64_t>(ph.Wo - 1) * ostep >= Wo)
      return static_cast<int>(cudaErrorInvalidValue);
    ph.M = B * ph.Ho * ph.Wo;
    ph.tile0 = tiles;
    tiles += (ph.M + k8::BM - 1) / k8::BM * p.n_tiles_n;
  }
  p.total_tiles = tiles;
  // the packed weights [n_phases, O, ldw] as TMA tiles of 128 rows x 128 bytes
  const cg::EncodeTiled encode = cg::encode_tiled();
  CUtensorMap wmap;
  const uint64_t wd[3] = {uint64_t(ldw), uint64_t(O), uint64_t(n_phases)};
  const uint64_t ws[2] = {uint64_t(ldw), uint64_t(ldw * O)};
  const uint32_t wb[3] = {k8::BKB, k8::BN, 1};
  const uint32_t elem[3] = {1, 1, 1};
  if (encode == nullptr ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), wd, ws, wb, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(std::min<int64_t>(tiles, cg::sm_count()));
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kOutFloat32:
      return k8::launch_out<float>(x, x_code, wmap, sp, out, p, blocks, st);
    case kOutBFloat16:
      return k8::launch_out<__nv_bfloat16>(x, x_code, wmap, sp, out, p, blocks, st);
    case kOutInt32:
      return k8::launch_out<int>(x, x_code, wmap, sp, out, p, blocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
