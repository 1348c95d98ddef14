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
// H100 SXM) for the wide sites, bytes (xq + wq read once, out written once,
// over 3.35 TB/s) for the narrow ones.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels, N = O, K = kh*kw*I.
// A block of 4 warps computes a 128 x 64 output tile; each warp a 64 x 32
// quarter as 4 x 4 mma.sync.m16n8k32 (s8 x s8 -> s32) per 32 K values,
// with int32 accumulators in registers. A K step is 64 deep: the A tile
// (128 pixels x 64 K values) is gathered from xq into shared memory with
// zeros for padding and dilation holes, when I % 16 == 0 by 16-byte
// cp.async (zero-filled where invalid), else byte by byte; the B tile (64 x
// 64 of the K-major weights, whose rows the wrapper pads to a multiple of
// 64) by 16-byte cp.async. A ring of three stages keeps two steps' loads in
// flight while one multiplies. Each thread walks its K positions (tap and
// channel) incrementally, without divisions. Shared rows are 80 bytes
// apart, so each warp's 32-bit fragment loads hit 32 distinct banks.
// Offsets into xq and out are 64-bit. The epilogue converts each int32 to
// fp32 (round to nearest), multiplies by scale[o] and rounds once to the
// output type.
#include "common.cuh"

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

}  // namespace

// x: int8 [B, H, W, I]; w: int8 [O, ldw], row o = the K = kh*kw*I weights of
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
