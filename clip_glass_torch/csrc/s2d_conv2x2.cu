// Offset-lattice [2,2] convolution on space-to-depth tensors:
//
//   y[b,v,w,:] = sum_{a,c in {0,1}} x[b, v+a-pad0, w+c-pad0, :] @ Kb[b,a,c]
//
// x: [B,n,n,C], Kb: per-sample K * style * demod, folded by the wrapper in
// fp32 and rounded once to x's dtype, or one set round(K) shared by every
// sample when the call is unmodulated; y: [B,n_out,n_out,C] with n_out = n+1
// (pad0 = 1) or n-1 (pad0 = 0). Cells outside x read zero. fp32
// accumulation, one rounding to x's dtype.
//
// Replaces the TPU kernel clip_glass_tpu/ops/pallas/s2d_conv2x2.py, function
// s2d_conv2x2_pallas (pallas_call at :108): the same-resolution 3x3 convs of
// StyleGAN2's 512 and 1024 px levels, folded onto 4C = 128 channels between
// opposite lattices.
//
// Bound: per sample this is a dense GEMM, M = n_out^2 output cells, N = C,
// K = 4C. At the flagship (C = 128, bf16, pop 16) one 1024 px launch moves
// ~2.15e9 bytes (0.64 ms at 3.35 TB/s) and does 5.5e11 operations (0.56 ms
// at the 989 TFLOP/s bf16 tensor-core peak): bytes bind, narrowly, and only
// if the products run at the tensor cores' full rate.
//
// Four variants; the wrapper picks one from dtype, C and whether one weight
// set serves every sample.
//
// 1. wgmma (bf16, C in {64, 128}: every flagship launch). A persistent,
//    warp-specialised implicit GEMM:
//    - Weights stay in shared memory. A block serves one sample and loads
//      that sample's weights (or the shared set) once by TMA, 4 taps x C x C
//      (128 KB at C = 128), in the 128-byte-swizzled K-major layout that the
//      wgmma B descriptor reads; the wrapper writes each tap as [out, in]
//      while it folds. About one block per SM: B x (SMs / B) blocks, each
//      walking a contiguous run of the sample's output tiles, so the
//      weights cross L2 once per block rather than once per tile.
//    - A tiles come by TMA with the hardware's zero fill. One 4-D tensor
//      map over x [B,n,n,C]; an output tile is 4 rows x 32 cells (M = 128).
//      One box of 5 rows x 32 cells x 64 channels, shifted by (-pad0,
//      c-pad0), serves both taps (0,c) and (1,c): tap a reads it from row
//      a. The halo, the negative coordinates and the ragged edge read zeros
//      with no address arithmetic per element, and each tile pulls 80 KB
//      (C = 128) through L2 rather than 128 KB for one box per tap.
//      32-cell rows waste 6% (n_out = 513) and 12% (257) of the MMA work on
//      cells past the edge, and no bytes.
//    - A ring of 20 KB A stages under full/empty mbarriers: one producer
//      thread keeps TMA loads in flight while two consumer warpgroups (64
//      rows each) issue wgmma m64nCk16 from shared memory into fp32
//      registers, one stage's batch kept in flight.
//    - Epilogue: each consumer warpgroup rounds its 64 x C tile to bf16 in
//      registers, stages it swizzled in shared memory (conflict-free stores)
//      and issues one TMA store per 64 channels; the store box is clipped at
//      y's edge, so ragged tiles need no masks.
//    - Shared weights (D's unmodulated calls) are one tensor read by every
//      block, not B identical copies.
//    Shared memory at C = 128: 128 KB weights + 3 x 20 KB stages + 32 KB
//    output staging + barriers, under the 227 KB opt-in; 102 registers a
//    thread, no spills.
// 1b. wgmma_stream (bf16, C = 256, one shared weight set: BigGAN-deep's block
//    11 fold): the same A ring and consumers, with the 512 KiB weight set
//    streamed by TMA in [256 x 64] slabs through a ring of its own (at the
//    end of this file).
// 2. wmma (bf16, any other C; first design, kept for C = 20 and the like):
//    a block owns BM consecutive output cells and BN output channels, and
//    walks K as four taps times C in steps of BK; each thread gathers its
//    cell's shifted row of x per tap (zeros outside x) into shared memory,
//    synchronously; nvcuda::wmma 16x16x16 fragments with fp32 accumulators;
//    8 warps of 32x32 on a 64x128 tile; a masked store through shared memory.
// 3. fp32: the same implicit GEMM on the CUDA cores, a 64x64 tile with 4x4
//    outputs per thread, so that fp32 comparisons hold at 1e-5.
// Variants 2 and 3 take one weight set per sample or one shared by every
// sample ([sets,2,2,C,C], [in, out]; a block reads its sample's set, or set
// 0) and any C: loads beyond C are zero and stores are masked; 16-byte
// loads when C allows (vec > 1).
#include "common.cuh"

#include <cuda.h>
#include <mma.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

// x row of output cell m at tap offset (da, dc), or nullptr outside x.
template <typename T>
__device__ __forceinline__ const T* cell_row(const T* xb, int64_t m, int64_t M, int n,
                                             int n_out, int da, int dc, int C) {
  if (m >= M) return nullptr;
  const int v = static_cast<int>(m / n_out) + da;
  const int w = static_cast<int>(m % n_out) + dc;
  if (v < 0 || v >= n || w < 0 || w >= n) return nullptr;
  return xb + (static_cast<int64_t>(v) * n + w) * C;
}

template <typename T, int VEC>
__device__ __forceinline__ cg::Vec<T, VEC> load_or_zero(const T* p) {
  cg::Vec<T, VEC> v;
  if (p != nullptr) {
    v = *reinterpret_cast<const cg::Vec<T, VEC>*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.v[j] = cg::from_float<T>(0.f);
  }
  return v;
}

// ------------------------------------------------------------ bf16, wmma

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int LDA = BK + 8;   // bf16 row pitches: multiples of 8 (wmma), rows 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // fp32 pitch of the epilogue tile
constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BF16 = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    s2d_conv2x2_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ kb,
                            bf16* __restrict__ y, int n, int n_out, int C, int pad0,
                            int64_t kb_stride) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM_BF16];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int b = blockIdx.z;
  const int64_t M = static_cast<int64_t>(n_out) * n_out;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 32 x 32
  const bf16* xb = x + static_cast<int64_t>(b) * n * n * C;
  const bf16* kbb = kb + b * kb_stride;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 4; ++tap) {
    const int da = (tap >> 1) - pad0, dc = (tap & 1) - pad0;
    const bf16* kt = kbb + static_cast<int64_t>(tap) * C * C;
    for (int k0 = 0; k0 < C; k0 += BK) {
      for (int i = threadIdx.x; i < BM * BK / VEC; i += THREADS) {
        const int r = i / (BK / VEC);
        const int kk = (i % (BK / VEC)) * VEC;
        const bf16* row = cell_row(xb, m0 + r, M, n, n_out, da, dc, C);
        const bf16* p = (row != nullptr && k0 + kk < C) ? row + k0 + kk : nullptr;
        *reinterpret_cast<cg::Vec<bf16, VEC>*>(As + r * LDA + kk) = load_or_zero<bf16, VEC>(p);
      }
      for (int i = threadIdx.x; i < BK * BN / VEC; i += THREADS) {
        const int kr = i / (BN / VEC);
        const int nc = (i % (BN / VEC)) * VEC;
        const bf16* p = (k0 + kr < C && n0 + nc < C)
                            ? kt + static_cast<int64_t>(k0 + kr) * C + n0 + nc
                            : nullptr;
        *reinterpret_cast<cg::Vec<bf16, VEC>*>(Bs + kr * LDB + nc) = load_or_zero<bf16, VEC>(p);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / VEC; i += THREADS) {
    const int r = i / (BN / VEC);
    const int nc = (i % (BN / VEC)) * VEC;
    const int64_t m = m0 + r;
    if (m < M && n0 + nc < C) {
      cg::Vec<bf16, VEC> o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.v[j] = cg::from_float<bf16>(Cs[r * LDC + nc + j]);
      *reinterpret_cast<cg::Vec<bf16, VEC>*>(y + (static_cast<int64_t>(b) * M + m) * C + n0 + nc) =
          o;
    }
  }
}

// ------------------------------------------------------------ fp32, CUDA cores

constexpr int FM = 64, FN = 64, FK = 16;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    s2d_conv2x2_f32_kernel(const float* __restrict__ x, const float* __restrict__ kb,
                           float* __restrict__ y, int n, int n_out, int C, int pad0,
                           int64_t kb_stride) {
  __shared__ float As[FK][FM + 4];  // A transposed: As[k][cell]
  __shared__ float Bs[FK][FN + 4];

  const int b = blockIdx.z;
  const int64_t M = static_cast<int64_t>(n_out) * n_out;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * FM;
  const int n0 = blockIdx.y * FN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4x4 outputs each
  const float* xb = x + static_cast<int64_t>(b) * n * n * C;
  const float* kbb = kb + b * kb_stride;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 4; ++tap) {
    const int da = (tap >> 1) - pad0, dc = (tap & 1) - pad0;
    const float* kt = kbb + static_cast<int64_t>(tap) * C * C;
    for (int k0 = 0; k0 < C; k0 += FK) {
      for (int i = threadIdx.x; i < FM * FK / VEC; i += THREADS) {
        const int r = i / (FK / VEC);
        const int kk = (i % (FK / VEC)) * VEC;
        const float* row = cell_row(xb, m0 + r, M, n, n_out, da, dc, C);
        const cg::Vec<float, VEC> v =
            load_or_zero<float, VEC>((row != nullptr && k0 + kk < C) ? row + k0 + kk : nullptr);
#pragma unroll
        for (int j = 0; j < VEC; ++j) As[kk + j][r] = v.v[j];
      }
      for (int i = threadIdx.x; i < FK * FN / VEC; i += THREADS) {
        const int kr = i / (FN / VEC);
        const int nc = (i % (FN / VEC)) * VEC;
        const cg::Vec<float, VEC> v = load_or_zero<float, VEC>(
            (k0 + kr < C && n0 + nc < C) ? kt + static_cast<int64_t>(k0 + kr) * C + n0 + nc
                                         : nullptr);
#pragma unroll
        for (int j = 0; j < VEC; ++j) Bs[kr][nc + j] = v.v[j];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* yr = y + (static_cast<int64_t>(b) * M + m) * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < C) yr[col] = acc[i][j];
    }
  }
}

// kb_stride: elements between two samples' weight sets, 4*C*C, or 0 when
// one set serves every sample.
template <int VEC>
int launch_bf16(const void* x, const void* kb, void* y, int64_t B, int64_t n, int64_t n_out,
                int64_t C, int pad0, int64_t kb_stride, cudaStream_t st) {
  const int64_t M = n_out * n_out;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN),
            static_cast<unsigned>(B));
  s2d_conv2x2_bf16_kernel<VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(kb), static_cast<bf16*>(y),
      static_cast<int>(n), static_cast<int>(n_out), static_cast<int>(C), pad0, kb_stride);
  return 0;
}

template <int VEC>
int launch_f32(const void* x, const void* kb, void* y, int64_t B, int64_t n, int64_t n_out,
               int64_t C, int pad0, int64_t kb_stride, cudaStream_t st) {
  const int64_t M = n_out * n_out;
  dim3 grid(static_cast<unsigned>((M + FM - 1) / FM), static_cast<unsigned>((C + FN - 1) / FN),
            static_cast<unsigned>(B));
  s2d_conv2x2_f32_kernel<VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(kb), static_cast<float*>(y),
      static_cast<int>(n), static_cast<int>(n_out), static_cast<int>(C), pad0, kb_stride);
  return 0;
}

}  // namespace

// The wmma and fp32 variants. kb: [kb_sets, 2, 2, C, C], each tap [in, out];
// kb_sets = B (per-sample weights) or 1 (one set for every sample). vec =
// elements per 16-byte access (the caller guarantees C % vec == 0 and
// 16-byte aligned x, kb and y for vec > 1).
extern "C" int cg_s2d_conv2x2(const void* x, const void* kb, void* y, int64_t B, int64_t n,
                              int64_t n_out, int64_t C, int pad0, int64_t kb_sets, int dtype,
                              int vec, void* stream) {
  if (B * n_out * C == 0) return 0;
  if (B > 65535 || n_out * n_out > (int64_t(1) << 31) - BM || n > (1 << 30) ||
      (pad0 != 0 && pad0 != 1) || n_out != (pad0 ? n + 1 : n - 1) ||
      (kb_sets != 1 && kb_sets != B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t kb_stride = kb_sets == 1 ? 0 : 4 * C * C;
  int status;
  if (dtype == cg::kBFloat16 && vec == 8) {
    status = launch_bf16<8>(x, kb, y, B, n, n_out, C, pad0, kb_stride, st);
  } else if (dtype == cg::kBFloat16 && vec == 1) {
    status = launch_bf16<1>(x, kb, y, B, n, n_out, C, pad0, kb_stride, st);
  } else if (dtype == cg::kFloat32 && vec == 4) {
    status = launch_f32<4>(x, kb, y, B, n, n_out, C, pad0, kb_stride, st);
  } else if (dtype == cg::kFloat32 && vec == 1) {
    status = launch_f32<1>(x, kb, y, B, n, n_out, C, pad0, kb_stride, st);
  } else {
    status = static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16, wgmma + TMA

namespace {

namespace wg {

constexpr int TW = 32, TV = 4;                  // output tile: TV rows of TW cells
constexpr int KCH = 64;                         // channels per 128-byte swizzle row
constexpr int ROW_BYTES = KCH * 2;
// One A stage: TV + 1 rows of TW cells x 64 channels (20 KB), the rows of
// both taps a = 0, 1 of one column shift c: tap a reads stage rows from a TW.
constexpr int STAGE_BYTES = (TV + 1) * TW * ROW_BYTES;
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and one producer warpgroup

// Shared-memory plan of one block at C channels (offsets from a 1024-byte
// aligned base: 128-byte swizzle atoms must sit on 1024-byte boundaries).
template <int C>
struct Plan {
  static constexpr int CHUNKS = C / KCH;       // 64-channel chunks of one tap's K
  static constexpr int STEPS = 2 * CHUNKS;     // A stages per output tile: (c, chunk)
  static constexpr int STAGES = C == 128 ? 3 : 8;
  static constexpr int W_STEP = C * ROW_BYTES;  // one (tap, chunk): C out rows x 64 in
  static constexpr int W_BYTES = 4 * CHUNKS * W_STEP;
  static constexpr int O_HALF = 64 * ROW_BYTES;  // 64 rows x 64 channels of output
  static constexpr int O_GROUP = CHUNKS * O_HALF;
  static constexpr int A_OFF = W_BYTES;
  static constexpr int O_OFF = A_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = O_OFF + CONSUMERS * O_GROUP;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "over the 227 KB shared-memory opt-in");
};

using cg::encode_tiled;
using cg::mbar_arrive;
using cg::mbar_expect_tx;
using cg::mbar_init;
using cg::mbar_wait;
using cg::smem_addr;
using cg::sw128_desc;
using cg::tma_load_3d;
using cg::wgmma_commit;
using cg::wgmma_fence;
using cg::wgmma_wait;

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CG_F16(i) CG_F4(i), CG_F4(i + 4), CG_F4(i + 8), CG_F4(i + 12)

// d (+)= A[64 x 16] B[16 x N], A and B bf16 in shared memory, d fp32 in
// registers; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : CG_F16(0), CG_F16(16), CG_F16(32), CG_F16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : CG_F16(0), CG_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n256k16: the C = 256 route, one warpgroup's 64 rows x 256 outputs
// (128 fp32 registers a thread).
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : CG_F16(0), CG_F16(16), CG_F16(32), CG_F16(48), CG_F16(64), CG_F16(80), CG_F16(96),
        CG_F16(112)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef CG_F16
#undef CG_F4

// Block = (sample b, part of its tiles). Tile t = (row group t / tiles_w,
// column group t % tiles_w), TV x TW output cells; tile row r of the A
// stage and of the accumulators is cell (v0 + r / TW, w0 + r % TW).
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    s2d_conv2x2_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             const __grid_constant__ CUtensorMap ymap, int pad0, int tiles_w,
                             int tiles, int blocks_per_sample, int shared_weights) {
  using P = Plan<C>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t w_s = base, a_s = base + P::A_OFF, o_s = base + P::O_OFF;
  const uint32_t full = base + P::BAR_OFF;  // STAGES barriers of 8 bytes: A stage loaded
  const uint32_t empty = full + 8 * P::STAGES;  // A stage consumed by both warpgroups
  const uint32_t wbar = empty + 8 * P::STAGES;  // weights loaded

  const int b = blockIdx.x / blocks_per_sample;
  const int part = blockIdx.x % blocks_per_sample;
  const int t_begin = static_cast<int>(static_cast<int64_t>(tiles) * part / blocks_per_sample);
  const int t_end = static_cast<int>(static_cast<int64_t>(tiles) * (part + 1) / blocks_per_sample);
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == CONSUMERS) {
    // producer: one thread issues every TMA load of the block
    if (threadIdx.x != CONSUMERS * 128) return;
    const int wset = shared_weights ? 0 : b;
    mbar_expect_tx(wbar, P::W_BYTES);
#pragma unroll
    for (int s = 0; s < 4 * P::CHUNKS; ++s)  // s = tap * CHUNKS + chunk
      tma_load_3d(w_s + s * P::W_STEP, &wmap, wbar, (s % P::CHUNKS) * KCH, 0,
                  wset * 4 + s / P::CHUNKS);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int v0 = (t / tiles_w) * TV, w0 = (t % tiles_w) * TW;
#pragma unroll
      for (int s = 0; s < P::STEPS; ++s) {  // s = c * CHUNKS + chunk
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
        tma_load_4d(a_s + stage * STAGE_BYTES, &xmap, full + 8 * stage, (s % P::CHUNKS) * KCH,
                    w0 + s / P::CHUNKS - pad0, v0 - pad0, b);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup `group` owns tile rows [64 group, 64 group + 64)
  float acc[C / 2] = {};
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t out = o_s + group * P::O_GROUP;
  unsigned char* out_p = smem + P::O_OFF + group * P::O_GROUP;
  mbar_wait(wbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    int prev = 0;
#pragma unroll
    for (int s = 0; s < P::STEPS; ++s) {
      mbar_wait(full + 8 * stage, phase);
      const int c = s / P::CHUNKS, chunk = s % P::CHUNKS;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ta = 0; ta < 2; ++ta) {  // tap (ta, c)
        const uint32_t a = a_s + stage * STAGE_BYTES + (ta * TW + group * 64) * ROW_BYTES;
        const uint32_t w = w_s + ((2 * ta + c) * P::CHUNKS + chunk) * P::W_STEP;
#pragma unroll
        for (int k = 0; k < KCH / 16; ++k)
          wgmma(acc, sw128_desc(a + 32 * k), sw128_desc(w + 32 * k), s > 0 || ta > 0 || k > 0);
      }
      wgmma_commit();
      fence_operands(acc);
      if (s > 0) {
        wgmma_wait<1>();  // the previous stage's products are done with it
        if (leader) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (leader) mbar_arrive(empty + 8 * prev);

    // epilogue: round to bf16 in registers, stage in the swizzled layout of
    // the output map, one TMA store per 64 channels
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(1 + group);  // the previous tile's store has read the staging tile
    const int r0 = warp * 16 + lane / 4;  // accumulator rows r0 and r0 + 8
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        const int off = (j / 8) * P::O_HALF + row * ROW_BYTES + (((j % 8) ^ (row % 8)) * 16) +
                        (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(out_p + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + group);
    if (leader) {
      const int v0 = (t / tiles_w) * TV + 2 * group, w0 = (t % tiles_w) * TW;
#pragma unroll
      for (int h = 0; h < P::CHUNKS; ++h) tma_store_4d(&ymap, out + h * P::O_HALF, h * KCH, w0, v0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// bf16 tensor map: dims innermost first, strides in bytes of dims 1.., the
// 128-byte swizzle, zeros for every element outside the tensor.
bool encode(CUtensorMap* map, const void* ptr, uint32_t rank, const uint64_t* dims,
            const uint64_t* strides, const uint32_t* box) {
  const cg::EncodeTiled fn = encode_tiled();
  const uint32_t elem[4] = {1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
int launch_wgmma(const void* x, const void* kt, void* y, int64_t B, int64_t n, int64_t n_out,
                 int pad0, int64_t kt_sets, cudaStream_t st) {
  using P = Plan<C>;
  const uint64_t row = C * 2;
  const uint64_t xd[4] = {C, uint64_t(n), uint64_t(n), uint64_t(B)};
  const uint64_t xs[3] = {row, row * n, row * n * n};
  const uint32_t xb[4] = {KCH, TW, TV + 1, 1};
  const uint64_t yd[4] = {C, uint64_t(n_out), uint64_t(n_out), uint64_t(B)};
  const uint64_t ys[3] = {row, row * n_out, row * n_out * n_out};
  const uint32_t yb[4] = {KCH, TW, TV / CONSUMERS, 1};  // one consumer warpgroup's rows
  const uint64_t wd[3] = {C, C, uint64_t(4 * kt_sets)};  // [sets x taps, out, in]
  const uint64_t ws[2] = {row, row * C};
  const uint32_t wb[3] = {KCH, C, 1};
  CUtensorMap xmap, ymap, wmap;
  if (!encode(&xmap, x, 4, xd, xs, xb) || !encode(&ymap, y, 4, yd, ys, yb) ||
      !encode(&wmap, kt, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(s2d_conv2x2_wgmma_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = static_cast<int>((n_out + TW - 1) / TW);
  const int tiles = tiles_w * static_cast<int>((n_out + TV - 1) / TV);
  // about one block per SM, each on a contiguous run of one sample's tiles
  const int per_sample = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(tiles, sms / B)));
  s2d_conv2x2_wgmma_kernel<C><<<static_cast<unsigned>(B * per_sample), THREADS, P::BYTES, st>>>(
      xmap, wmap, ymap, pad0, tiles_w, tiles, per_sample, kt_sets == 1 ? 1 : 0);
  return 0;
}

// ---- C = 256 with one shared weight set: the weights streamed by TMA
//
// The resident-weight design above cannot hold one set at C = 256 (4 taps x
// 256 x 256 bf16 = 512 KiB, over the 227 KB opt-in). Here K is walked as
// (c, chunk) A stages of 64 channels, as above, and each stage meets its two
// taps (0, c) and (1, c) in two B slabs of [256 out x 64 in] (32 KB) that
// TMA streams into a ring of their own: 16 slabs a tile, every tile re-reads
// the 512 KiB set, from L2 (50 MB). Two consumer warpgroups each hold a
// 64 x 256 fp32 accumulator (128 registers a thread) and issue wgmma
// m64n256k16; one producer thread keeps both rings full. The grid is
// persistent over every SM: block i takes a contiguous run of the B x tiles
// output tiles (samples back to back, since the weights are shared), so one
// tile's epilogue overlaps the next tile's loads. Shared memory: 3 A stages
// (60 KB) + 3 B stages (96 KB) + 2 x 32 KB output staging + barriers.
// Bound at BigGAN-deep-256's [64,129,129,256]: 5.5e11 operations (0.556 ms
// at 989 TFLOP/s) against 1.08e9 bytes (0.32 ms): operations bind. On an
// H100 it runs at about two thirds of that, level with cuDNN (PERF.md).
namespace stream {

constexpr int C = 256;
constexpr int CHUNKS = C / KCH;                 // 64-channel chunks of one tap's K
constexpr int STEPS = 2 * CHUNKS;               // A stages per tile: (c, chunk)
constexpr int A_STAGES = 3, B_STAGES = 3;
constexpr int B_STAGE = C * ROW_BYTES;          // one (tap, chunk) slab
constexpr int O_HALF = 64 * ROW_BYTES;          // 64 rows x 64 channels of output
constexpr int O_GROUP = CHUNKS * O_HALF;
constexpr int B_OFF = A_STAGES * STAGE_BYTES;
constexpr int O_OFF = B_OFF + B_STAGES * B_STAGE;
constexpr int BAR_OFF = O_OFF + CONSUMERS * O_GROUP;
constexpr int BYTES = BAR_OFF + 4 * (A_STAGES + B_STAGES) * 8 + 1024;  // + alignment slack
static_assert(BYTES <= 232448, "over the 227 KB shared-memory opt-in");

__global__ void __launch_bounds__(THREADS, 1)
    s2d_conv2x2_wgmma_stream_kernel(const __grid_constant__ CUtensorMap xmap,
                                    const __grid_constant__ CUtensorMap wmap,
                                    const __grid_constant__ CUtensorMap ymap, int pad0,
                                    int tiles_w, int tiles, int64_t total) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_s = base, b_s = base + B_OFF, o_s = base + O_OFF;
  const uint32_t a_full = base + BAR_OFF;           // A_STAGES barriers: stage loaded
  const uint32_t a_empty = a_full + 8 * A_STAGES;   // stage consumed by both warpgroups
  const uint32_t b_full = a_empty + 8 * A_STAGES;
  const uint32_t b_empty = b_full + 8 * B_STAGES;

  const int64_t g_begin = total * blockIdx.x / gridDim.x;
  const int64_t g_end = total * (blockIdx.x + 1) / gridDim.x;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (group == CONSUMERS) {
    // producer: one thread issues every TMA load of the block, in the order
    // the consumers take them (A stage, then its two B slabs)
    if (threadIdx.x != CONSUMERS * 128) return;
    int as = 0, bs = 0;
    uint32_t ap = 0, bp = 0;
    for (int64_t g = g_begin; g < g_end; ++g) {
      const int b = static_cast<int>(g / tiles), t = static_cast<int>(g % tiles);
      const int v0 = (t / tiles_w) * TV, w0 = (t % tiles_w) * TW;
      for (int s = 0; s < STEPS; ++s) {  // s = c * CHUNKS + chunk
        const int c = s / CHUNKS, chunk = s % CHUNKS;
        mbar_wait(a_empty + 8 * as, ap ^ 1);
        mbar_expect_tx(a_full + 8 * as, STAGE_BYTES);
        tma_load_4d(a_s + as * STAGE_BYTES, &xmap, a_full + 8 * as, chunk * KCH, w0 + c - pad0,
                    v0 - pad0, b);
        if (++as == A_STAGES) {
          as = 0;
          ap ^= 1;
        }
        for (int ta = 0; ta < 2; ++ta) {  // tap (ta, c): weight slab 2 * ta + c
          mbar_wait(b_empty + 8 * bs, bp ^ 1);
          mbar_expect_tx(b_full + 8 * bs, B_STAGE);
          tma_load_3d(b_s + bs * B_STAGE, &wmap, b_full + 8 * bs, chunk * KCH, 0, 2 * ta + c);
          if (++bs == B_STAGES) {
            bs = 0;
            bp ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup `group` owns tile rows [64 group, 64 group + 64)
  float acc[C / 2] = {};
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t out = o_s + group * O_GROUP;
  unsigned char* out_p = smem + O_OFF + group * O_GROUP;
  int as = 0, bs = 0;
  uint32_t ap = 0, bp = 0;
  for (int64_t g = g_begin; g < g_end; ++g) {
    int prev_b = -1, prev_a = -1;  // the stages the last committed group reads
    for (int s = 0; s < STEPS; ++s) {
      mbar_wait(a_full + 8 * as, ap);
      for (int ta = 0; ta < 2; ++ta) {
        mbar_wait(b_full + 8 * bs, bp);
        fence_operands(acc);
        wgmma_fence();
        const uint32_t a = a_s + as * STAGE_BYTES + (ta * TW + group * 64) * ROW_BYTES;
        const uint32_t w = b_s + bs * B_STAGE;
#pragma unroll
        for (int k = 0; k < KCH / 16; ++k)
          wgmma(acc, sw128_desc(a + 32 * k), sw128_desc(w + 32 * k), s > 0 || ta > 0 || k > 0);
        wgmma_commit();
        fence_operands(acc);
        if (prev_b >= 0) {
          wgmma_wait<1>();  // the previous group is done with its stages
          if (leader) {
            mbar_arrive(b_empty + 8 * prev_b);
            if (prev_a >= 0) mbar_arrive(a_empty + 8 * prev_a);
          }
        }
        prev_b = bs;
        prev_a = ta == 1 ? as : -1;  // the A stage is free after its second tap
        if (++bs == B_STAGES) {
          bs = 0;
          bp ^= 1;
        }
      }
      if (++as == A_STAGES) {
        as = 0;
        ap ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (leader) {
      mbar_arrive(b_empty + 8 * prev_b);
      mbar_arrive(a_empty + 8 * prev_a);
    }

    // epilogue, as the resident-weight kernel's: round to bf16 in registers,
    // stage in the swizzled layout of the output map, one TMA store per 64
    // channels
    const int b = static_cast<int>(g / tiles), t = static_cast<int>(g % tiles);
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(1 + group);  // the previous tile's store has read the staging tile
    const int r0 = warp * 16 + lane / 4;  // accumulator rows r0 and r0 + 8
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        const int off = (j / 8) * O_HALF + row * ROW_BYTES + (((j % 8) ^ (row % 8)) * 16) +
                        (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(out_p + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + group);
    if (leader) {
      const int v0 = (t / tiles_w) * TV + 2 * group, w0 = (t % tiles_w) * TW;
#pragma unroll
      for (int h = 0; h < CHUNKS; ++h) tma_store_4d(&ymap, out + h * O_HALF, h * KCH, w0, v0, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int launch(const void* x, const void* kt, void* y, int64_t B, int64_t n, int64_t n_out, int pad0,
           cudaStream_t st) {
  const uint64_t row = C * 2;
  const uint64_t xd[4] = {C, uint64_t(n), uint64_t(n), uint64_t(B)};
  const uint64_t xs[3] = {row, row * n, row * n * n};
  const uint32_t xb[4] = {KCH, TW, TV + 1, 1};
  const uint64_t yd[4] = {C, uint64_t(n_out), uint64_t(n_out), uint64_t(B)};
  const uint64_t ys[3] = {row, row * n_out, row * n_out * n_out};
  const uint32_t yb[4] = {KCH, TW, TV / CONSUMERS, 1};
  const uint64_t wd[3] = {C, C, 4};  // [taps, out, in]
  const uint64_t ws[2] = {row, row * C};
  const uint32_t wb[3] = {KCH, C, 1};
  CUtensorMap xmap, ymap, wmap;
  if (!encode(&xmap, x, 4, xd, xs, xb) || !encode(&ymap, y, 4, yd, ys, yb) ||
      !encode(&wmap, kt, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(s2d_conv2x2_wgmma_stream_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = static_cast<int>((n_out + TW - 1) / TW);
  const int tiles = tiles_w * static_cast<int>((n_out + TV - 1) / TV);
  const int64_t total = B * tiles;
  const int64_t blocks = std::min<int64_t>(total, cg::sm_count());
  s2d_conv2x2_wgmma_stream_kernel<<<static_cast<unsigned>(blocks), THREADS, BYTES, st>>>(
      xmap, wmap, ymap, pad0, tiles_w, tiles, total);
  return 0;
}

}  // namespace stream

}  // namespace wg

}  // namespace

// The wgmma variant: bf16, C in {64, 128}. kt: [kt_sets, 2, 2, C, C] bf16
// with each tap stored [out, in]; kt_sets = B (per-sample weights) or 1 (one
// set for every sample). x, kt and y contiguous and 16-byte aligned.
extern "C" int cg_s2d_conv2x2_wgmma(const void* x, const void* kt, void* y, int64_t B, int64_t n,
                                    int64_t n_out, int64_t C, int pad0, int64_t kt_sets,
                                    void* stream) {
  if (B * n_out == 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if ((C != 64 && C != 128) || (kt_sets != 1 && kt_sets != B) || B > (1 << 24) ||
      n > (1 << 15) || (pad0 != 0 && pad0 != 1) || n_out != (pad0 ? n + 1 : n - 1) ||
      misaligned(x) || misaligned(kt) || misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int status = C == 128 ? wg::launch_wgmma<128>(x, kt, y, B, n, n_out, pad0, kt_sets, st)
                              : wg::launch_wgmma<64>(x, kt, y, B, n, n_out, pad0, kt_sets, st);
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}

// The wgmma_stream variant: bf16, C = 256, one weight set kt [2, 2, C, C]
// bf16 (each tap [out, in]) for every sample. x, kt and y contiguous and
// 16-byte aligned.
extern "C" int cg_s2d_conv2x2_wgmma_stream(const void* x, const void* kt, void* y, int64_t B,
                                           int64_t n, int64_t n_out, int64_t C, int pad0,
                                           void* stream) {
  if (B * n_out == 0) return 0;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (C != 256 || B > (1 << 24) || n > (1 << 15) || (pad0 != 0 && pad0 != 1) ||
      n_out != (pad0 ? n + 1 : n - 1) || misaligned(x) || misaligned(kt) || misaligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  const int status = wg::stream::launch(x, kt, y, B, n, n_out, pad0,
                                        static_cast<cudaStream_t>(stream));
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
