// Offset-lattice [2,2] convolution on space-to-depth tensors:
//
//   y[b,v,w,:] = sum_{a,c in {0,1}} x[b, v+a-pad0, w+c-pad0, :] @ Kb[b,a,c]
//
// x: [B,n,n,C], Kb: [B,2,2,C,C] (per-sample K * style * demod, folded by the
// wrapper in fp32 and rounded to x's dtype), y: [B,n_out,n_out,C] with
// n_out = n+1 (pad0 = 1) or n-1 (pad0 = 0). Cells outside x read zero. fp32
// accumulation, one rounding to x's dtype.
//
// Replaces the TPU kernel clip_glass_tpu/ops/pallas/s2d_conv2x2.py, function
// s2d_conv2x2_pallas: the same-resolution 3x3 convs of StyleGAN2's 512 and
// 1024 px levels, folded onto 4C = 128 channels between opposite lattices.
//
// Bound: per sample this is a dense GEMM, M = n_out^2 output cells, N = C,
// K = 4C. At the flagship (C = 128, bf16, pop 16) one 1024 px launch moves
// ~2.15e9 bytes (0.64 ms at 3.35 TB/s) and does 5.5e11 operations (0.56 ms
// at the 989 TFLOP/s bf16 tensor-core peak): bytes bind, narrowly, and only
// if the products run on the tensor cores (fp32 CUDA cores would take ~8 ms).
//
// Design (simple and right first; no wgmma/TMA yet): an implicit GEMM. A
// block owns BM consecutive output cells (row-major over v, w, so its rows
// of x are mostly contiguous) and BN output channels, and walks K as four
// taps times C in steps of BK. While staging the A tile each thread gathers
// its cell's shifted row of x for the current tap (zeros outside x: the
// halo, and the ragged last cells); the B tile is Kb[b, tap] rows k0..k0+BK.
// - bf16: tensor cores through nvcuda::wmma 16x16x16 bf16 fragments with fp32
//   accumulators; 8 warps, each a 32x32 sub-tile of the 64x128 block tile;
//   the fp32 tile goes through shared memory for a masked, rounded store.
// - fp32: a CUDA-core tile of 64x64, 4x4 outputs per thread, so that the
//   fp32 comparisons hold at 1e-5.
// C need not be a multiple of the tile: loads beyond C are zero and stores
// are masked. Loads are 16 bytes per thread when C allows (vec > 1).
#include "common.cuh"

#include <mma.h>

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
                            bf16* __restrict__ y, int n, int n_out, int C, int pad0) {
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
  const bf16* kbb = kb + static_cast<int64_t>(b) * 4 * C * C;

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
                           float* __restrict__ y, int n, int n_out, int C, int pad0) {
  __shared__ float As[FK][FM + 4];  // A transposed: As[k][cell]
  __shared__ float Bs[FK][FN + 4];

  const int b = blockIdx.z;
  const int64_t M = static_cast<int64_t>(n_out) * n_out;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * FM;
  const int n0 = blockIdx.y * FN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // 4x4 outputs each
  const float* xb = x + static_cast<int64_t>(b) * n * n * C;
  const float* kbb = kb + static_cast<int64_t>(b) * 4 * C * C;

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

template <int VEC>
int launch_bf16(const void* x, const void* kb, void* y, int64_t B, int64_t n, int64_t n_out,
                int64_t C, int pad0, cudaStream_t st) {
  const int64_t M = n_out * n_out;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((C + BN - 1) / BN),
            static_cast<unsigned>(B));
  s2d_conv2x2_bf16_kernel<VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(kb), static_cast<bf16*>(y),
      static_cast<int>(n), static_cast<int>(n_out), static_cast<int>(C), pad0);
  return 0;
}

template <int VEC>
int launch_f32(const void* x, const void* kb, void* y, int64_t B, int64_t n, int64_t n_out,
               int64_t C, int pad0, cudaStream_t st) {
  const int64_t M = n_out * n_out;
  dim3 grid(static_cast<unsigned>((M + FM - 1) / FM), static_cast<unsigned>((C + FN - 1) / FN),
            static_cast<unsigned>(B));
  s2d_conv2x2_f32_kernel<VEC><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(kb), static_cast<float*>(y),
      static_cast<int>(n), static_cast<int>(n_out), static_cast<int>(C), pad0);
  return 0;
}

}  // namespace

// vec = elements per 16-byte access (the caller guarantees C % vec == 0 and
// 16-byte aligned x, kb and y for vec > 1).
extern "C" int cg_s2d_conv2x2(const void* x, const void* kb, void* y, int64_t B, int64_t n,
                              int64_t n_out, int64_t C, int pad0, int dtype, int vec,
                              void* stream) {
  if (B * n_out * C == 0) return 0;
  if (B > 65535 || n_out * n_out > (int64_t(1) << 31) - BM || n > (1 << 30) ||
      (pad0 != 0 && pad0 != 1) || n_out != (pad0 ? n + 1 : n - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status;
  if (dtype == cg::kBFloat16 && vec == 8) {
    status = launch_bf16<8>(x, kb, y, B, n, n_out, C, pad0, st);
  } else if (dtype == cg::kBFloat16 && vec == 1) {
    status = launch_bf16<1>(x, kb, y, B, n, n_out, C, pad0, st);
  } else if (dtype == cg::kFloat32 && vec == 4) {
    status = launch_f32<4>(x, kb, y, B, n, n_out, C, pad0, st);
  } else if (dtype == cg::kFloat32 && vec == 1) {
    status = launch_f32<1>(x, kb, y, B, n, n_out, C, pad0, st);
  } else {
    status = static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
