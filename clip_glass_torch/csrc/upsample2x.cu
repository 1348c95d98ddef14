// 2x FIR upsampling with a separable 4-tap filter (upfirdn2d, up=2):
// [B,H,W,C] -> [B,2H,2W,C], NHWC.
//
// Replaces the TPU kernel clip_glass_tpu/ops/pallas/upfirdn2d.py, function
// upsample2x_pallas.
//
// Zero-stuffing followed by the 4-tap filter reduces, per axis, to a
// polyphase pair of 2-tap stencils (k = normalized taps * 2 * sqrt(gain)):
//   out[2m]   = k1 * x[m-1] + k3 * x[m]
//   out[2m+1] = k0 * x[m-1] + k2 * x[m]
// with x[-1] = 0. Each output value reads a 2x2 input window.
//
// Bound: bytes. 8 multiply-adds per output value; the floor is
// (|x| + |out|) = 5|x| over 3.35 TB/s on an H100 SXM (0.038 ms at
// [16,512,512,3] in bf16). Below about 128 px the floor is the launch
// itself, a few microseconds on the device. The interleaved output is
// written directly (the TPU kernel wrote four phase planes and left the
// interleave to a separate pass). Math in fp32, one rounding.
//
// Two kernels, chosen by the wrapper from dtype and shape:
//
// "tiled" (cg_upsample2x_tiled; rows of at most 6.4 KB: the RGB-skip calls
// of the flagship from 32 px up). An NHWC row is a flat run of W*C values and the column
// neighbour q-1 is the same run shifted by C values.
//  - Each input value is read from device memory once per tile: a tile is
//    R <= 8 whole input rows of one sample plus the row above, one
//    contiguous range, copied into shared memory with 16-byte cp.async
//    where the row's byte length allows (plain loads otherwise; zeros for
//    the row above the first).
//  - A thread owns 16 bytes of the output row (8 bf16) and walks down up to
//    4 input rows: it filters each input row horizontally once, keeps the
//    row above's result in registers, and writes the two output rows 2m and
//    2m+1 from the pair as 16-byte stores. The column indices, the tap
//    parities and the one division by C (a constant for C = 3) are computed
//    once per 16 bytes of column, not per value.
//  - A persistent grid of at most 3 blocks per SM walks the tiles with two
//    stages: the next tile's copy overlaps this tile's arithmetic.
//
// "rows" (cg_upsample2x; any row length: the first design, and the one for
// launch-sized inputs, where its single round trip to memory wins). One
// thread per output value, one block row per output row, the 2x2 window
// read from global memory with scalar loads.
#include "common.cuh"

namespace {

template <typename T>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n_rows,
                                  int H, int W, int C, float k0, float k1, float k2,
                                  float k3) {
  const int row_len = 2 * W * C;  // output row, contiguous
  const int64_t in_row = static_cast<int64_t>(W) * C;
  for (int64_t orow = blockIdx.y; orow < n_rows; orow += gridDim.y) {
    const int64_t b = orow / (2 * H);
    const int oy = static_cast<int>(orow - b * 2 * H);
    const int m = oy >> 1;
    const float ra = (oy & 1) ? k0 : k1;  // weight of input row m-1
    const float rb = (oy & 1) ? k2 : k3;  // weight of input row m
    const T* x_m = x + (b * H + m) * in_row;
    const T* x_m1 = x_m - in_row;
    T* o = out + orow * row_len;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < row_len;
         e += gridDim.x * blockDim.x) {
      const int ox = e / C;
      const int c = e - ox * C;
      const int q = ox >> 1;
      const float ca = (ox & 1) ? k0 : k1;  // weight of input column q-1
      const float cb = (ox & 1) ? k2 : k3;  // weight of input column q
      const int ia = (q - 1) * C + c;
      const int ib = q * C + c;
      float v = rb * (cb * cg::to_float(x_m[ib]) + (q > 0 ? ca * cg::to_float(x_m[ia]) : 0.f));
      if (m > 0) {
        v += ra * (cb * cg::to_float(x_m1[ib]) + (q > 0 ? ca * cg::to_float(x_m1[ia]) : 0.f));
      }
      o[e] = cg::from_float<T>(v);
    }
  }
}

template <typename T>
void launch(const void* x, void* out, int64_t B, int64_t H, int64_t W, int64_t C, float k0,
            float k1, float k2, float k3, cudaStream_t st) {
  const int threads = 256;
  const int64_t row_len = 2 * W * C;
  const int64_t n_rows = B * 2 * H;
  dim3 grid(cg::grid_blocks(row_len, threads, 1 << 16),
            static_cast<unsigned>(n_rows < 65535 ? n_rows : 65535));
  upsample2x_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_rows, static_cast<int>(H),
      static_cast<int>(W), static_cast<int>(C), k0, k1, k2, k3);
}

// --------------------------------------------------------------- "tiled"

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 3;  // the register budget's; a launch may use fewer
constexpr int TILE_ROWS = 8;            // input rows per tile (4 for long rows)
constexpr int SEG_ROWS = 4;             // input rows a thread walks down
constexpr int STAGE_BYTES = 32 * 1024;  // one stage: the tile's rows and the row above

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Tile {
  int b, m0, rows;  // sample, first input row, input rows
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_per_sample, int R, int H) {
  Tile t;
  t.b = tile / tiles_per_sample;
  t.m0 = (tile - t.b * tiles_per_sample) * R;
  t.rows = H - t.m0 < R ? H - t.m0 : R;
  return t;
}

// Copy input rows m0-1 .. m0+rows-1 of sample b (zeros for row -1) to buf.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, T* buf, const Tile& t, int H,
                                          int rowlen, bool in_vec) {
  constexpr int VO = 16 / sizeof(T);
  const int first = t.m0 == 0 ? 1 : 0;
  if (first) {
    for (int i = threadIdx.x; i < rowlen; i += THREADS) buf[i] = cg::from_float<T>(0.f);
  }
  const T* src = x + (static_cast<int64_t>(t.b) * H + t.m0 - 1 + first) * rowlen;
  T* dst = buf + first * rowlen;
  const int n = (t.rows + 1 - first) * rowlen;
  if (in_vec) {
    for (int i = threadIdx.x * VO; i < n; i += THREADS * VO) cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

// CT = C at compile time, or 0 for any C.
template <typename T, int CT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    upsample2x_tiled_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int rowlen,
                            int C_any, int R, int tiles_per_sample, int n_tiles,
                            int stage_elems, int in_vec, int out_vec, float k0, float k1,
                            float k2, float k3) {
  constexpr int VO = 16 / sizeof(T);  // values per 16 bytes of output
  extern __shared__ int4 smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);
  const int C = CT ? CT : C_any;
  const int out_len = 2 * rowlen;
  const int NV = (out_len + VO - 1) / VO;

  int tile = blockIdx.x;
  load_tile(x, stages, tile_at(tile, tiles_per_sample, R, H), H, rowlen, in_vec != 0);
  cp_async_commit();
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const T* buf = stages + (it & 1) * stage_elems;
    const int next = tile + gridDim.x;
    if (next < n_tiles) {  // the other stage was read two barriers ago
      load_tile(x, stages + ((it + 1) & 1) * stage_elems,
                tile_at(next, tiles_per_sample, R, H), H, rowlen, in_vec != 0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const Tile t = tile_at(tile, tiles_per_sample, R, H);
    const int segs = (t.rows + SEG_ROWS - 1) / SEG_ROWS;
    for (int item = threadIdx.x; item < segs * NV; item += THREADS) {
      const int seg = item / NV;
      const int e0 = (item - seg * NV) * VO;  // first output value of this column vector
      // per value of the vector: input index of column q (ib) and of q-1
      // (ia; ib again where q-1 is the zero column), and the tap pair
      int ib[VO], ia[VO];
      float wa[VO], wb[VO];
      unsigned zero_a = 0;  // bit j: column q-1 of value j is zero
      int ox = e0 / C;
      int c = e0 - ox * C;
#pragma unroll
      for (int j = 0; j < VO; ++j) {
        const int q = ox >> 1;
        const bool valid = e0 + j < out_len;
        ib[j] = valid ? q * C + c : 0;
        const bool edge = q == 0 || !valid;
        ia[j] = edge ? ib[j] : ib[j] - C;
        zero_a |= (edge ? 1u : 0u) << j;
        wa[j] = (ox & 1) ? k0 : k1;
        wb[j] = (ox & 1) ? k2 : k3;
        if (++c == C) {
          c = 0;
          ++ox;
        }
      }
      const int r0 = seg * SEG_ROWS;
      const int r1 = r0 + SEG_ROWS < t.rows ? r0 + SEG_ROWS : t.rows;
      const T* srow = buf + r0 * rowlen;  // buf row i is input row m0-1+i
      float above[VO];
#pragma unroll
      for (int j = 0; j < VO; ++j) {
        const float xa = (zero_a >> j) & 1u ? 0.f : cg::to_float(srow[ia[j]]);
        above[j] = wb[j] * cg::to_float(srow[ib[j]]) + wa[j] * xa;
      }
      T* o = out + ((static_cast<int64_t>(t.b) * 2 * H + 2 * (t.m0 + r0)) * out_len + e0);
      const int n_valid = out_len - e0 < VO ? out_len - e0 : VO;
      for (int r = r0; r < r1; ++r) {
        srow += rowlen;
        float here[VO];
#pragma unroll
        for (int j = 0; j < VO; ++j) {
          const float xa = (zero_a >> j) & 1u ? 0.f : cg::to_float(srow[ia[j]]);
          here[j] = wb[j] * cg::to_float(srow[ib[j]]) + wa[j] * xa;
        }
#pragma unroll
        for (int par = 0; par < 2; ++par) {  // output rows 2m and 2m+1
          const float ra = par ? k0 : k1;
          const float rb = par ? k2 : k3;
          cg::Vec<T, VO> v;
#pragma unroll
          for (int j = 0; j < VO; ++j) v.v[j] = cg::from_float<T>(ra * above[j] + rb * here[j]);
          if (out_vec) {
            *reinterpret_cast<cg::Vec<T, VO>*>(o) = v;
          } else {
#pragma unroll
            for (int j = 0; j < VO; ++j) {
              if (j < n_valid) o[j] = v.v[j];
            }
          }
          o += out_len;
        }
#pragma unroll
        for (int j = 0; j < VO; ++j) above[j] = here[j];
      }
    }
    __syncthreads();
  }
}

template <typename T, int CT>
int launch_tiled(const void* x, void* out, int64_t B, int64_t H, int64_t W, int64_t C, float k0,
                 float k1, float k2, float k3, cudaStream_t st) {
  constexpr int VO = 16 / sizeof(T);
  const int64_t rowlen = W * C;
  const int64_t row_bytes = rowlen * sizeof(T);
  if ((SEG_ROWS + 1) * row_bytes > STAGE_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  int64_t R = (TILE_ROWS + 1) * row_bytes <= STAGE_BYTES ? TILE_ROWS : SEG_ROWS;
  if (R > H) R = H;
  const int64_t tiles_per_sample = (H + R - 1) / R;
  const int64_t n_tiles = B * tiles_per_sample;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t stage_elems = ((R + 1) * rowlen + VO - 1) / VO * VO;
  const size_t smem = 2 * stage_elems * sizeof(T);
  // above 48 KB of dynamic shared memory: opt in once a card (the
  // attribute is the current device's)
  static bool opted_in[cg::kMaxDevices] = {};
  const int dev = cg::current_device();
  if (dev < 0 || !opted_in[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(upsample2x_tiled_kernel<T, CT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * STAGE_BYTES + 32);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0) opted_in[dev] = true;
  }
  // 16-byte copies and stores where every row starts on a 16-byte line
  const bool in_vec = row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool out_vec = (2 * rowlen) % VO == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  // k blocks per SM share its bandwidth, and the busiest block walks
  // ceil(n_tiles / (SMs * k)) tiles: take the k with the least product
  // (1024 tiles on 132 SMs: 4 x 2 beats 3 x 3), the larger k on a tie
  int64_t grid = 0, best = 0;
  for (int k = BLOCKS_PER_SM; k >= 1; --k) {
    const int64_t slots = static_cast<int64_t>(cg::sm_count()) * k;
    const int64_t cost = (n_tiles + slots - 1) / slots * k;
    if (grid == 0 || cost < best) {
      best = cost;
      grid = slots;
    }
  }
  if (grid > n_tiles) grid = n_tiles;
  upsample2x_tiled_kernel<T, CT><<<static_cast<unsigned>(grid), THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<int>(H),
      static_cast<int>(rowlen), static_cast<int>(C), static_cast<int>(R),
      static_cast<int>(tiles_per_sample), static_cast<int>(n_tiles),
      static_cast<int>(stage_elems), in_vec ? 1 : 0, out_vec ? 1 : 0, k0, k1, k2, k3);
  return 0;
}

}  // namespace

// The first design, for any row length.
extern "C" int cg_upsample2x(const void* x, void* out, int64_t B, int64_t H, int64_t W,
                             int64_t C, float k0, float k1, float k2, float k3, int dtype,
                             void* stream) {
  if (B * H * W * C == 0) return 0;
  if (2 * W * C > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cg::kBFloat16) {
    launch<__nv_bfloat16>(x, out, B, H, W, C, k0, k1, k2, k3, st);
  } else if (dtype == cg::kFloat32) {
    launch<float>(x, out, B, H, W, C, k0, k1, k2, k3, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tiled kernel. The caller guarantees that five input rows fit one
// 32 KB stage: 5 * W * C * itemsize <= 32768.
extern "C" int cg_upsample2x_tiled(const void* x, void* out, int64_t B, int64_t H, int64_t W,
                                   int64_t C, float k0, float k1, float k2, float k3,
                                   int dtype, void* stream) {
  if (B * H * W * C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status;
  if (dtype == cg::kBFloat16) {
    status = C == 3 ? launch_tiled<__nv_bfloat16, 3>(x, out, B, H, W, C, k0, k1, k2, k3, st)
                    : launch_tiled<__nv_bfloat16, 0>(x, out, B, H, W, C, k0, k1, k2, k3, st);
  } else if (dtype == cg::kFloat32) {
    status = C == 3 ? launch_tiled<float, 3>(x, out, B, H, W, C, k0, k1, k2, k3, st)
                    : launch_tiled<float, 0>(x, out, B, H, W, C, k0, k1, k2, k3, st);
  } else {
    status = static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
