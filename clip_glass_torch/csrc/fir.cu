// Stride-1 separable 4-tap FIR (upfirdn2d with up = down = 1, StyleGAN2's
// FilterLayer) on NHWC tensors, the zero padding read at the edges:
//   [B,H,W,C] -> [B,Ho,Wo,C], Ho = H + pad0 + pad1 - 3 (Wo alike),
//   out[b,y,x,c] = sum_i sum_j k[i] k[j] x[b, y+i-pad0, x+j-pad0, c],
// with x = 0 outside [0,H) x [0,W).
//
// Replaces no TPU kernel: the JAX package leaves this FIR to XLA's grouped
// conv (lax.conv_general_dilated with feature_group_count = C,
// clip_glass_tpu/ops/upfirdn.py:39-51). The port's first route, cuDNN's
// grouped direct conv on an NCHW view of a padded copy, with cuDNN's layout
// transforms around it, ran at about 3% of the bound below on the flagship.
//
// Bound: bytes. 8 multiply-adds per output value (4 along W, 4 along H)
// against 4 bytes read and written in bf16, far below the card's ridge:
// the floor is (|x| + |out|) / 3.35 TB/s on an H100 SXM (the flagship's 18
// calls an evaluation at pop 16: about 3.0 GB, 0.88 ms). Math in fp32, one
// rounding.
//
// Design, to move each byte once and keep enough of them in flight:
//  - "vector" (C a multiple of 16 bytes' values: every flagship call). A
//    block owns a tile of up to 32 output columns by 8 vectors of 16
//    bytes of channels (neighbouring threads on neighbouring channels, so a
//    warp's accesses are whole 128-byte lines) and walks down a strip of S
//    output rows. Its S + 3 input rows pass through a ring of 6 stages in
//    shared memory, each row of the tile plus its 3 halo columns copied
//    once by 16-byte cp.async (zeros where the row or column lies in the
//    padding), 5 rows ahead of the arithmetic: the bytes in flight are the
//    ring's, not the registers', so the loads keep HBM busy. A thread
//    reads its output column's 4 neighbours from the stage, forms their
//    horizontal 4-tap sum, adds it into three running output rows in
//    registers, and stores the fourth, rounded once.
//  - "scalar" (any C): the same walk with each thread on one value, its
//    4 neighbours loaded from global memory (the reuse along W served by
//    L1) one row ahead of the arithmetic.
//  - S is picked from the shape: the grid holds about 16 blocks an SM
//    (strips of 33 rows at 256 px, 2 rows at 32 px), so that the last wave
//    is short and a launch-sized call is one short round of loads.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// A block's place in the grid: blockIdx.x walks the channel chunks
// fastest, then the column tiles, the strips and the samples.
struct Place {
  int chunk, tile, strip;
  int64_t b;
};

__device__ __forceinline__ Place place(int chunks, int col_tiles, int strips) {
  int64_t bid = blockIdx.x;
  Place p;
  p.chunk = static_cast<int>(bid % chunks);
  bid /= chunks;
  p.tile = static_cast<int>(bid % col_tiles);
  bid /= col_tiles;
  p.strip = static_cast<int>(bid % strips);
  p.b = bid / strips;
  return p;
}

// Input row iy's 4 neighbours of a column from ix0 on, zeros in the padding.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ xb, int iy, int ix0, int H, int W,
                                         int C, float (&v)[4]) {
  const bool row_in = iy >= 0 && iy < H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ix = ix0 + j;
    v[j] = row_in && ix >= 0 && ix < W
               ? cg::to_float(xb[(static_cast<int64_t>(iy) * W + ix) * C])
               : 0.f;
  }
}

// "scalar": one block holds blockDim.x channels by blockDim.y output
// columns, a thread one value of one column.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    fir_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int Ho,
                    int Wo, int pad0, int S, int chunks, int col_tiles, int strips, float k0,
                    float k1, float k2, float k3) {
  const Place p = place(chunks, col_tiles, strips);
  const int c = p.chunk * blockDim.x + threadIdx.x;
  const int ox = p.tile * blockDim.y + threadIdx.y;
  if (c >= C || ox >= Wo) return;
  const int oy0 = p.strip * S;
  const int oy1 = oy0 + S < Ho ? oy0 + S : Ho;
  const T* xb = x + p.b * H * W * C + c;
  T* ob = out + (p.b * Ho * Wo + ox) * C + c;
  const int ix0 = ox - pad0;

  // a0, a1, a2: the running output rows iy+pad0-3, iy+pad0-2, iy+pad0-1 of
  // input row iy, each waiting for its taps k3, k2 and k1 from that row
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float cur[4], nxt[4];
  const int iy_last = oy1 + 2 - pad0;
  int iy = oy0 - pad0;
  load_row(xb, iy, ix0, H, W, C, cur);
  for (; iy <= iy_last; ++iy) {
    if (iy < iy_last) load_row(xb, iy + 1, ix0, H, W, C, nxt);
    const float h = k0 * cur[0] + k1 * cur[1] + k2 * cur[2] + k3 * cur[3];
    const int oy = iy + pad0 - 3;
    if (oy >= oy0) ob[static_cast<int64_t>(oy) * Wo * C] = cg::from_float<T>(a0 + k3 * h);
    a0 = a1 + k2 * h;
    a1 = a2 + k1 * h;
    a2 = k0 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
  }
}

constexpr int STAGES = 6;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = cg::smem_addr(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// "vector": one block holds blockDim.x vectors of channels by blockDim.y
// output columns; its dynamic shared memory, STAGES input rows of
// (blockDim.y + 3) x blockDim.x vectors.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    fir_tiled_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int Cv, int Ho,
                     int Wo, int pad0, int S, int chunks, int col_tiles, int strips, float k0,
                     float k1, float k2, float k3) {
  constexpr int VEC = 16 / sizeof(T);
  using V = cg::Vec<T, VEC>;
  extern __shared__ int4 smem_raw[];
  V* const stages = reinterpret_cast<V*>(smem_raw);
  const Place p = place(chunks, col_tiles, strips);
  const int tx = blockDim.x;
  const int row_vecs = (blockDim.y + 3) * tx;  // a stage: the tile's columns and halo
  const int nthreads = tx * blockDim.y;
  const int t = threadIdx.y * tx + threadIdx.x;
  const int oy0 = p.strip * S;
  const int oy1 = oy0 + S < Ho ? oy0 + S : Ho;
  const int iy0 = oy0 - pad0;
  const int nrows = oy1 - oy0 + 3;
  const int ix0 = p.tile * blockDim.y - pad0;
  const int cv0 = p.chunk * tx;
  const V* xb = reinterpret_cast<const V*>(x) + p.b * H * W * Cv;

  // input row iy0 + r into its stage, zeros in the padding
  auto load = [&](int r) {
    const int iy = iy0 + r;
    V* st = stages + (r % STAGES) * row_vecs;
    const bool row_in = iy >= 0 && iy < H;
    for (int v = t; v < row_vecs; v += nthreads) {
      const int col = v / tx;
      const int ix = ix0 + col, cv = cv0 + v - col * tx;
      const bool ok = row_in && ix >= 0 && ix < W && cv < Cv;
      cp_async16(st + v, ok ? xb + (static_cast<int64_t>(iy) * W + ix) * Cv + cv : xb, ok);
    }
  };
#pragma unroll
  for (int r = 0; r < STAGES - 1; ++r) {
    if (r < nrows) load(r);
    cp_async_commit();
  }
  const int cv = cv0 + threadIdx.x;
  const int ox = p.tile * blockDim.y + threadIdx.y;
  const bool mine = cv < Cv && ox < Wo;
  V* ob = reinterpret_cast<V*>(out) + (p.b * Ho * Wo + ox) * Cv + cv;
  // a0, a1, a2: the running output rows r-3, r-2, r-1 of input row r (of
  // the strip), each waiting for its taps k3, k2 and k1 from that row
  float a0[VEC], a1[VEC], a2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a0[e] = a1[e] = a2[e] = 0.f;
  for (int r = 0; r < nrows; ++r) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of row r have landed
    __syncthreads();              // everyone's; and row r-1's stage is free
    if (r + STAGES - 1 < nrows) load(r + STAGES - 1);
    cp_async_commit();
    if (!mine) continue;
    const V* st = stages + (r % STAGES) * row_vecs + threadIdx.y * tx + threadIdx.x;
    const V c0 = st[0], c1 = st[tx], c2 = st[2 * tx], c3 = st[3 * tx];
    float h[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      h[e] = k0 * cg::to_float(c0.v[e]) + k1 * cg::to_float(c1.v[e]) +
             k2 * cg::to_float(c2.v[e]) + k3 * cg::to_float(c3.v[e]);
    }
    if (r >= 3) {
      V o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = cg::from_float<T>(a0[e] + k3 * h[e]);
      ob[static_cast<int64_t>(oy0 + r - 3) * Wo * Cv] = o;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a0[e] = a1[e] + k2 * h[e];
      a1[e] = a2[e] + k1 * h[e];
      a2[e] = k0 * h[e];
    }
  }
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// vec: 16 / sizeof(T) for "vector", 1 for "scalar".
template <typename T>
int launch(const void* x, void* out, int64_t B, int64_t H, int64_t W, int64_t C, int64_t pad0,
           int64_t pad1, float k0, float k1, float k2, float k3, int vec, cudaStream_t st) {
  const int64_t Ho = H + pad0 + pad1 - 3, Wo = W + pad0 + pad1 - 3;
  if ((vec != 1 && vec != 16 / static_cast<int>(sizeof(T))) || C % vec || H > INT32_MAX ||
      W > INT32_MAX || C > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t Cv = C / vec;
  const int64_t tx_max = vec > 1 ? 8 : 32;
  const int64_t tx = Cv < tx_max ? Cv : tx_max;
  const int64_t col_tiles = ceil_div(Wo, MAX_THREADS / tx);
  const int64_t ty = ceil_div(Wo, col_tiles);  // the columns split evenly over the tiles
  const int64_t chunks = ceil_div(Cv, tx);
  // strips of S rows: about 16 blocks an SM in all
  const int64_t one_strip = B * chunks * col_tiles;
  int64_t strips = ceil_div(static_cast<int64_t>(cg::sm_count()) * 16, one_strip);
  if (strips > Ho) strips = Ho;
  const int64_t S = ceil_div(Ho, strips);
  strips = ceil_div(Ho, S);
  const int64_t blocks = one_strip * strips;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec > 1) {
    const size_t smem = STAGES * (ty + 3) * tx * 16;
    fir_tiled_kernel<T><<<grid, block, smem, st>>>(
        xt, ot, static_cast<int>(H), static_cast<int>(W), static_cast<int>(Cv),
        static_cast<int>(Ho), static_cast<int>(Wo), static_cast<int>(pad0), static_cast<int>(S),
        static_cast<int>(chunks), static_cast<int>(col_tiles), static_cast<int>(strips), k0, k1,
        k2, k3);
  } else {
    fir_rows_kernel<T><<<grid, block, 0, st>>>(
        xt, ot, static_cast<int>(H), static_cast<int>(W), static_cast<int>(C),
        static_cast<int>(Ho), static_cast<int>(Wo), static_cast<int>(pad0), static_cast<int>(S),
        static_cast<int>(chunks), static_cast<int>(col_tiles), static_cast<int>(strips), k0, k1,
        k2, k3);
  }
  return 0;
}

}  // namespace

// vec: values a thread owns, 16 / itemsize ("vector": C a multiple of it, x
// and out on 16-byte lines) or 1 ("scalar"). The caller checks pad0, pad1 >=
// 0 and an output of at least one pixel.
extern "C" int cg_fir(const void* x, void* out, int64_t B, int64_t H, int64_t W, int64_t C,
                      int64_t pad0, int64_t pad1, float k0, float k1, float k2, float k3,
                      int dtype, int vec, void* stream) {
  if (pad0 < 0 || pad1 < 0 || H + pad0 + pad1 < 4 || W + pad0 + pad1 < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * H * W * C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status;
  if (dtype == cg::kBFloat16) {
    status = launch<__nv_bfloat16>(x, out, B, H, W, C, pad0, pad1, k0, k1, k2, k3, vec, st);
  } else if (dtype == cg::kFloat32) {
    status = launch<float>(x, out, B, H, W, C, pad0, pad1, k0, k1, k2, k3, vec, st);
  } else {
    status = static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
