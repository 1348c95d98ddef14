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
// (|x| + |out|) / 3.35 TB/s on an H100 SXM, and the output is 4x the input.
//
// Design: the interleaved output is written directly (the TPU kernel wrote
// four phase planes and left the interleave to a separate pass). One block
// row per output row: the row of 2W*C values is the contiguous axis, so
// with C = 3 (the RGB skip path) consecutive threads still store
// consecutive addresses, and the 2x2 window reads hit the two input rows
// that neighbouring threads share in L1. Math in fp32, one rounding.
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

}  // namespace

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
