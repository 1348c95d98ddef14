// Fused noise injection + bias + leaky ReLU + gain: the epilogue of every
// StyleGAN2 synthesis layer.
//
//   out[b,h,w,c] = lrelu_alpha(x[b,h,w,c] + ns * noise[h,w] + bias[c]) * gain
//
// Replaces the TPU kernel clip_glass_tpu/ops/pallas/fused_bias_act.py,
// function noise_bias_lrelu_pallas.
//
// Bound: bytes. Each element is read once and written once with a handful of
// fp32 operations, far below the card's ~295 operations per byte, so the
// floor is (|x| + |out|) / 3.35 TB/s on an H100 SXM.
//
// Design: one pass over NHWC, one thread per 16-byte group of channels
// (8 bf16 or 4 fp32 values of one pixel), so every load and store is a
// full-width coalesced access and the per-pixel noise value is read once per
// group. The noise scale is read from device memory, never copied to the
// host. The math runs in fp32 and rounds once to the output type.
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void noise_bias_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ noise,
                                        const T* __restrict__ ns, const T* __restrict__ bias,
                                        T* __restrict__ out, int64_t n_vec, int64_t hw,
                                        int64_t c_vec, float alpha, float gain) {
  using V = cg::Vec<T, VEC>;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* bv = reinterpret_cast<const V*>(bias);
  V* ov = reinterpret_cast<V*>(out);
  const float s = cg::to_float(ns[0]);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const int64_t pix = i / c_vec;
    const int64_t cv = i - pix * c_vec;
    const float nz = s * cg::to_float(noise[pix % hw]);
    const V a = xv[i];
    const V b = bv[cv];
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = cg::to_float(a.v[j]) + nz + cg::to_float(b.v[j]);
      v = v >= 0.f ? v : alpha * v;
      o.v[j] = cg::from_float<T>(v * gain);
    }
    ov[i] = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* noise, const void* ns, const void* bias, void* out,
            int64_t n, int64_t hw, int64_t c, float alpha, float gain, cudaStream_t st) {
  const int threads = 256;
  const int64_t n_vec = n / VEC;
  noise_bias_lrelu_kernel<T, VEC><<<cg::grid_blocks(n_vec, threads), threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(noise), static_cast<const T*>(ns),
      static_cast<const T*>(bias), static_cast<T*>(out), n_vec, hw, c / VEC, alpha, gain);
}

}  // namespace

// n = B*H*W*C elements, hw = H*W, c = C; vec = elements per access (the
// caller guarantees c % vec == 0 and 16-byte aligned pointers for vec > 1).
extern "C" int cg_noise_bias_lrelu(const void* x, const void* noise, const void* ns,
                                   const void* bias, void* out, int64_t n, int64_t hw,
                                   int64_t c, float alpha, float gain, int dtype, int vec,
                                   void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == cg::kBFloat16 && vec == 8) {
    launch<__nv_bfloat16, 8>(x, noise, ns, bias, out, n, hw, c, alpha, gain, st);
  } else if (dtype == cg::kBFloat16 && vec == 1) {
    launch<__nv_bfloat16, 1>(x, noise, ns, bias, out, n, hw, c, alpha, gain, st);
  } else if (dtype == cg::kFloat32 && vec == 4) {
    launch<float, 4>(x, noise, ns, bias, out, n, hw, c, alpha, gain, st);
  } else if (dtype == cg::kFloat32 && vec == 1) {
    launch<float, 1>(x, noise, ns, bias, out, n, hw, c, alpha, gain, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Error text for a status returned by any entry point of this library.
extern "C" const char* cg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
