// Modulated 1x1 convolution (StyleGAN2 ToRGB) as a per-pixel reduction:
//
//   y[b,p,o] = (sum_i x[b,p,i] * s[b,i] * w[i,o]) * d[b,o] + bias[o]
//
// x: [B,P,I], s: [B,I] (NULL = ones), w: [I,O], d: [B,O] (NULL = ones),
// bias: [O], y: [B,P,O]; fp32 accumulation.
//
// Replaces the TPU kernel clip_glass_tpu/ops/pallas/modulated_matmul.py,
// function modulated_matmul_pallas.
//
// Bound: bytes. On the ToRGB path O = 3, so the work is ~2*O = 6 operations
// per input value (3 per byte in bf16), two orders of magnitude below the
// ~295 operations per byte at which the tensor cores would become the limit.
// The floor is (|x| + |y|) / 3.35 TB/s on an H100 SXM; tensor cores would buy
// nothing, so this is not a GEMM.
//
// Design: x is read once, coalesced: a group of TPP consecutive threads
// (a power of two dividing the row) covers one pixel's row of I values in
// 16-byte vectors, and consecutive groups cover consecutive pixels. Each
// block first folds the style into the weights of its sample and output
// chunk (sw[o][i] = s[b,i] * w[i,o] in fp32, in shared memory, laid out so
// the TPP lanes of a group read consecutive words). Partial sums are reduced
// over the group with warp shuffles; one lane applies demod and bias and
// stores. Outputs are handled OC at a time (one chunk covers O = 3).
#include "common.cuh"

namespace {

constexpr int OC = 4;

template <typename T, int VEC>
__global__ void modulated_matmul_kernel(const T* __restrict__ x, const T* __restrict__ style,
                                        const T* __restrict__ w, const T* __restrict__ demod,
                                        const T* __restrict__ bias, T* __restrict__ out,
                                        int64_t P, int I, int O, int tpp) {
  // sw[(oo * VEC + j) * G + g] holds s[b,k] * w[k,o0+oo] for k = g*VEC + j
  extern __shared__ float sw[];
  const int G = I / VEC;
  const int b = blockIdx.y;
  const int o0 = blockIdx.z * OC;
  for (int k = threadIdx.x; k < I; k += blockDim.x) {
    const float s = style != nullptr ? cg::to_float(style[static_cast<int64_t>(b) * I + k]) : 1.f;
    const int g = k / VEC;
    const int j = k - g * VEC;
#pragma unroll
    for (int oo = 0; oo < OC; ++oo) {
      const int o = o0 + oo;
      sw[(oo * VEC + j) * G + g] = o < O ? s * cg::to_float(w[static_cast<int64_t>(k) * O + o]) : 0.f;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % tpp;
  const int pix_per_block = blockDim.x / tpp;
  const T* xb = x + static_cast<int64_t>(b) * P * I;
  // every thread of the block runs the same trip count, so the shuffles
  // below always see a full warp
  const int64_t pix_per_iter = static_cast<int64_t>(gridDim.x) * pix_per_block;
  const int64_t n_iter = (P + pix_per_iter - 1) / pix_per_iter;
  for (int64_t it = 0; it < n_iter; ++it) {
    const int64_t p = it * pix_per_iter + static_cast<int64_t>(blockIdx.x) * pix_per_block +
                      threadIdx.x / tpp;
    float acc[OC];
#pragma unroll
    for (int oo = 0; oo < OC; ++oo) acc[oo] = 0.f;
    if (p < P) {
      const T* xr = xb + p * I;
      for (int g = lane; g < G; g += tpp) {
        const cg::Vec<T, VEC> v = *reinterpret_cast<const cg::Vec<T, VEC>*>(xr + g * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xv = cg::to_float(v.v[j]);
#pragma unroll
          for (int oo = 0; oo < OC; ++oo) acc[oo] += xv * sw[(oo * VEC + j) * G + g];
        }
      }
    }
    for (int off = tpp >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int oo = 0; oo < OC; ++oo) acc[oo] += __shfl_xor_sync(0xffffffffu, acc[oo], off);
    }
    if (p < P && lane == 0) {
      T* yr = out + (static_cast<int64_t>(b) * P + p) * O;
#pragma unroll
      for (int oo = 0; oo < OC; ++oo) {
        const int o = o0 + oo;
        if (o < O) {
          const float d =
              demod != nullptr ? cg::to_float(demod[static_cast<int64_t>(b) * O + o]) : 1.f;
          yr[o] = cg::from_float<T>(acc[oo] * d + cg::to_float(bias[o]));
        }
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* style, const void* w, const void* demod, const void* bias,
           void* out, int64_t B, int64_t P, int64_t I, int64_t O, cudaStream_t st) {
  const int threads = 256;
  const int G = static_cast<int>(I / VEC);
  int tpp = 1;  // largest power of two <= 32 dividing the row's vector count
  while (tpp < 32 && G % (tpp * 2) == 0) tpp *= 2;
  const int pix_per_block = threads / tpp;
  // ~8 blocks per SM over the whole batch; each block strides over pixels
  int64_t per_sample = (132 * 8 + B - 1) / B;
  const int64_t need = (P + pix_per_block - 1) / pix_per_block;
  if (per_sample > need) per_sample = need;
  if (per_sample < 1) per_sample = 1;
  const size_t smem = sizeof(float) * OC * static_cast<size_t>(I);
  if (smem > 48 * 1024 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(per_sample), static_cast<unsigned>(B),
            static_cast<unsigned>((O + OC - 1) / OC));
  modulated_matmul_kernel<T, VEC><<<grid, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(style), static_cast<const T*>(w),
      static_cast<const T*>(demod), static_cast<const T*>(bias), static_cast<T*>(out), P,
      static_cast<int>(I), static_cast<int>(O), tpp);
  return 0;
}

}  // namespace

// vec = elements per x access (the caller guarantees I % vec == 0 and a
// 16-byte aligned x for vec > 1).
extern "C" int cg_modulated_matmul(const void* x, const void* style, const void* w,
                                   const void* demod, const void* bias, void* out, int64_t B,
                                   int64_t P, int64_t I, int64_t O, int dtype, int vec,
                                   void* stream) {
  if (B * P * O == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status;
  if (dtype == cg::kBFloat16 && vec == 8) {
    status = launch<__nv_bfloat16, 8>(x, style, w, demod, bias, out, B, P, I, O, st);
  } else if (dtype == cg::kBFloat16 && vec == 1) {
    status = launch<__nv_bfloat16, 1>(x, style, w, demod, bias, out, B, P, I, O, st);
  } else if (dtype == cg::kFloat32 && vec == 4) {
    status = launch<float, 4>(x, style, w, demod, bias, out, B, P, I, O, st);
  } else if (dtype == cg::kFloat32 && vec == 1) {
    status = launch<float, 1>(x, style, w, demod, bias, out, B, P, I, O, st);
  } else {
    status = static_cast<int>(cudaErrorInvalidValue);
  }
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
