// BigGAN-deep's batch norm and the ReLU after it, one pass over x:
//
//   out[b,h,w,c] = relu(round(((x[b,h,w,c] (+) b_conv[c % C]) - mean[c % C])
//                             * rstd[c % C] * weight[b, c % C] + bias[b, c % C]))
//
// on NHWC x of Cx = phases * C channels (phases 4: an s2d tensor, whose
// channels are phase-major, so channel c reads the per-channel vectors at
// c % C), with (+) the preceding conv's bias added in fp32 and rounded to
// x's type, then the normalization in fp32, one rounding back to x's type
// and the ReLU. weight and bias are per sample ([B, C], row stride C) or
// shared ([C], row stride 0), in fp32, or in bf16 beside bf16 x.
//
// Replaces no TPU kernel: the JAX package leaves the conditional batch norm
// to XLA (clip_glass_tpu/models/biggan/model.py, _cond_bn_apply and
// _plain_bn_apply), which fuses it. The port's eager route ran eight passes
// over x (bias add, cast, subtract, two multiplies, add, cast, ReLU), about
// 50 bytes of traffic an element, most of them fp32 broadcasts that miss
// the vectorized path.
//
// Bound: bytes. Five fp32 operations an element against 4 (bf16) or 8
// (fp32) bytes read and written, far below the card's ~295 operations per
// byte: the floor is (|x| + |out|) / 3.35 TB/s on an H100 SXM.
//
// Numerics: bitwise those of the eager chain on the card. Each step is its
// own correctly rounded fp32 operation (__fadd_rn, __fsub_rn, __fmul_rn),
// never contracted into an FMA, in the eager chain's order.
//
// Design, to stream each byte once with enough of them in flight:
//  - one thread owns one 16-byte vector of channels (8 bf16 or 4 fp32; one
//    value where C is not a multiple of that) for the whole launch, so its
//    statistics, conv bias and affine sit in registers, read once;
//  - a block holds the channel vectors of 256 / (vectors a pixel) pixels and
//    one sample (blockIdx.y), so the per-sample affine needs no division;
//    it walks that sample's pixels in a grid-stride loop, 2 pixels' loads
//    issued before the first is used;
//  - the grid is one wave of resident blocks (the occupancy the compiler
//    allows, times the SMs) shared out over the samples and channel chunks,
//    so that no short last wave idles the card;
//  - x may be strided in b, h and w (channels contiguous); out is dense.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

template <typename T, typename A, int VEC, bool BCONV>
__global__ void __launch_bounds__(THREADS)
cond_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ b_conv,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const A* __restrict__ weight, const A* __restrict__ bias,
                    T* __restrict__ out, int64_t hw, int64_t W, int64_t Cx, int64_t C,
                    int64_t sxb, int64_t sxh, int64_t sxw, int64_t aff_stride, int lanes) {
  using V = cg::Vec<T, VEC>;
  const int rows = THREADS / lanes;
  const int tx = threadIdx.x % lanes;
  const int ty = threadIdx.x / lanes;
  const int64_t cx = (static_cast<int64_t>(blockIdx.z) * lanes + tx) * VEC;
  if (ty >= rows || cx >= Cx) return;
  const int64_t b = blockIdx.y;
  const int64_t c = cx % C;

  float m[VEC], r[VEC], g[VEC], o[VEC], bc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = __ldg(mean + c + j);
    r[j] = __ldg(rstd + c + j);
    g[j] = cg::to_float(weight[b * aff_stride + c + j]);
    o[j] = cg::to_float(bias[b * aff_stride + c + j]);
    bc[j] = BCONV ? cg::to_float(b_conv[c + j]) : 0.f;
  }
  const T* xb = x + b * sxb + cx;
  T* ob = out + b * hw * Cx + cx;
  const bool dense = W == hw;  // h and w collapsed into one stride
  const int64_t step = static_cast<int64_t>(gridDim.x) * rows;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.x) * rows + ty; q0 < hw;
       q0 += step * UNROLL) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t q = q0 + u * step;
      if (q < hw) {
        const int64_t off = dense ? q * sxw : (q / W) * sxh + (q % W) * sxw;
        v[u] = *reinterpret_cast<const V*>(xb + off);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t q = q0 + u * step;
      if (q < hw) {
        V y;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float t = cg::to_float(v[u].v[j]);
          if (BCONV) t = cg::to_float(cg::from_float<T>(__fadd_rn(t, bc[j])));
          t = __fsub_rn(t, m[j]);
          t = __fmul_rn(t, r[j]);
          t = __fmul_rn(t, g[j]);
          t = __fadd_rn(t, o[j]);
          t = cg::to_float(cg::from_float<T>(t));
          // torch.relu: clamp_min(t, 0), NaN kept
          y.v[j] = cg::from_float<T>(isnan(t) ? t : fmaxf(t, 0.f));
        }
        *reinterpret_cast<V*>(ob + q * Cx) = y;
      }
    }
  }
}

template <typename T, typename A, int VEC, bool BCONV>
int launch(const void* x, const void* b_conv, const float* mean, const float* rstd,
           const void* weight, const void* bias, void* out, int64_t B, int64_t hw, int64_t W,
           int64_t Cx, int64_t C, int64_t sxb, int64_t sxh, int64_t sxw, int64_t aff_stride,
           cudaStream_t st) {
  auto kernel = cond_bn_relu_kernel<T, A, VEC, BCONV>;
  static int per_sm = 0;  // resident blocks an SM, asked once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                        THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t n_vec = Cx / VEC;
  const int lanes = static_cast<int>(n_vec < THREADS ? n_vec : THREADS);
  const int rows = THREADS / lanes;
  const int64_t chunks = (n_vec + lanes - 1) / lanes;
  const int64_t wave = static_cast<int64_t>(cg::sm_count()) * per_sm;
  int64_t per_sample = wave / (B * chunks);  // floor: the wave never spills
  const int64_t needed = (hw + rows - 1) / rows;
  if (per_sample > needed) per_sample = needed;
  if (per_sample < 1) per_sample = 1;
  if (B > 65535 || chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(per_sample), static_cast<unsigned>(B),
                  static_cast<unsigned>(chunks));
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b_conv), mean, rstd,
      static_cast<const A*>(weight), static_cast<const A*>(bias), static_cast<T*>(out), hw, W,
      Cx, C, sxb, sxh, sxw, aff_stride, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A, int VEC>
int launch_bconv(const void* b_conv, const void* x, const float* mean, const float* rstd,
                 const void* weight, const void* bias, void* out, int64_t B, int64_t hw,
                 int64_t W, int64_t Cx, int64_t C, int64_t sxb, int64_t sxh, int64_t sxw,
                 int64_t aff_stride, cudaStream_t st) {
  return b_conv != nullptr
             ? launch<T, A, VEC, true>(x, b_conv, mean, rstd, weight, bias, out, B, hw, W, Cx,
                                       C, sxb, sxh, sxw, aff_stride, st)
             : launch<T, A, VEC, false>(x, b_conv, mean, rstd, weight, bias, out, B, hw, W,
                                        Cx, C, sxb, sxh, sxw, aff_stride, st);
}

template <typename T, typename A>
int launch_vec(int vec, const void* b_conv, const void* x, const float* mean,
               const float* rstd, const void* weight, const void* bias, void* out, int64_t B,
               int64_t hw, int64_t W, int64_t Cx, int64_t C, int64_t sxb, int64_t sxh,
               int64_t sxw, int64_t aff_stride, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch_bconv<T, A, kVec>(b_conv, x, mean, rstd, weight, bias, out, B, hw, W, Cx, C,
                                    sxb, sxh, sxw, aff_stride, st);
  if (vec == 1)
    return launch_bconv<T, A, 1>(b_conv, x, mean, rstd, weight, bias, out, B, hw, W, Cx, C,
                                 sxb, sxh, sxw, aff_stride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [B, H, W, Cx] with element strides sxb, sxh, sxw (channels contiguous),
// out dense [B, H, W, Cx]; b_conv [C] in x's type or null; mean, rstd [C]
// fp32; weight, bias of type aff_dtype at weight[b * aff_stride + c]
// (aff_stride C or 0). Cx = phases * C. vec = elements per access: 16 /
// itemsize of x where C, the strides and x's address allow it, else 1.
extern "C" int cg_cond_bn_relu(const void* x, const void* b_conv, const void* mean,
                               const void* rstd, const void* weight, const void* bias,
                               void* out, int64_t B, int64_t H, int64_t W, int64_t Cx,
                               int64_t C, int64_t sxb, int64_t sxh, int64_t sxw,
                               int64_t aff_stride, int dtype, int aff_dtype, int vec,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0 || Cx == 0) return 0;
  if (C < 1 || Cx % C || C % vec) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* r = static_cast<const float*>(rstd);
  // h and w collapse into one index where the rows are dense
  const int64_t hw = H * W;
  const int64_t w_dim = sxh == W * sxw ? hw : W;
  if (dtype == cg::kBFloat16 && aff_dtype == cg::kBFloat16)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, b_conv, x, m, r, weight, bias, out, B,
                                                    hw, w_dim, Cx, C, sxb, sxh, sxw,
                                                    aff_stride, st);
  if (dtype == cg::kBFloat16 && aff_dtype == cg::kFloat32)
    return launch_vec<__nv_bfloat16, float>(vec, b_conv, x, m, r, weight, bias, out, B, hw,
                                            w_dim, Cx, C, sxb, sxh, sxw, aff_stride, st);
  if (dtype == cg::kFloat32 && aff_dtype == cg::kFloat32)
    return launch_vec<float, float>(vec, b_conv, x, m, r, weight, bias, out, B, hw, w_dim, Cx,
                                    C, sxb, sxh, sxw, aff_stride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
