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
// Bound: bytes. On the ToRGB path O = 3, so the work is 2*O = 6 operations
// per input value (3 per byte in bf16), two orders of magnitude below the
// ~295 operations per byte at which the tensor cores would become the limit.
// The floor is (|x| + |y|) / 3.35 TB/s on an H100 SXM (0.351 ms at
// [16,1024^2,32,3] in bf16). Below about 32 px a launch moves so little that
// the floor is the launch itself, a few microseconds on the device.
//
// Bytes set the floor, but a CUDA-core kernel also has an instruction stream
// to get through: widening bf16, 3 multiply-adds a value and the cross-lane
// sums come to about 60 instructions per 16 bytes loaded. A CUDA-core O = 3
// kernel with the loads, grid and stores of "mma" below (folded fp32 weights
// in registers, exactly 3 accumulators) was measured at about 80% of the
// floor's rate at 1024 px, the tensor-core kernel at about 87%: the
// flagship's kernel uses the tensor cores not for their rate but because
// they take the arithmetic off the instruction stream. The CUDA-core one was
// not kept.
//
// Two kernels, chosen by the wrapper from dtype, shape and O:
//
// "mma" (cg_modulated_matmul_mma; bf16, O = 3, I = 32..512 in powers of two:
// the ToRGB calls of the flagship from 32 px up). x is one contiguous stream
// per sample, read once with streaming 16-byte loads, 8 in flight a thread;
// four lanes cover 64 contiguous bytes of a pixel's row, a warp 8 pixels a
// load. At I = 32 (512 and 1024 px) a warp's 64 pixels are 4 KB of
// contiguous memory, and one cp.async.bulk under an mbarrier brings them
// into a two-stage ring of the warp in shared memory instead, which
// measured 4% faster at 1024 px on an H100; the lanes then read the same
// 16 bytes from there. The loaded registers are used, as they are, as the A fragments of
// mma.sync m16n8k16 (bf16 in, fp32 accumulate): no widening, no
// multiply-add and no shuffle is issued for them. The sum over k has no
// order, so k is permuted to fit the load, and the folded weights
// s[b,k]*w[k,o] are laid out under the same permutation as B fragments,
// folded in fp32 once per block through shared memory and kept in
// registers. The fold is not rounded to bf16: of the 8 columns that O = 3
// pads to, column 2o holds the fold's bf16 head and column 2o + 1 its bf16
// tail (fold - head), a lane's two accumulators, which it adds after the
// last mma: head + tail is the fp32 fold exactly (a product of two bf16
// values has 16 bits of mantissa), at no further mma and no shuffle. A
// persistent grid of as many blocks as the card holds at once walks tiles
// of consecutive pixels. A warp's pixels are consecutive, so its outputs
// are one contiguous run of pixels x 3 values: they are staged in the
// warp's shared-memory row at the run's phase within a 16-byte line and
// written as 16-byte vectors, with a scalar head and tail.
//
// "chunked" (cg_modulated_matmul; any O, any I, either dtype, scalar rows
// too: the first design, and the one for launch-sized calls, where its
// single round of loads wins). Each block folds the style into the weights
// of its sample and a chunk of OC = 4 outputs in shared memory (sw[o][i],
// laid out so the TPP lanes of a group read consecutive words); every
// multiply-add reads its weight from there. Partial sums are reduced over
// the group with warp shuffles; one lane applies demod and bias and stores.
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

// largest power of two <= 32 dividing the row's vector count
int lanes_per_pixel(int G) {
  int tpp = 1;
  while (tpp < 32 && G % (tpp * 2) == 0) tpp *= 2;
  return tpp;
}

template <typename T, int VEC>
int launch(const void* x, const void* style, const void* w, const void* demod, const void* bias,
           void* out, int64_t B, int64_t P, int64_t I, int64_t O, cudaStream_t st) {
  const int threads = 256;
  const int tpp = lanes_per_pixel(static_cast<int>(I / VEC));
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

// ----------------------------------------------------------------- "mma"

constexpr int O3 = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Write a warp's staged run to global memory: ys[i] holds the value of
// dst[i] for i in [phase, total), with dst = run - phase on a 16-byte line:
// 16-byte vectors, a scalar head and tail. The caller brackets it with
// __syncwarp().
template <typename T>
__device__ __forceinline__ void store_run(T* run, const T* ys, int phase, int total,
                                          int lane_id) {
  constexpr int VEC = 16 / sizeof(T);
  T* dst = run - phase;
  for (int i = lane_id * VEC; i < total; i += 32 * VEC) {
    if (i >= phase && i + VEC <= total) {
      *reinterpret_cast<int4*>(dst + i) = *reinterpret_cast<const int4*>(ys + i);
    } else {
      for (int j = i < phase ? phase : i; j < i + VEC && j < total; ++j) dst[j] = ys[j];
    }
  }
}

// The run's phase: its first value's index within a 16-byte line.
template <typename T>
__device__ __forceinline__ int run_phase(const T* run) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(run) / sizeof(T)) &
                          (16 / sizeof(T) - 1));
}

// blocks of one sample in a persistent grid: no more blocks than the card
// holds at once (a block left over would run alone after the rest), split
// evenly over the samples, at most one per tile
unsigned blocks_per_sample(int blocks_per_sm, int64_t B, int64_t tiles) {
  int64_t n = static_cast<int64_t>(cg::sm_count()) * blocks_per_sm / B;
  if (n < 1) n = 1;
  return static_cast<unsigned>(n < tiles ? n : tiles);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], int a0, int a1, int a2, int a3,
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int G4>
struct MmaShape {
  static constexpr int ROWS = G4 == 1 ? 8 : 4;  // 8-pixel row sets per warp and tile
  static constexpr int KI = G4 == 1 ? 1 : 2;    // 64-byte slabs of a row loaded together
  static constexpr int PIX = ROWS * 8;          // pixels per warp and tile
  // I = 32: a warp's tile is 4 KB of contiguous global memory, which one
  // cp.async.bulk copies into a ring of STAGES stages per warp in (dynamic)
  // shared memory; wider rows are loaded straight into registers
  static constexpr int STAGES = G4 == 1 ? 2 : 0;
  static constexpr int STAGE_BYTES = PIX * 64 * G4;
  static constexpr int RING_BYTES = WARPS * STAGES * STAGE_BYTES;
  static constexpr int BLOCKS_PER_SM = G4 == 1 ? 2 : G4 <= 4 ? 3 : 2;
};

// Lane 0 starts the copy of the whole rows of a warp's tile (at most `pix`
// pixels from p0; the caller guarantees p0 < P) into `stage`, signalled on
// `bar`.
template <int I>
__device__ __forceinline__ void copy_tile(const bf16* xb, int64_t p0, int64_t P, int pix,
                                          void* stage, uint64_t* bar) {
  const int64_t left = P - p0;
  const uint32_t bytes = static_cast<uint32_t>((left < pix ? left : pix) * I * sizeof(bf16));
  cg::mbar_expect_tx(cg::smem_addr(bar), bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(cg::smem_addr(stage)), "l"(xb + p0 * I), "r"(bytes), "r"(cg::smem_addr(bar))
      : "memory");
}

// bf16, O = 3, I = 32 * G4. Lane (g, t) = (lane / 4, lane % 4) loads, of the
// pixels p0 + g + 8j, the 16 bytes t + 4i of every 64-byte slab i of the
// row: a warp's load covers 8 rows x 64 contiguous bytes. Those registers
// are, as they come, the A fragments of m16n8k16 (rows g and g+8 from the
// row sets 2m and 2m+1; the k slots 2t, 2t+1 and 2t+8, 2t+9 take the words
// .x, .y, then .z, .w): the sum over k has no order, so k is permuted to
// fit the load, and the B fragments hold the folded weights under the same
// permutation. The fold f = s[b,k] * w[k,o], a product of two bf16 values,
// is exact in fp32 and splits exactly into two bf16 values, its head
// bf16(f) and its tail f - head: column n = 2o holds the heads, column
// n = 2o + 1 the tails, columns 6 and 7 zeros. A lane's accumulators are
// the columns 2t and 2t + 1: lane t < 3 adds its two after the last mma and
// has output o = t.
//
// At I = 32 the tile comes through shared memory instead (MmaShape): lane L
// reads the 16 bytes L + 32j of the stage, which are the same bytes of the
// same pixels, so everything after the load is shared. A stage is refilled
// with the warp's tile STAGES rounds ahead as soon as the warp has read it.
template <int G4>
__global__ void __launch_bounds__(THREADS, MmaShape<G4>::BLOCKS_PER_SM)
    modulated_matmul_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ style,
                                const bf16* __restrict__ w, const bf16* __restrict__ demod,
                                const bf16* __restrict__ bias, bf16* __restrict__ out,
                                int64_t P, int64_t tiles_per_sample) {
  using S = MmaShape<G4>;
  constexpr int I = 32 * G4;
  constexpr int VEC = 8;
  // one staging row per warp: a run of PIX pixels x 3 values, shifted by
  // the run's phase (< VEC values) within a 16-byte line
  constexpr int ROW = S::PIX * O3 + VEC;
  __shared__ int4 ys_raw[WARPS][ROW * sizeof(bf16) / 16];
  // folded weights f[k] = s[k] w[k,o] as bf16 pairs (k, k + 1): heads in
  // wf[o][k / 2], tails in wf[O3 + o][k / 2]
  __shared__ __align__(16) unsigned wf[2 * O3][I / 2];
  extern __shared__ __align__(128) unsigned char ring[];  // RING_BYTES
  __shared__ __align__(8) uint64_t bars[WARPS][S::STAGES > 0 ? S::STAGES : 1];
  const int warp = threadIdx.x >> 5;
  const int lane_id = threadIdx.x & 31;
  const int g = lane_id >> 2;
  const int t = lane_id & 3;
  const int b = blockIdx.y;
  bf16* ys = reinterpret_cast<bf16*>(ys_raw[warp]);

  for (int idx = threadIdx.x; idx < O3 * (I / 2); idx += THREADS) {
    const int n = idx / (I / 2);
    const int k = 2 * (idx - n * (I / 2));
    float s0 = 1.f, s1 = 1.f;
    if (style != nullptr) {
      s0 = cg::to_float(style[static_cast<int64_t>(b) * I + k]);
      s1 = cg::to_float(style[static_cast<int64_t>(b) * I + k + 1]);
    }
    const float f0 = s0 * cg::to_float(w[k * O3 + n]);
    const float f1 = s1 * cg::to_float(w[(k + 1) * O3 + n]);
    const __nv_bfloat162 head = __floats2bfloat162_rn(f0, f1);
    const __nv_bfloat162 tail = __floats2bfloat162_rn(f0 - __low2float(head),
                                                      f1 - __high2float(head));
    wf[n][k / 2] = *reinterpret_cast<const unsigned*>(&head);
    wf[O3 + n][k / 2] = *reinterpret_cast<const unsigned*>(&tail);
  }
  if (S::STAGES > 0 && lane_id == 0) {
    for (int s = 0; s < S::STAGES; ++s) cg::mbar_init(cg::smem_addr(&bars[warp][s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // B fragments of slab i: k = (t + 4i) * 8 + {0,1 | 2,3 | 4,5 | 6,7}, n = g:
  // the head (g even) or tail (g odd) of output g / 2
  const int wrow = g < 2 * O3 ? (g & 1) * O3 + (g >> 1) : -1;
  uint4 bfrag[G4];
#pragma unroll
  for (int i = 0; i < G4; ++i) {
    bfrag[i] = wrow >= 0 ? *reinterpret_cast<const uint4*>(&wf[wrow][(t + 4 * i) * 4])
                         : make_uint4(0u, 0u, 0u, 0u);
  }
  // this lane's accumulator columns are the head and tail of output t
  const float dm =
      t < O3 && demod != nullptr ? cg::to_float(demod[static_cast<int64_t>(b) * O3 + t]) : 1.f;
  const float bs = t < O3 ? cg::to_float(bias[t]) : 0.f;

  const bf16* xb = x + static_cast<int64_t>(b) * P * I;
  bf16* ob = out + static_cast<int64_t>(b) * P * O3;
  unsigned char* my_ring = ring + warp * S::STAGES * S::STAGE_BYTES;
  // the warp's tile `ahead` rounds after `tile` into stage `s`, if there is one
  auto prefetch = [&](int64_t tile, int ahead, int s) {
    const int64_t next = tile + static_cast<int64_t>(ahead) * gridDim.x;
    const int64_t p0 = (next * WARPS + warp) * S::PIX;
    if (lane_id == 0 && next < tiles_per_sample && p0 < P) {
      copy_tile<I>(xb, p0, P, S::PIX, my_ring + s * S::STAGE_BYTES, &bars[warp][s]);
    }
  };
  for (int s = 0; s < S::STAGES; ++s) prefetch(blockIdx.x, s, s);
  int stage = 0;
  uint32_t parity = 0;
  for (int64_t tile = blockIdx.x; tile < tiles_per_sample; tile += gridDim.x) {
    // the same for the whole warp; once past P, every later tile is too
    const int64_t p0 = (tile * WARPS + warp) * S::PIX;
    if (p0 >= P) continue;
    const int64_t left = P - p0;
    float acc[S::ROWS / 2][4];
#pragma unroll
    for (int m = 0; m < S::ROWS / 2; ++m) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
    }
#pragma unroll
    for (int i0 = 0; i0 < G4; i0 += S::KI) {
      int4 a[S::ROWS][S::KI];
      if constexpr (S::STAGES > 0) {
        // rows past `left` hold stale bytes: their sums are never stored
        cg::mbar_wait(cg::smem_addr(&bars[warp][stage]), parity);
#pragma unroll
        for (int j = 0; j < S::ROWS; ++j) {
          a[j][0] = *reinterpret_cast<const int4*>(my_ring + stage * S::STAGE_BYTES +
                                                   (32 * j + lane_id) * 16);
        }
        __syncwarp();
        prefetch(tile, S::STAGES, stage);
        if (++stage == S::STAGES) {
          stage = 0;
          parity ^= 1;
        }
      } else {
#pragma unroll
        for (int j = 0; j < S::ROWS; ++j) {
          const int idx = g + 8 * j;
#pragma unroll
          for (int ki = 0; ki < S::KI; ++ki) {
            a[j][ki] = idx < left ? __ldcs(reinterpret_cast<const int4*>(
                                        xb + (p0 + idx) * I + (t + 4 * (i0 + ki)) * VEC))
                                  : make_int4(0, 0, 0, 0);
          }
        }
      }
#pragma unroll
      for (int ki = 0; ki < S::KI; ++ki) {
        const uint4 bw = bfrag[i0 + ki];
#pragma unroll
        for (int m = 0; m < S::ROWS / 2; ++m) {
          const int4 lo = a[2 * m][ki], hi = a[2 * m + 1][ki];
          mma_m16n8k16(acc[m], lo.x, hi.x, lo.y, hi.y, bw.x, bw.y);
          mma_m16n8k16(acc[m], lo.z, hi.z, lo.w, hi.w, bw.z, bw.w);
        }
      }
    }
    // acc[m]: (c0, c1) pixel g + 16m, (c2, c3) pixel g + 16m + 8; n = 2t, 2t+1
    bf16* run = ob + p0 * O3;
    const int phase = run_phase(run);
    const int total = phase + static_cast<int>(left < S::PIX ? left : S::PIX) * O3;
    if (t < O3) {
#pragma unroll
      for (int m = 0; m < S::ROWS / 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int idx = g + 16 * m + 8 * h;
          if (idx < left) {
            ys[phase + idx * O3 + t] =
                cg::from_float<bf16>((acc[m][2 * h] + acc[m][2 * h + 1]) * dm + bs);
          }
        }
      }
    }
    __syncwarp();
    store_run(run, ys, phase, total, lane_id);
    __syncwarp();
  }
}

template <int G4>
int launch_mma(const void* x, const void* style, const void* w, const void* demod,
               const void* bias, void* out, int64_t B, int64_t P, cudaStream_t st) {
  using S = MmaShape<G4>;
  const int64_t tiles = (P + WARPS * S::PIX - 1) / (WARPS * S::PIX);
  dim3 grid(blocks_per_sample(S::BLOCKS_PER_SM, B, tiles), static_cast<unsigned>(B));
  if (S::RING_BYTES > 48 * 1024) {  // above the default limit: opt in, once a card
    static bool opted_in[cg::kMaxDevices] = {};
    const int dev = cg::current_device();
    if (dev < 0 || !opted_in[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          modulated_matmul_mma_kernel<G4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          S::RING_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev >= 0) opted_in[dev] = true;
    }
  }
  modulated_matmul_mma_kernel<G4><<<grid, THREADS, S::RING_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(style),
      static_cast<const bf16*>(w), static_cast<const bf16*>(demod),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), P, tiles);
  return 0;
}

}  // namespace

// The first design, for any O and I. vec = elements per x access (the caller
// guarantees I % vec == 0 and a 16-byte aligned x for vec > 1).
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

// The tensor-core kernel: bf16, O = 3, I = 32, 64, 128, 256 or 512, a
// 16-byte aligned x.
extern "C" int cg_modulated_matmul_mma(const void* x, const void* style, const void* w,
                                       const void* demod, const void* bias, void* out,
                                       int64_t B, int64_t P, int64_t I, void* stream) {
  if (B * P == 0) return 0;
  if (B > 65535 || (reinterpret_cast<uintptr_t>(x) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status = static_cast<int>(cudaErrorInvalidValue);
  if (I == 32) status = launch_mma<1>(x, style, w, demod, bias, out, B, P, st);
  if (I == 64) status = launch_mma<2>(x, style, w, demod, bias, out, B, P, st);
  if (I == 128) status = launch_mma<4>(x, style, w, demod, bias, out, B, P, st);
  if (I == 256) status = launch_mma<8>(x, style, w, demod, bias, out, B, P, st);
  if (I == 512) status = launch_mma<16>(x, style, w, demod, bias, out, B, P, st);
  if (status != 0) return status;
  return static_cast<int>(cudaGetLastError());
}
