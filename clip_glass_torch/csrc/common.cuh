// Shared helpers of the clip_glass_torch CUDA kernels: dtype codes of the
// plain C interface, fp32 conversion of the storage types, packed vectors,
// the device's SM count, shared-memory barriers (mbarrier) for asynchronous
// copies, TMA loads and tensor-map encoding, wgmma descriptors and fences.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T in one aligned access (16 bytes at the widest).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Blocks for a grid-stride loop over n items, capped so that a launch
// never exceeds the grid limit.
inline unsigned grid_blocks(int64_t n, int threads, int64_t cap = 1 << 20) {
  int64_t b = (n + threads - 1) / threads;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

// Cards a process tells apart in the once-a-card settings below.
constexpr int kMaxDevices = 64;

// The current device's index in [0, kMaxDevices), or -1.
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices ? dev : -1;
}

// Streaming multiprocessors of the current device (asked once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) {
      n = 132;  // H100 SXM
    }
  }
  return n;
}

// One 16-byte access of T widened to fp32: 8 bf16 or 4 fp32 values.
template <typename T> struct Pack16;
template <> struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const int4& v, float (&f)[8]) {
    const unsigned w[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                           static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the upper half of its fp32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Pack16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const int4& v, float (&f)[4]) {
    f[0] = __int_as_float(v.x);
    f[1] = __int_as_float(v.y);
    f[2] = __int_as_float(v.z);
    f[3] = __int_as_float(v.w);
  }
};

// ---- mbarriers in shared memory, as the asynchronous copies signal them

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait of more than
// 10 s traps (the next synchronisation reports a launch failure) rather
// than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (spin == 0) {
        t0 = t;
      } else if (t - t0 > 10000000000ull) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma

// wgmma operand in shared memory, K-major with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO); a 32-byte K step inside
// the row (k16 of bf16, k32 of int8) adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// ---- tensor maps

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace cg
