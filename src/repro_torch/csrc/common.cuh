// Shared helpers of the port's hand-written attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Finite "minus infinity" of the JAX kernels: masked scores never make
// exp() see inf - inf.
constexpr float NEG_INF = -2.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// bf16 tensor-core helpers of the flash and multi-query kernels.
// c += a·b over one m16n8k16 tile (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Load 8 consecutive elements of row `r` (of n_rows) starting at column d0,
// zero past the row count or past dh.
__device__ __forceinline__ void load8(__nv_bfloat16 (&t)[8], const __nv_bfloat16* src,
                                      size_t stride, int r, int n_rows, int d0, int dh,
                                      bool vec) {
  if (r < n_rows && vec && d0 + 8 <= dh) {
    *reinterpret_cast<uint4*>(t) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + d0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = d0 + e;
      t[e] = (r < n_rows && d < dh) ? src[(size_t)r * stride + d] : __float2bfloat16(0.f);
    }
  }
}

// dtype codes passed from Python
constexpr int DTYPE_BF16 = 0;
constexpr int DTYPE_F32 = 1;

}  // namespace repro
