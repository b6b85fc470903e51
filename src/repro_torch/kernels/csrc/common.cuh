// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked-score sentinel; the same value as the reference's NEG_INF.
constexpr float kNegInf = -1e30f;

// Element type codes passed through the C interface.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Runtime DyFXU degrade of four packed int8 mantissas: round to nearest at
// 2^shift and saturate to +-127 (repro.core.quantization.degrade).
__device__ __forceinline__ int degrade4(int w, int shift) {
  if (shift <= 0) return w;
  const int half = 1 << (shift - 1);
  int out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = static_cast<int>(static_cast<signed char>((w >> (8 * i)) & 0xff));
    int d = ((v + half) >> shift) << shift;
    d = min(max(d, -127), 127);
    out |= (d & 0xff) << (8 * i);
  }
  return out;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro
