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

// Runtime DyFXU degrade of four packed int8 codes at once (SIMD within a
// 32-bit word): round to nearest at 2^shift and saturate to +-127, equal to
// repro.core.quantization.degrade for every code at every shift (shift 0
// is the identity and is skipped by the callers; shift >= 8 gives 0).
// Eleven integer operations a word: the 7-bit magnitude plus half a step
// cannot carry out of its byte, the sign bit is added back modulo 256, and
// the only wrapped results, +128 and -128, both land on byte 0x80, told
// apart by the code's sign and moved to +127 / -127.
struct Degrade {
  unsigned half4, mask4, sign4;  // 2^(shift-1), ~(2^shift - 1), 0x80 per byte
  __device__ __forceinline__ explicit Degrade(int shift)
      : half4(shift > 0 && shift < 8 ? (1u << (shift - 1)) * 0x01010101u : 0u),
        mask4(shift < 8 ? ((0xffu << shift) & 0xffu) * 0x01010101u : 0u),
        sign4(shift < 8 ? 0x80808080u : 0u) {}
  __device__ __forceinline__ unsigned operator()(unsigned w) const {
    const unsigned sgn = w & sign4;
    const unsigned d = (((w & 0x7f7f7f7fu) + half4) & mask4) ^ sgn;
    const unsigned t = (d & 0x7f7f7f7fu) + 0x7f7f7f7fu;   // bit 7: low bits nonzero
    const unsigned z = d & ~t & 0x80808080u;               // bytes equal to 0x80
    return d - (z >> 7) + ((z & sgn) >> 6);
  }
};

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
