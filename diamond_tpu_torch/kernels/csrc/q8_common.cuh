// The symmetric int8 quantize shared by fused_q8.cu (K4), conv3x3_q8.cu (K5), matmul_q8.cu
// (K6) and quantize_q8.cu (K7):
// q = clip(round(v / s), -127, 127), rounding half to even and dividing truly (a multiply
// by 1/s would move round-half cases), as diamond_tpu/ops/quant.py does with jnp.round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ signed char quantize_q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(r));
}

// The code of v from the reciprocal r = 1/s (rounded), one multiply instead of a
// division, in full-rate arithmetic only, as the low byte of the returned bits, and
// dist = |t - round(t)| <= 0.5: above kNearTie the true division must decide. t = v * r
// is within |v/s| * 1.8e-7 of the correctly rounded quotient, so for |t| < 256 its
// rounding to an integer can differ only where t lies within 4.6e-5 of a half-integer.
// Clipping to +-127 before rounding gives the same code (the bounds are integers), and
// adding 1.5 * 2^23 (bits 0x4B400000) to a clipped t rounds it to an integer k, half to
// even: the sum's bits are 0x4B400000 + k, whose low byte is k as an int8.
constexpr float kNearTie = 0.5f - 1e-4f;

__device__ __forceinline__ uint32_t q8_rcp_bits(float v, float r, float& dist) {
  constexpr float kRound = 12582912.f;
  const float t = fminf(fmaxf(__fmul_rn(v, r), -127.f), 127.f);
  const float m = __fadd_rn(t, kRound);
  dist = fabsf(__fsub_rn(t, __fsub_rn(m, kRound)));
  return __float_as_uint(m);
}

__device__ __forceinline__ signed char quantize_q8_rcp(float v, float s, float r) {
  float dist;
  const uint32_t bits = q8_rcp_bits(v, r, dist);
  return dist > kNearTie ? quantize_q8(v, s) : static_cast<signed char>(bits & 0xffu);
}

// The static per-input-channel scale of diamond_tpu/ops/quant.py:
// s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM (1.05) / 127, in f32 in that order.
__device__ __forceinline__ float static_scale(float act_max) {
  return __fdiv_rn(__fmul_rn(fmaxf(act_max, 1e-8f), 1.05f), 127.f);
}

}  // namespace
