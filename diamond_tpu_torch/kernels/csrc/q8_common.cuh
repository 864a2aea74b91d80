// The symmetric int8 quantize shared by fused_q8.cu (K4) and conv3x3_q8.cu (K5):
// q = clip(round(v / s), -127, 127), rounding half to even and dividing truly (a multiply
// by 1/s would move round-half cases), as diamond_tpu/ops/quant.py does with jnp.round.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ signed char quantize_q8(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(r));
}

// The same code from the reciprocal r = 1/s (rounded), one multiply instead of a
// division: t = v * r is within |v/s| * 1.8e-7 of the correctly rounded quotient, so for
// |t| < 256 its rounding to an integer can differ only where t lies within 4.6e-5 of a
// half-integer; there the true division decides. For |t| >= 256 both clip to +-127.
__device__ __forceinline__ signed char quantize_q8_rcp(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  const bool near_tie = fabsf(t) < 256.f && fabsf(fabsf(t - truncf(t)) - 0.5f) < 1e-4f;
  const float q = rintf(near_tie ? __fdiv_rn(v, s) : t);
  return static_cast<signed char>(__float2int_rn(fminf(fmaxf(q, -127.f), 127.f)));
}

// The static per-input-channel scale of diamond_tpu/ops/quant.py:
// s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM (1.05) / 127, in f32 in that order.
__device__ __forceinline__ float static_scale(float act_max) {
  return __fdiv_rn(__fmul_rn(fmaxf(act_max, 1e-8f), 1.05f), 127.f);
}

}  // namespace
