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

// The static per-input-channel scale of diamond_tpu/ops/quant.py:
// s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM (1.05) / 127, in f32 in that order.
__device__ __forceinline__ float static_scale(float act_max) {
  return __fdiv_rn(__fmul_rn(fmaxf(act_max, 1e-8f), 1.05f), 127.f);
}

}  // namespace
