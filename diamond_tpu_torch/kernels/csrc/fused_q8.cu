// Fused normalize + affine + SiLU + int8 quantize over NHWC activations, for Hopper
// (sm_90a): K4, two epilogues.
//
// Replaces the TPU kernel diamond_tpu/ops/fused_q8.py::norm_affine_silu_q8 (_kernel),
// which holds one image in VMEM, computes y = SiLU((x - mean_c) * inv_c * gamma + beta),
// its max |y| and the int8 codes in one pass.
//
//   (a) per-sample scale, the Pallas contract (norm_affine_silu_q8_fwd): mean/inv/gamma/
//       beta are (B, C) f32 rows; s_b = max(max |y| over sample b, 1e-8) / 127,
//       q = clip(round(y / s_b), +-127). The max over a sample is a reduction across
//       blocks: a max pass (block max, then atomicMax on the bit pattern of the
//       non-negative float, which orders like the float, so the result does not depend on
//       the order of the atomics), then a quantize pass that recomputes y. y is not
//       rounded before it is quantized, as in the Pallas kernel. Each pass splits a
//       sample into S spans of whole pixels (grid (S, B)), 16-byte loads along C, each
//       thread on fixed channels whose rows stay in registers.
//   (b) static per-channel scale, the int8 rollout's fusion (adagn_silu_q8_fwd,
//       groupnorm_silu_q8_fwd): K1/K2's kernel (gn_common.cuh gn_cluster_kernel, one
//       launch, one cluster per sample, x on chip) with the FiLM (1 + scale, shift) or
//       the GN affine, the result rounded to x's dtype (the norm output the unfused path
//       hands to the conv), then q = clip(round(y / s_c), +-127) with the consuming
//       conv's calibrated s_c = max(act_max_c, 1e-8) * 1.05 / 127, by a multiply with
//       1/s_c that divides truly near a rounding tie. Same plan, same reduction order and
//       same element function as K1/K2, so its codes equal quantize(K1/K2 output).
//
// What bounds it: bytes. (b) reads x once and writes one int8 byte per element; (a)
// reads x twice after the statistics the caller gives it. A few dozen f32 operations per
// element stay below the card's flop-per-byte balance.

#include "gn_common.cuh"
#include "q8_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// (a) per-sample scale

constexpr int kSpanThreads = 256;  // ops/fused_q8.py _MAX_THREADS

struct RowParams {
  const float *mean, *inv, *gamma, *beta;
};

// SiLU((v - mean) * inv * gamma + beta), every rounding pinned (a true division and the
// full-precision exponential in the SiLU).
__device__ __forceinline__ float affine_silu(float v, float mean, float inv, float gamma,
                                             float beta) {
  const float o = __fmaf_rn(__fmul_rn(__fsub_rn(v, mean), inv), gamma, beta);
  return __fdiv_rn(o, __fadd_rn(1.f, expf(-o)));
}

// The V codes of v[0..V) with scale s, stored with one 4- or 8-byte write.
template <int V>
__device__ __forceinline__ void store_q8(signed char* p, const float* v, float s) {
  union {
    signed char q[V];
    uint32_t w[V / 4];
  } u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.q[j] = quantize_q8(v[j], s);
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(u.w[0], u.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = u.w[0];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
q8_absmax_kernel(const T* __restrict__ x, RowParams rp, unsigned* __restrict__ amax,
                 int64_t per_sample, int C, int64_t span) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int64_t r0 = (int64_t)b * C + (t * V) % C;
  float mn[V], iv[V], ga[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mn[j] = rp.mean[r0 + j];
    iv[j] = rp.inv[r0 + j];
    ga[j] = rp.gamma[r0 + j];
    be[j] = rp.beta[r0 + j];
  }

  const T* xb = x + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;
  float m = 0.f;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(affine_silu(v[j], mn[j], iv[j], ga[j], be[j])));
  }
  // block max: warp 0 (always full: the wrapper's T > 128) folds every thread's value
  __shared__ float s_max[kSpanThreads];
  s_max[t] = m;
  __syncthreads();
  if (t < 32) {
    for (int u = t + 32; u < nt; u += 32) m = fmaxf(m, s_max[u]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (t == 0) atomicMax(amax + b, __float_as_uint(m));  // m >= 0: its bits order like the float
  }
}

template <typename T>
__global__ void __launch_bounds__(kSpanThreads)
q8_per_sample_kernel(const T* __restrict__ x, RowParams rp, const unsigned* __restrict__ amax,
                     signed char* __restrict__ q, float* __restrict__ scale, int64_t per_sample,
                     int C, int64_t span) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const float sb = __fdiv_rn(fmaxf(__uint_as_float(amax[b]), 1e-8f), 127.f);
  if (s == 0 && t == 0) scale[b] = sb;
  const int64_t r0 = (int64_t)b * C + (t * V) % C;
  float mn[V], iv[V], ga[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mn[j] = rp.mean[r0 + j];
    iv[j] = rp.inv[r0 + j];
    ga[j] = rp.gamma[r0 + j];
    be[j] = rp.beta[r0 + j];
  }

  const T* xb = x + (int64_t)b * per_sample;
  signed char* qb = q + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = affine_silu(v[j], mn[j], iv[j], ga[j], be[j]);
    store_q8<V>(qb + i, v, sb);
  }
}

template <typename T>
int launch_per_sample(const void* x, RowParams rp, void* q, void* scale, void* amax, int B,
                      int HW, int C, int S, int64_t span, int threads, cudaStream_t st) {
  const int64_t per_sample = (int64_t)HW * C;
  unsigned* am = static_cast<unsigned*>(amax);
  const dim3 grid(S, B);
  cudaMemsetAsync(am, 0, sizeof(unsigned) * B, st);
  q8_absmax_kernel<T><<<grid, threads, 0, st>>>(static_cast<const T*>(x), rp, am, per_sample, C,
                                                 span);
  q8_per_sample_kernel<T><<<grid, threads, 0, st>>>(static_cast<const T*>(x), rp, am,
                                                     static_cast<signed char*>(q),
                                                     static_cast<float*>(scale), per_sample, C,
                                                     span);
  return (int)cudaGetLastError();
}

}  // namespace

// (a) x: (B, HW, C); mean, inv, gamma, beta: (B, C) f32; q: (B, HW, C) int8; scale: (B,)
// f32; amax: (B,) 4-byte scratch. dtype: 0 float32, 1 bfloat16.
extern "C" int norm_affine_silu_q8_fwd(const void* x, const void* mean, const void* inv,
                                       const void* gamma, const void* beta, void* q,
                                       void* scale, void* amax, int B, int HW, int C, int S,
                                       int64_t span, int threads, int dtype, void* stream) {
  const RowParams rp{static_cast<const float*>(mean), static_cast<const float*>(inv),
                     static_cast<const float*>(gamma), static_cast<const float*>(beta)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_per_sample<float>(x, rp, q, scale, amax, B, HW, C, S, span, threads, st);
  if (dtype == 1)
    return launch_per_sample<__nv_bfloat16>(x, rp, q, scale, amax, B, HW, C, S, span, threads,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// (b) with FiLM: scale_shift (B, 2C), scale then shift, aff_dtype 0 float32, 1 bfloat16;
// act_max (C,) f32. x's dtype is the plan's (elem_bytes).
extern "C" int adagn_silu_q8_fwd(const void* x, const void* scale_shift, int aff_dtype,
                                 const void* act_max, void* q, const int* plan, void* stream) {
  const int C = plan[2];
  const size_t es = aff_dtype ? 2 : 4;
  const GnArgs a{x, q, scale_shift, static_cast<const char*>(scale_shift) + C * es, 2 * (int64_t)C,
                 aff_dtype, 1, 1, static_cast<const float*>(act_max), nullptr};
  return dispatch_gn<true>(a, plan, stream);
}

// (b) with GroupNorm's affine: scale, bias (C,) of aff_dtype, shared by every sample.
extern "C" int groupnorm_silu_q8_fwd(const void* x, const void* scale, const void* bias,
                                     int aff_dtype, const void* act_max, void* q,
                                     const int* plan, void* stream) {
  const GnArgs a{x, q, scale, bias, 0, aff_dtype, 0, 1, static_cast<const float*>(act_max),
                 nullptr};
  return dispatch_gn<true>(a, plan, stream);
}

// The clusters of the plan the current card can run at once for (b) (0: it cannot place
// one), or a negative CUDA error code.
extern "C" int gn_q8_max_clusters(const int* plan) { return dispatch_max_clusters<true>(plan); }
