// Fused normalize + affine + SiLU + int8 quantize over NHWC activations, for Hopper
// (sm_90a): K4, two epilogues.
//
// Replaces the TPU kernel diamond_tpu/ops/fused_q8.py::norm_affine_silu_q8 (_kernel),
// which holds one image in VMEM, computes y = SiLU((x - mean_c) * inv_c * gamma + beta),
// its max |y| and the int8 codes in one pass.
//
//   (a) per-sample scale, the Pallas contract (norm_affine_silu_q8_fwd): mean/inv/gamma/
//       beta are (B, C) f32 rows; s_b = max(max |y| over sample b, 1e-8) / 127,
//       q = clip(round(y / s_b), +-127). A 64x64x128 bf16 image (1 MB) does not fit a
//       block's 227 KB of shared memory, so the max over a sample is a reduction across
//       blocks: a max pass (block max, then atomicMax on the bit pattern of the
//       non-negative float, which orders like the float, so the result does not depend on
//       the order of the atomics), then a quantize pass that recomputes y. y is not
//       rounded before it is quantized, as in the Pallas kernel.
//   (b) static per-channel scale, the int8 rollout's fusion (adagn_silu_q8_fwd,
//       groupnorm_silu_q8_fwd): K1/K2's statistics pass and apply with the FiLM
//       (1 + scale, shift) or the GN affine, the result rounded to x's dtype (the norm
//       output the unfused path hands to the conv), then q = clip(round(y / s_c), +-127)
//       with the consuming conv's calibrated s_c = max(act_max_c, 1e-8) * 1.05 / 127.
//       It uses gn_common.cuh's statistics pass, launch shape and pinned arithmetic, so
//       its codes equal quantize(K1/K2 output) exactly.
//
// What bounds it: bytes. Per element (b) reads x twice (statistics, then apply) and
// writes one int8 byte instead of a bf16 pair; (a) reads x twice after the statistics
// the caller gives it. A few dozen f32 operations per element stay far below the card's
// flop-per-byte balance. The design keeps K1/K2's: spans of whole pixels per block,
// 16-byte loads along C, each thread on fixed channels whose coefficients and scales
// stay in registers, and 4- or 8-byte int8 stores.

#include "gn_common.cuh"
#include "q8_common.cuh"

namespace {

// The V codes of v[0..V) with scales s[0..V), stored with one 4- or 8-byte write.
template <int V>
__device__ __forceinline__ void store_q8(signed char* p, const float* v, const float* s) {
  union {
    signed char q[V];
    uint32_t w[V / 4];
  } u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.q[j] = quantize_q8(v[j], s[j]);
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(u.w[0], u.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = u.w[0];
  }
}

// ---------------------------------------------------------------------------
// (b) static per-channel scale

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply_q8_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                   const float* __restrict__ partials, const float* __restrict__ scale,
                   const float* __restrict__ shift, int64_t ss_bstride, int one_plus,
                   const float* __restrict__ act_max, int64_t per_sample, int C, int G,
                   int64_t span, int S, float count, float eps) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int gs = C / G;

  __shared__ float s_mean[kMaxGroups], s_inv[kMaxGroups];
  gn_group_moments(partials, b, S, G, count, eps, s_mean, s_inv);

  const int c0 = (t * V) % C;
  const float mean = s_mean[c0 / gs], inv = s_inv[c0 / gs];
  float mul[V], add[V], s_c[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sc = scale[(int64_t)b * ss_bstride + c0 + j];
    mul[j] = one_plus ? 1.f + sc : sc;
    add[j] = shift[(int64_t)b * ss_bstride + c0 + j];
    s_c[j] = static_scale(act_max[c0 + j]);
  }

  const T* xb = x + (int64_t)b * per_sample;
  signed char* qb = q + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = round_to<T>(gn_affine_silu(v[j], mean, inv, mul[j], add[j], 1));
    store_q8<V>(qb + i, v, s_c);
  }
}

template <typename T>
int launch_static(const void* x, void* q, const float* scale, const float* shift,
                  int64_t ss_bstride, int one_plus, const float* act_max, int B, int HW, int C,
                  int G, float* partials, int S, int64_t span, int threads, cudaStream_t st) {
  const int64_t per_sample = (int64_t)HW * C;
  const float count = (float)((int64_t)HW * (C / G));
  const dim3 grid(S, B);
  gn_stats_kernel<T><<<grid, threads, 0, st>>>(static_cast<const T*>(x), partials, per_sample,
                                                C, G, span, S);
  gn_apply_q8_kernel<T><<<grid, threads, 0, st>>>(
      static_cast<const T*>(x), static_cast<signed char*>(q), partials, scale, shift,
      ss_bstride, one_plus, act_max, per_sample, C, G, span, S, count, 1e-5f);
  return (int)cudaGetLastError();
}

int dispatch_static(int dtype, const void* x, void* q, const float* scale, const float* shift,
                    int64_t ss_bstride, int one_plus, const void* act_max, int B, int HW, int C,
                    int G, void* partials, int S, int64_t span, int threads, void* stream) {
  const float* am = static_cast<const float*>(act_max);
  float* p = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_static<float>(x, q, scale, shift, ss_bstride, one_plus, am, B, HW, C, G, p,
                                S, span, threads, st);
  if (dtype == 1)
    return launch_static<__nv_bfloat16>(x, q, scale, shift, ss_bstride, one_plus, am, B, HW, C,
                                        G, p, S, span, threads, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// (a) per-sample scale

struct RowParams {
  const float *mean, *inv, *gamma, *beta;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
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
    for (int j = 0; j < V; ++j)
      m = fmaxf(m, fabsf(gn_affine_silu(v[j], mn[j], iv[j], ga[j], be[j], 1)));
  }
  // block max: warp 0 (always full: the wrapper's T > 128) folds every thread's value
  __shared__ float s_max[kMaxThreads];
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
__global__ void __launch_bounds__(kMaxThreads)
q8_per_sample_kernel(const T* __restrict__ x, RowParams rp, const unsigned* __restrict__ amax,
                     signed char* __restrict__ q, float* __restrict__ scale, int64_t per_sample,
                     int C, int64_t span) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const float sb = __fdiv_rn(fmaxf(__uint_as_float(amax[b]), 1e-8f), 127.f);
  if (s == 0 && t == 0) scale[b] = sb;
  const int64_t r0 = (int64_t)b * C + (t * V) % C;
  float mn[V], iv[V], ga[V], be[V], sv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mn[j] = rp.mean[r0 + j];
    iv[j] = rp.inv[r0 + j];
    ga[j] = rp.gamma[r0 + j];
    be[j] = rp.beta[r0 + j];
    sv[j] = sb;
  }

  const T* xb = x + (int64_t)b * per_sample;
  signed char* qb = q + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = gn_affine_silu(v[j], mn[j], iv[j], ga[j], be[j], 1);
    store_q8<V>(qb + i, v, sv);
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

// (b) with FiLM: scale_shift (B, 2C) f32, scale then shift; act_max (C,) f32.
extern "C" int adagn_silu_q8_fwd(const void* x, const void* scale_shift, const void* act_max,
                                 void* q, int B, int HW, int C, int G, void* partials, int S,
                                 int64_t span, int threads, int dtype, void* stream) {
  const float* ss = static_cast<const float*>(scale_shift);
  return dispatch_static(dtype, x, q, ss, ss + C, 2 * (int64_t)C, 1, act_max, B, HW, C, G,
                         partials, S, span, threads, stream);
}

// (b) with GroupNorm's affine: scale, bias (C,) f32 shared by every sample.
extern "C" int groupnorm_silu_q8_fwd(const void* x, const void* scale, const void* bias,
                                     const void* act_max, void* q, int B, int HW, int C, int G,
                                     void* partials, int S, int64_t span, int threads, int dtype,
                                     void* stream) {
  return dispatch_static(dtype, x, q, static_cast<const float*>(scale),
                         static_cast<const float*>(bias), 0, 0, act_max, B, HW, C, G, partials,
                         S, span, threads, stream);
}
