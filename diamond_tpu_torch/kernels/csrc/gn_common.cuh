// GroupNorm pieces shared by fused_norms.cu (K1/K2) and fused_q8.cu (K4): 16-byte vector
// access along C, the span-split statistics pass, the reduction of its partials to
// per-group mean and 1/std, and the per-element normalize + affine + SiLU.
//
// Every kernel that normalises goes through the same statistics pass with the same
// launch shape, the same fixed-order reduction and the same pinned element arithmetic,
// so K4's static epilogue sees bit for bit the values K1/K2 write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 64;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// v rounded to T and back: the value a T-typed output holds.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// partials: (B, S, G, 2) f32, sums of x and x^2 over span s of sample b.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, int64_t per_sample,
                int C, int G, int64_t span, int S) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const T* xb = x + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;

  float sum = 0.f, sq = 0.f;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sum += v[j];
      sq += v[j] * v[j];
    }
  }

  __shared__ float s_sum[kMaxThreads], s_sq[kMaxThreads];
  s_sum[t] = sum;
  s_sq[t] = sq;
  __syncthreads();

  // each full warp reduces its groups over the threads whose channels lie in them
  const int warp = t / 32, lane = t % 32, gs = C / G, warps = nt / 32;
  for (int g = warp; warp < warps && g < G; g += warps) {
    float a = 0.f, q = 0.f;
    for (int u = lane; u < nt; u += 32) {
      if (((u * V) % C) / gs == g) {
        a += s_sum[u];
        q += s_sq[u];
      }
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) {
      float* p = partials + (((int64_t)b * S + s) * G + g) * 2;
      p[0] = a;
      p[1] = q;
    }
  }
}

// Mean and 1/std of every group of sample b from the S span partials, reduced in a
// fixed order (results do not change from run to run), into s_mean/s_inv.
__device__ __forceinline__ void gn_group_moments(const float* __restrict__ partials, int b, int S,
                                                 int G, float count, float eps, float* s_mean,
                                                 float* s_inv) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32, warps = blockDim.x / 32;
  for (int g = warp; warp < warps && g < G; g += warps) {
    float a = 0.f, q = 0.f;
    for (int k = lane; k < S; k += 32) {
      const float* p = partials + (((int64_t)b * S + k) * G + g) * 2;
      a += p[0];
      q += p[1];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) {
      const float mean = a / count;
      const float var = q / count - mean * mean;
      s_mean[g] = mean;
      s_inv[g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
}

// [SiLU]((v - mean) * inv * mul + add), every rounding pinned by intrinsics (the one fma
// included), so each kernel that normalises computes the same bits.
__device__ __forceinline__ float gn_affine_silu(float v, float mean, float inv, float mul,
                                                float add, int silu) {
  float o = __fmaf_rn(__fmul_rn(__fsub_rn(v, mean), inv), mul, add);
  if (silu) o = __fdiv_rn(o, __fadd_rn(1.f, expf(-o)));
  return o;
}

}  // namespace
