// Fused GroupNorm(+FiLM)+SiLU over NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernels of diamond_tpu/ops/fused_norms.py:
//   * fused_adagn_silu     (_adagn_silu_kernel): SiLU(GN(x) * (1 + scale_b) + shift_b)
//   * fused_groupnorm_silu (_gn_silu_kernel):    [SiLU](GN(x) * scale + bias)
// Groups hold C/G adjacent channels; statistics are the single-pass f32 moments
// mean = E[x], var = E[x^2] - E[x]^2 of diamond_tpu's _gn_stats_channels, eps 1e-5.
//
// What bounds it: bytes. Per element it reads x twice (statistics, then apply) and
// writes y once, with a handful of flops in between, far below the card's
// flop-per-byte balance. The Pallas kernel keeps one whole image in VMEM and reads x
// once; a 64x64x128 bf16 image is 1 MB, more than a Hopper block's 227 KB of shared
// memory, so here the two passes are two kernels and the second read usually comes
// from the 50 MB L2.
//
// Design:
//   * gn_stats: grid (S, B). Block (s, b) sums x and x^2 over one contiguous span of
//     sample b (a whole number of pixels) and writes one partial per group. Splitting
//     every sample into S spans keeps all 132 SMs busy at B*G = 64.
//   * gn_apply: grid (S, B). Each block first reduces the S partials of its sample to
//     mean and 1/std per group (in a fixed order, so results do not change from run to
//     run), then normalises, applies the affine or FiLM, and the SiLU.
//   * 16-byte loads and stores along C. A block has T threads, T the largest multiple
//     of C / V up to 256, and every thread steps by T * V elements, a multiple of C, so
//     a thread always sees the same V channels: their group and affine coefficients
//     stay in registers.
//   * Group reductions: full warp w reduces groups w, w + T/32, ... with shuffles.
// The host wrapper (diamond_tpu_torch/ops/fused_norms.py) picks T and checks what this
// needs: C % V == 0, (C / G) % V == 0, C / V <= 256, G <= 64, 16-byte aligned pointers.

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

// y = [SiLU]((x - mean) * inv * a_c + shift_c), a_c = scale_c or 1 + scale_c.
// scale/shift of sample b start at b * ss_bstride (0 for GroupNorm's shared affine).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ partials,
                const float* __restrict__ scale, const float* __restrict__ shift,
                int64_t ss_bstride, int one_plus, int silu, int64_t per_sample, int C, int G,
                int64_t span, int S, float count, float eps) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int warp = t / 32, lane = t % 32, gs = C / G, warps = nt / 32;

  __shared__ float s_mean[kMaxGroups], s_inv[kMaxGroups];
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

  const int c0 = (t * V) % C;
  const float mean = s_mean[c0 / gs], inv = s_inv[c0 / gs];
  float mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sc = scale[(int64_t)b * ss_bstride + c0 + j];
    mul[j] = one_plus ? 1.f + sc : sc;
    add[j] = shift[(int64_t)b * ss_bstride + c0 + j];
  }

  const T* xb = x + (int64_t)b * per_sample;
  T* yb = y + (int64_t)b * per_sample;
  const int64_t start = (int64_t)s * span;
  const int64_t end = start + span < per_sample ? start + span : per_sample;
  for (int64_t i = start + (int64_t)t * V; i < end; i += (int64_t)nt * V) {
    float v[V];
    load_vec(xb + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float o = (v[j] - mean) * inv;
      o = o * mul[j] + add[j];
      if (silu) o = o / (1.f + expf(-o));
      v[j] = o;
    }
    store_vec(yb + i, v);
  }
}

template <typename T>
int launch(const void* x, void* y, const float* scale, const float* shift, int64_t ss_bstride,
           int one_plus, int silu, int B, int HW, int C, int G, float* partials, int S,
           int64_t span, int threads, cudaStream_t stream) {
  const int64_t per_sample = (int64_t)HW * C;
  const float count = (float)((int64_t)HW * (C / G));
  const dim3 grid(S, B);
  gn_stats_kernel<T><<<grid, threads, 0, stream>>>(static_cast<const T*>(x), partials,
                                                    per_sample, C, G, span, S);
  gn_apply_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), partials, scale, shift, ss_bstride,
      one_plus, silu, per_sample, C, G, span, S, count, 1e-5f);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* x, void* y, const float* scale, const float* shift,
             int64_t ss_bstride, int one_plus, int silu, int B, int HW, int C, int G,
             void* partials, int S, int64_t span, int threads, void* stream) {
  float* p = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, scale, shift, ss_bstride, one_plus, silu, B, HW, C, G, p, S,
                         span, threads, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, scale, shift, ss_bstride, one_plus, silu, B, HW, C, G,
                                 p, S, span, threads, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. scale_shift: (B, 2C) f32, FiLM scale then shift.
extern "C" int adagn_silu_fwd(const void* x, const void* scale_shift, void* y, int B, int HW,
                              int C, int G, int silu, void* partials, int S, int64_t span,
                              int threads, int dtype, void* stream) {
  const float* ss = static_cast<const float*>(scale_shift);
  return dispatch(dtype, x, y, ss, ss + C, 2 * (int64_t)C, 1, silu, B, HW, C, G, partials, S,
                  span, threads, stream);
}

// scale, bias: (C,) f32, shared by every sample.
extern "C" int groupnorm_silu_fwd(const void* x, const void* scale, const void* bias, void* y,
                                  int B, int HW, int C, int G, int silu, void* partials, int S,
                                  int64_t span, int threads, int dtype, void* stream) {
  return dispatch(dtype, x, y, static_cast<const float*>(scale), static_cast<const float*>(bias),
                  0, 0, silu, B, HW, C, G, partials, S, span, threads, stream);
}
