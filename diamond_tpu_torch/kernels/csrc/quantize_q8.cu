// Per-tensor absmax int8 quantize, for Hopper (sm_90a): the activation side of K7.
//
// Replaces the activation half of diamond_tpu/ops/quant.py::conv3x3_q8 (:212), which XLA
// computes on the TPU:
//   sx = max(max |x| over the whole tensor, 1e-12) / 127,   q = clip(round(x / sx), +-127),
// rounding half to even after a true division. K5 (conv3x3_q8.cu) then convolves q with
// sample_scale = sx and forms sx * sw[n] before it multiplies the int32 sum, as quant.py:231
// does (ops/quantize_q8.py, ops/quant.py conv3x3_q8).
//
// What bounds it: bytes (one max and one quantize per element). The bound counts x read
// once and q written once; the two passes read x twice (the second read mostly from L2
// where x fits in its 50 MB).
//
// Design: two kernels on the caller's stream, no atomics and no host synchronisation, so
// sx never reaches the host: (1) G blocks each reduce a grid-stride share of |x| to one
// partial maximum (a float max is exact, so the result does not depend on the split or the
// order); (2) every block of the second grid reduces the G partials again (G <= 1024
// floats), forms sx = max(m, 1e-12) / 127 with a true division, and writes the codes of
// its share (q8_common.cuh quantize_q8_rcp: the code of a true IEEE division by sx, from a
// multiply by 1/sx that divides where the product lies near a rounding tie); block 0 also
// writes sx to each of the B entries of the scale. 16-byte loads where x is aligned,
// element by element otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "q8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;

// The largest value of v over the block (every thread gets it).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
  __shared__ float all;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (threadIdx.x == 0) all = w;
  }
  __syncthreads();
  return all;
}

// V elements (16 bytes) per vector where x is 16-byte aligned, else 1.
template <typename X, int V>
__global__ void __launch_bounds__(kThreads)
absmax_partial_kernel(const X* __restrict__ x, int64_t n, float* __restrict__ partial) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  float m = 0.f;
  for (int64_t i = first; i < n / V; i += stride) {
    if constexpr (V == 1) {
      m = fmaxf(m, fabsf(to_f32(x[i])));
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(x + i * V);
      const X* e = reinterpret_cast<const X*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(to_f32(e[j])));
    }
  }
  for (int64_t i = n / V * V + first; i < n; i += stride) m = fmaxf(m, fabsf(to_f32(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <typename X, int V>
__global__ void __launch_bounds__(kThreads)
absmax_quantize_kernel(const X* __restrict__ x, int64_t n, const float* __restrict__ partial,
                       int parts, signed char* __restrict__ q, float* __restrict__ scale,
                       int batch) {
  float m = 0.f;
  for (int i = threadIdx.x; i < parts; i += kThreads) m = fmaxf(m, partial[i]);
  m = block_max(m);
  const float sx = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
  const float r = __frcp_rn(sx);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < batch; i += kThreads) scale[i] = sx;

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = first; i < n / V; i += stride) {
    if constexpr (V == 1) {
      q[i] = quantize_q8_rcp(to_f32(x[i]), sx, r);
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(x + i * V);
      const X* e = reinterpret_cast<const X*>(&u);
      union {
        signed char c[V];
        uint32_t w[V / 4];
      } out;
#pragma unroll
      for (int j = 0; j < V; ++j) out.c[j] = quantize_q8_rcp(to_f32(e[j]), sx, r);
      if constexpr (V == 8) {
        *reinterpret_cast<uint2*>(q + i * V) = make_uint2(out.w[0], out.w[1]);
      } else {
        *reinterpret_cast<uint32_t*>(q + i * V) = out.w[0];
      }
    }
  }
  for (int64_t i = n / V * V + first; i < n; i += stride)
    q[i] = quantize_q8_rcp(to_f32(x[i]), sx, r);
}

template <typename X, int V>
int launch(const void* x, int64_t n, float* partial, signed char* q, float* scale, int batch,
           cudaStream_t st) {
  const int64_t vectors = n / V + (n % V != 0);
  const int grid =
      (int)std::min<int64_t>(kMaxPartials, (vectors + 4 * kThreads - 1) / (4 * kThreads));
  const X* xp = static_cast<const X*>(x);
  absmax_partial_kernel<X, V><<<grid, kThreads, 0, st>>>(xp, n, partial);
  absmax_quantize_kernel<X, V>
      <<<grid, kThreads, 0, st>>>(xp, n, partial, grid, q, scale, batch);
  return (int)cudaGetLastError();
}

template <typename X>
int launch_aligned(const void* x, int64_t n, float* partial, signed char* q, float* scale,
                   int batch, cudaStream_t st) {
  constexpr int V = 16 / sizeof(X);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % V == 0)
    return launch<X, V>(x, n, partial, q, scale, batch, st);
  return launch<X, 1>(x, n, partial, q, scale, batch, st);
}

}  // namespace

// x: n elements, x_dtype 0 float32, 1 bfloat16; partial: kMaxPartials (1024) f32 of
// scratch; q: n int8 codes; scale: (batch,) f32, each entry sx.
extern "C" int absmax_quantize_q8_fwd(const void* x, int x_dtype, int64_t n, void* partial,
                                      void* q, void* scale, int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(scale);
  if (n <= 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0) return launch_aligned<float>(x, n, part, qp, sp, batch, st);
  if (x_dtype == 1) return launch_aligned<bf16>(x, n, part, qp, sp, batch, st);
  return (int)cudaErrorInvalidValue;
}
