// Int8 matrix product with static per-input-channel activation scales, for Hopper
// (sm_90a): K6.
//
// Replaces diamond_tpu/ops/quant.py::matmul_q8_static, which XLA computes on the TPU's
// int8 MXU (the int8 rollout's 1x1 convs, dense layers and LSTM gates):
//   xq = clip(round(x / s_c), +-127) with the calibrated per-input-channel scale
//   s_c = max(act_max_k, 1e-8) * 1.05 / 127 (or x already int8),
//   acc = xq @ w_q in int32,   y = f32(acc) * w_scale[n].
//
// Epilogue, in the JAX package's order (quant.py:209, then .astype(dtype) and
// + b.astype(dtype) at blocks.py:104, :109 and :149, :154), as K5's (conv3x3_q8.cu
// RescaleQ8): f32(acc) with round-to-nearest-even, times w_scale[n]; in bf16 that product
// is rounded to bf16, the bias rounded to bf16 is added and the sum rounded again; in f32
// the bias is added to it. Every rounding is pinned by intrinsics, so no multiply-add is
// contracted.
//
// What bounds it: bytes. At the sites' shapes (K <= 512, N <= 2048) a call does at most
// ~70 int8 operations per byte of x, w_q and y, far below the card's int8 balance of ~590
// (1,979 TOP/s over 3.35 TB/s): the kernel has to read x once and write y once.
//
// Design (a simple kernel that is right): a block of eight warps owns 64 rows and 64
// columns of y. It walks K in chunks of 128. Each thread issues all its loads of the chunk
// before it uses any: eight groups of four channels of x (16-byte loads where K and the
// row stride allow, else element by element) and two 16-byte vectors of the K-major
// weight copy w_k (N, round32(K)) (ops/matmul_q8.py kmajor_2d). x is quantized in
// registers to the code a true IEEE division by s_c gives (q8_common.cuh quantize_q8_rcp,
// as K5 and K4 quantize; a thread keeps the same four channels, so their scales sit in
// registers) and stored to shared memory as int8, with the weights. Each warp then runs
// mma.sync m16n8k32 s8 -> s32 over a slab of 16 rows and 32 columns (four 16x8
// accumulator tiles). Rows past M are skipped by whole warps and load as code 0, columns
// past N as weight 0; neither is stored. K past the last channel is code 0 in the tile and
// zero in w_k. Shared rows are padded to 144 bytes, so the fragment reads (lane (g, t)
// reads row g, word t) fall in 32 different banks. The epilogue's scales and biases are
// loaded before the main loop, and column pairs are stored together. It launches on the
// caller's stream, allocates nothing and never synchronises with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "q8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows of y per block
constexpr int kCols = 64;      // columns of y per block
constexpr int kChunk = 128;    // K per shared-memory chunk (4 mma K steps)
constexpr int kStride = 144;   // bytes per shared row: kChunk + 16, conflict-free reads
constexpr int kThreads = 256;  // 8 warps: 4 slabs of 16 rows x 2 halves of 32 columns
constexpr int kTiles = 4;      // 16x8 accumulator tiles a warp
constexpr int kGroups = kRows * (kChunk / 4) / kThreads;  // groups of 4 channels of x a thread
constexpr int kWVecs = kCols * (kChunk / 16) / kThreads;  // 16-byte vectors of w_k a thread
static_assert(kThreads >= kChunk && kThreads % 32 == 0, "one channel scale a thread");

// Four consecutive elements of x from p (4 * sizeof(X)-byte aligned), as floats.
template <typename X>
__device__ __forceinline__ void load4(const X* p, float* v) {
  if constexpr (std::is_same<X, float>::value) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y's element in Out: f32(acc) * w_scale, then the bias b in Out (where there is one).
template <typename Out>
__device__ __forceinline__ Out rescale(int acc, float ws, const float* bias, float b) {
  const float o = __fmul_rn(__int2float_rn(acc), ws);
  if constexpr (std::is_same<Out, float>::value) {
    return bias != nullptr ? __fadd_rn(o, b) : o;
  } else {
    const bf16 h = __float2bfloat16_rn(o);
    if (bias == nullptr) return h;
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(h), __bfloat162float(__float2bfloat16_rn(b))));
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// kVec: K and the row stride are multiples of 4 and x is 4 * sizeof(X)-byte aligned, so
// every group of four channels is one aligned load.
template <typename X, typename Out, bool kVec>
__global__ void __launch_bounds__(kThreads)
matmul_q8_kernel(const X* __restrict__ x, int64_t ldx, const float* __restrict__ act_max,
                 const signed char* __restrict__ w_k, const float* __restrict__ w_scale,
                 const float* __restrict__ bias, Out* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) signed char xs[kRows * kStride];
  __shared__ __align__(16) signed char ws[kCols * kStride];
  __shared__ float sc[kChunk], rc[kChunk];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t m0 = (int64_t)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int kp = (K + 31) & ~31;  // w_k's row length
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;  // the warp's rows and columns
  const bool rows_in = m0 + wr < M, cols_in = n0 + wc < N;
  const int c4 = (tid % (kChunk / 4)) * 4;  // the thread's four channels of every chunk

  // the epilogue's factors, loaded before the main loop: columns n0 + wc + 8j + 2t + {0, 1}
  float wsc[kTiles][2], bs[kTiles][2];
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wc + j * 8 + 2 * t + e;
      wsc[j][e] = n < N ? w_scale[n] : 0.f;
      bs[j][e] = n < N && bias != nullptr ? bias[n] : 0.f;
    }

  int acc[kTiles][4];
#pragma unroll
  for (int j = 0; j < kTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    const int steps = min(kChunk, kp - k0) / 32;
    // Every load of the chunk is issued before any is used (kGroups groups of four
    // channels of x and kWVecs 16-byte vectors of w_k a thread), so a thread keeps them
    // all in flight. A warp takes one row's 128 channels a group (rows warp + 8i), so a
    // row past M is skipped by the whole warp.
    float v[kGroups][4];
    uint32_t codes[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int64_t row = m0 + warp + i * (kThreads / 32);
      const int k = k0 + c4;
      const bool in = row < M && k < K;
      const X* p = x + (in ? row * ldx + k : 0);
      if constexpr (std::is_same<X, signed char>::value) {
        codes[i] = 0;
        if constexpr (kVec) {
          if (in) codes[i] = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in && k + j < K) codes[i] |= (uint32_t)(uint8_t)p[j] << (8 * j);
        }
      } else if constexpr (kVec) {
        if (in) {
          load4(p, v[i]);
        } else {
          v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = in && k + j < K ? to_f32(p[j]) : 0.f;
      }
    }
    uint4 wv[kWVecs];
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int r = (tid + i * kThreads) / (kChunk / 16), c = (tid % (kChunk / 16)) * 16;
      wv[i] = make_uint4(0, 0, 0, 0);
      if (n0 + r < N && k0 + c < kp)
        wv[i] = *reinterpret_cast<const uint4*>(w_k + (int64_t)(n0 + r) * kp + k0 + c);
    }
    if constexpr (!std::is_same<X, signed char>::value) {
      if (tid < kChunk) {
        const float s = k0 + tid < K ? static_scale(act_max[k0 + tid]) : 1.f;
        sc[tid] = s;
        rc[tid] = __frcp_rn(s);
      }
      __syncthreads();
    }
    float s4[4], r4[4];  // the scales of the thread's four channels
    if constexpr (!std::is_same<X, signed char>::value) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s4[j] = sc[c4 + j], r4[j] = rc[c4 + j];
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int r = warp + i * (kThreads / 32);
      uint32_t word = 0;
      if constexpr (std::is_same<X, signed char>::value) {
        word = codes[i];
      } else if (m0 + r < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const signed char q = k0 + c4 + j < K ? quantize_q8_rcp(v[i][j], s4[j], r4[j]) : 0;
          word |= (uint32_t)(uint8_t)q << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(xs + r * kStride + c4) = word;
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int r = (tid + i * kThreads) / (kChunk / 16), c = (tid % (kChunk / 16)) * 16;
      *reinterpret_cast<uint4*>(ws + r * kStride + c) = wv[i];
    }
    __syncthreads();

    if (rows_in && cols_in) {
      for (int s = 0; s < steps; ++s) {
        const signed char* ar = xs + (wr + g) * kStride + s * 32 + t * 4;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(ar);
        a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kStride);
        a[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kStride + 16);
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          const signed char* br = ws + (wc + j * 8 + g) * kStride + s * 32 + t * 4;
          mma_s8(acc[j], a, *reinterpret_cast<const uint32_t*>(br),
                 *reinterpret_cast<const uint32_t*>(br + 16));
        }
      }
    }
    if (k0 + kChunk < kp) __syncthreads();
  }

  // accumulator tile j: rows g and g + 8 of the warp's 16, columns 2t and 2t + 1, stored
  // as one pair where both columns exist and y's rows keep the pair aligned (N even)
  if (!rows_in || !cols_in) return;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int n = n0 + wc + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + wr + g + h * 8;
      if (row >= M || n >= N) continue;
      const Out o0 = rescale<Out>(acc[j][2 * h], wsc[j][0], bias, bs[j][0]);
      Out* dst = y + row * N + n;
      if (n + 1 < N) {
        const Out o1 = rescale<Out>(acc[j][2 * h + 1], wsc[j][1], bias, bs[j][1]);
        if (N % 2 == 0) {
          store_pair(dst, o0, o1);
        } else {
          dst[0] = o0;
          dst[1] = o1;
        }
      } else {
        dst[0] = o0;
      }
    }
  }
}

template <typename X, typename Out>
int launch(const void* x, int64_t ldx, const void* act_max, const void* w_k,
           const void* w_scale, const void* bias, void* y, int M, int K, int N,
           cudaStream_t st) {
  const dim3 grid((unsigned)((M + kRows - 1) / kRows), (unsigned)((N + kCols - 1) / kCols));
  const bool vec = K % 4 == 0 && ldx % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(X)) == 0;
  const X* xp = static_cast<const X*>(x);
  const float* am = static_cast<const float*>(act_max);
  const signed char* wk = static_cast<const signed char*>(w_k);
  const float* wsc = static_cast<const float*>(w_scale);
  const float* b = static_cast<const float*>(bias);
  Out* yp = static_cast<Out*>(y);
  if (vec)
    matmul_q8_kernel<X, Out, true>
        <<<grid, kThreads, 0, st>>>(xp, ldx, am, wk, wsc, b, yp, M, K, N);
  else
    matmul_q8_kernel<X, Out, false>
        <<<grid, kThreads, 0, st>>>(xp, ldx, am, wk, wsc, b, yp, M, K, N);
  return (int)cudaGetLastError();
}

template <typename X>
int launch_out(int out_dtype, const void* x, int64_t ldx, const void* act_max,
               const void* w_k, const void* w_scale, const void* bias, void* y, int M, int K,
               int N, cudaStream_t st) {
  if (out_dtype == 0)
    return launch<X, float>(x, ldx, act_max, w_k, w_scale, bias, y, M, K, N, st);
  if (out_dtype == 1)
    return launch<X, bf16>(x, ldx, act_max, w_k, w_scale, bias, y, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: M rows of K channels, row r at x + r * ldx elements; x_dtype 0 float32, 1 bfloat16,
// 2 int8 (codes, act_max unused); act_max: (K,) f32; w_k: the K-major copy
// (N, round32(K)) of w_q, int8 (ops/matmul_q8.py kmajor_2d); w_scale: (N,) f32; bias:
// (N,) f32 or null; y: (M, N) contiguous, out_dtype 0 float32, 1 bfloat16.
extern "C" int matmul_q8_fwd(const void* x, int x_dtype, int64_t ldx, const void* act_max,
                             const void* w_k, const void* w_scale, const void* bias, void* y,
                             int out_dtype, int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || (N + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return launch_out<float>(out_dtype, x, ldx, act_max, w_k, w_scale, bias, y, M, K, N, st);
  if (x_dtype == 1)
    return launch_out<bf16>(out_dtype, x, ldx, act_max, w_k, w_scale, bias, y, M, K, N, st);
  if (x_dtype == 2)
    return launch_out<signed char>(out_dtype, x, ldx, act_max, w_k, w_scale, bias, y, M, K, N,
                                   st);
  return (int)cudaErrorInvalidValue;
}
