// Int8 3x3 convolution over NHWC activations as an implicit GEMM, for Hopper (sm_90a): K5.
//
// Replaces diamond_tpu/ops/quant.py::conv3x3_q8_static (and the conv of
// ops/fused_q8.py::conv3x3_qtensor), which XLA computes on the TPU's int8 MXU:
//   xq = clip(round(x / s_c), +-127) with the calibrated per-input-channel scale
//   s_c = max(act_max_c, 1e-8) * 1.05 / 127 (or x already int8),
//   acc = conv(xq, w_q) in int32,   y = f32(acc) * w_scale[n] [* sample_scale[b]].
// The GEMM view is conv_common.cuh's, with K3's tiling (conv3x3.cu): A gathered from x
// per K-step and never stored, B = w_q viewed as (9 * Cin, Cout).
//
// Epilogue, in the JAX package's order (quant.py:187, then .astype(dtype) at
// blocks.py:202, then + b.astype(dtype) at :210): f32(acc) with round-to-nearest-even
// (acc reaches 9 * 128 * 127^2 ~ 1.9e7 > 2^24 at Cin = 128, so the conversion rounds)
// times the f32 factor w_scale[n], or (sample_scale[b] * w_scale[n]) for a QTensor
// (fused_q8.py:104); in bf16 that product is rounded to bf16, the bias rounded to bf16
// is added and the sum rounded again; in f32 the bias is added to it. Every rounding is
// pinned by intrinsics, so no multiply-add is contracted.
//
// What bounds it: like K3 on the rollout's narrow shapes (Cin, Cout <= 128), how fast
// tiles of x reach the tensor cores; an int8 x is half the bytes of a bf16 one, and the
// int8 tensor-core rate is twice the bf16 rate.
//
// Design, simple first:
//   * 64x64 output tile per block of 4 warps, K in steps of 64. Each warp multiplies a
//     32x32 sub-tile with WMMA 16x16x16 s8 fragments and s32 accumulators.
//   * Shared tiles are stored as 16-wide k (A) or n (B) chunks, each a dense 16-byte
//     row, so every fragment starts 256-bit aligned as WMMA requires (a 16-element int8
//     step is only 16 bytes).
//   * A gather: one 16-byte load (int8 x) or the 16 channels of a k-chunk quantized as
//     they are loaded (bf16/f32 x), when Cin % 16 == 0 (a k-chunk is 16 adjacent
//     channels of one pixel); element by element otherwise (the rew/end conv_in, Cin = 6).
//     Taps in the padding and K past 9 * Cin give code 0, the quantized zero padding.
//   * B: 16-byte loads of w_q rows when Cout % 16 == 0, element by element otherwise
//     (conv_out, Cout = 3). No pipelining, no TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "q8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int QBM = 64, QBN = 64, QBK = 64, QCH = 16;  // QCH: bytes of one k/n chunk row
constexpr int QC_LD = QBN + 4;
constexpr int kQThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One code of A from x at off (channel ci).
__device__ __forceinline__ signed char load_code(const signed char* x, int64_t off,
                                                 const float*, int) {
  return x[off];
}
template <typename T>
__device__ __forceinline__ signed char load_code(const T* x, int64_t off,
                                                 const float* __restrict__ act_max, int ci) {
  return quantize_q8(to_f32(x[off]), static_scale(act_max[ci]));
}

// The 16 codes of channels ci..ci+15 at off (16-element aligned) into dst.
__device__ __forceinline__ void load_codes16(const signed char* x, int64_t off, const float*,
                                             int, signed char* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x + off);
}
__device__ __forceinline__ void quantize16(const float* v, const float* __restrict__ act_max,
                                           int ci, signed char* dst) {
  union {
    signed char q[16];
    uint4 u;
  } out;
#pragma unroll
  for (int j = 0; j < 16; ++j) out.q[j] = quantize_q8(v[j], static_scale(act_max[ci + j]));
  *reinterpret_cast<uint4*>(dst) = out.u;
}
__device__ __forceinline__ void load_codes16(const bf16* x, int64_t off,
                                             const float* __restrict__ act_max, int ci,
                                             signed char* dst) {
  float v[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + off + 8 * h);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      v[8 * h + 2 * i] = f.x;
      v[8 * h + 2 * i + 1] = f.y;
    }
  }
  quantize16(v, act_max, ci, dst);
}
__device__ __forceinline__ void load_codes16(const float* x, int64_t off,
                                             const float* __restrict__ act_max, int ci,
                                             signed char* dst) {
  float v[16];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 f = *reinterpret_cast<const float4*>(x + off + 4 * h);
    v[4 * h] = f.x;
    v[4 * h + 1] = f.y;
    v[4 * h + 2] = f.z;
    v[4 * h + 3] = f.w;
  }
  quantize16(v, act_max, ci, dst);
}

struct Epilogue {
  const float* w_scale;       // (Cout,)
  const float* sample_scale;  // (B,) or null
  const float* bias;          // (Cout,) or null
  void* y;                    // (M, Cout), f32 or bf16
  int out_bf16;
};

template <typename T>
__global__ void __launch_bounds__(kQThreads)
conv3x3_q8_wmma(const T* __restrict__ x, const float* __restrict__ act_max,
                const signed char* __restrict__ w, Epilogue ep, ConvShape p) {
  using namespace nvcuda;
  // As[kc][r][j] = A[m0 + r, k0 + 16 kc + j]; Bs[nc][k][j] = B[k0 + k, n0 + 16 nc + j]
  __shared__ __align__(128) signed char As[QBK / QCH][QBM][QCH];
  __shared__ __align__(128) signed char Bs[QBN / QCH][QBK][QCH];
  __shared__ __align__(128) int Cs[QBM * QC_LD];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // this warp's 32x32 quarter of the tile
  const int64_t m0 = (int64_t)blockIdx.x * QBM;
  const int n0 = blockIdx.y * QBN;
  const bool a_vec = (p.Cin % QCH) == 0;
  const bool b_vec = (p.Cout % QCH) == 0;

  // vector path: this thread gathers k-chunk tid % 4 of rows tid / 4 and tid / 4 + 32
  RowCoord rows[2];
  rows[0] = row_coord(p, m0 + tid / 4);
  rows[1] = row_coord(p, m0 + tid / 4 + 32);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < p.K; k0 += QBK) {
    if (a_vec) {
      const int kc = tid % 4;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = tid / 4 + 32 * i;
        const int k = k0 + kc * QCH;
        const int64_t off = x_offset(p, rows[i], k);
        signed char* dst = &As[kc][r][0];
        if (off >= 0)
          load_codes16(x, off, act_max, k % p.Cin, dst);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < QBM * QBK; e += kQThreads) {
        const int r = e / QBK, kk = e % QBK, k = k0 + kk;
        const int64_t off = x_offset(p, row_coord(p, m0 + r), k);
        As[kk / QCH][r][kk % QCH] = off >= 0 ? load_code(x, off, act_max, k % p.Cin) : 0;
      }
    }
    if (b_vec) {
      for (int e = tid; e < QBK * (QBN / QCH); e += kQThreads) {
        const int kr = e / (QBN / QCH), nc = e % (QBN / QCH);
        const int k = k0 + kr, n = n0 + nc * QCH;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < p.K && n < p.Cout)
          v = *reinterpret_cast<const uint4*>(w + (int64_t)k * p.Cout + n);
        *reinterpret_cast<uint4*>(&Bs[nc][kr][0]) = v;
      }
    } else {
      for (int e = tid; e < QBK * QBN; e += kQThreads) {
        const int kr = e / QBN, nn = e % QBN;
        const int k = k0 + kr, n = n0 + nn;
        Bs[nn / QCH][kr][nn % QCH] = (k < p.K && n < p.Cout) ? w[(int64_t)k * p.Cout + n] : 0;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < QBK / QCH; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[kc][wm * 32 + i * 16][0], QCH);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[wn * 2 + j][kc * 16][0], QCH);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * QC_LD + wn * 32 + j * 16], acc[i][j],
                              QC_LD, wmma::mem_row_major);
  __syncthreads();

  const int64_t hw = (int64_t)p.Ho * p.Wo;
  for (int e = tid; e < QBM * QBN; e += kQThreads) {
    const int r = e / QBN, c = e % QBN;
    const int64_t m = m0 + r;
    const int n = n0 + c;
    if (m >= p.M || n >= p.Cout) continue;
    float factor = ep.w_scale[n];
    if (ep.sample_scale != nullptr) factor = __fmul_rn(ep.sample_scale[m / hw], factor);
    const float o = __fmul_rn(__int2float_rn(Cs[r * QC_LD + c]), factor);
    if (ep.out_bf16) {
      bf16 h = __float2bfloat16_rn(o);
      if (ep.bias != nullptr)
        h = __float2bfloat16_rn(__fadd_rn(__bfloat162float(h),
                                          __bfloat162float(__float2bfloat16_rn(ep.bias[n]))));
      static_cast<bf16*>(ep.y)[m * p.Cout + n] = h;
    } else {
      static_cast<float*>(ep.y)[m * p.Cout + n] =
          ep.bias != nullptr ? __fadd_rn(o, ep.bias[n]) : o;
    }
  }
}

}  // namespace

// x: (B, H, W, Cin), x_dtype 0 float32, 1 bfloat16, 2 int8 (codes, act_max unused);
// act_max: (Cin,) f32; w_q: (9 * Cin, Cout) int8; w_scale: (Cout,) f32; sample_scale:
// (B,) f32 or null; bias: (Cout,) f32 or null; y: (B, Ho, Wo, Cout), out_dtype 0 float32,
// 1 bfloat16, with Ho = (H - 1) / stride + 1.
extern "C" int conv3x3_q8_fwd(const void* x, int x_dtype, const void* act_max, const void* w_q,
                              const void* w_scale, const void* sample_scale, const void* bias,
                              void* y, int out_dtype, int B, int H, int W, int Cin, int Cout,
                              int stride, void* stream) {
  const ConvShape p = conv_shape(B, H, W, Cin, Cout, stride);
  const Epilogue ep{static_cast<const float*>(w_scale), static_cast<const float*>(sample_scale),
                    static_cast<const float*>(bias), y, out_dtype == 1};
  const float* am = static_cast<const float*>(act_max);
  const signed char* wq = static_cast<const signed char*>(w_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((p.M + QBM - 1) / QBM), (Cout + QBN - 1) / QBN);
  if (out_dtype != 0 && out_dtype != 1) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    conv3x3_q8_wmma<float><<<grid, kQThreads, 0, st>>>(static_cast<const float*>(x), am, wq, ep, p);
  else if (x_dtype == 1)
    conv3x3_q8_wmma<bf16><<<grid, kQThreads, 0, st>>>(static_cast<const bf16*>(x), am, wq, ep, p);
  else if (x_dtype == 2)
    conv3x3_q8_wmma<signed char><<<grid, kQThreads, 0, st>>>(static_cast<const signed char*>(x),
                                                             am, wq, ep, p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
