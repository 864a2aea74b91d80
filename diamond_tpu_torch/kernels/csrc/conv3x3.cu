// 3x3 convolution over NHWC activations as an implicit GEMM, for Hopper (sm_90a): K3.
//
// Replaces the TPU kernel diamond_tpu/ops/conv3x3.py::conv3x3_im2col (_conv_kernel),
// which builds the 9*C patches of one padded image in VMEM and contracts them in one
// MXU matmul. Here the same product runs as a GEMM whose A operand is never stored
// (conv_halo.cuh): stride 1 or 2 with one pixel of zero padding on each side
// (lax.conv_general_dilated with padding ((1, 1), (1, 1))), an optional f32 bias added
// to the f32 sum, output in the input's dtype.
//
// What bounds it: on the rollout's shapes (Cin, Cout <= 128) the GEMM is narrow (18 * Cin *
// Cout / (2 * Cin + 2 * Cout) operations per byte of x and y, 288 at Cin = Cout = 64,
// below the card's 295), so at best it is bound by the bytes of x and y; the small levels (8x8 and
// 16x16 at B = 32) are bound by latency.
//
// Design:
//   * bf16: conv_halo.cuh's kernel. Each tile's input pixels are loaded once into a halo
//     tile in shared memory (16-byte cp.async, two buffers where they fit, so the next
//     tile's halo loads during this tile's math); each warp reads the nine shifted A
//     slices from it with ldmatrix, and wgmma m64nNk16 bf16 -> f32 multiplies them with
//     the block's weights, held in shared memory for all the tiles the persistent block
//     walks. N = 8, 16, 32 or 64 fitted to Cout. Cin that is not a multiple of 16 (the
//     input convs, Cin = 3, 6, 12) is zero-padded in the halo tile and the weights. The
//     epilogue adds the bias to the f32 sums in registers and rounds to bf16 once.
//   * f32: 64x64x16 tiles on CUDA cores (4x4 outputs per thread, fmaf, A gathered per
//     K-step through conv_common.cuh), so that f32 results carry no TF32 rounding. It
//     serves the parity runs in f32 only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "conv_halo.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 inputs: the halo-tile wgmma kernel with a bias epilogue

struct BiasBf16 {
  using Acc = float;
  using Out = bf16;
  const float* bias;  // (Cout,) or null
  bf16* y;            // (M, Cout)
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ bf16 convert(int n, float v) const {
    return __float2bfloat16_rn(bias != nullptr ? v + bias[n] : v);
  }
};

// ---------------------------------------------------------------------------
// f32 inputs, CUDA cores

constexpr int SBM = 64, SBN = 64, SBK = 16;
constexpr int kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
conv3x3_f32_simt(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, ConvShape p) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * SBM;
  const int n0 = blockIdx.y * SBN;

  // this thread gathers rows tid/16 + 16*i of the A tile at k = tid % 16
  RowCoord rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = row_coord(p, m0 + tid / 16 + 16 * i);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += SBK) {
    const int ka = tid % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t off = x_offset(p, rows[i], k0 + ka);
      As[ka][tid / 16 + 16 * i] = off >= 0 ? x[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * kSimtThreads;
      const int kr = e / SBN, nn = e % SBN;
      const int k = k0 + kr, n = n0 + nn;
      Bs[kr][nn] = (k < p.K && n < p.Cout) ? w[(int64_t)k * p.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.Cout) continue;
      y[m * p.Cout + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

}  // namespace

// bf16: x (B, H, W, Cin), w (9 * Cin, Cout), bias (Cout,) f32 or null, y (B, Ho, Wo,
// Cout); plan: the launch plan's ints (ops/conv_plan.py PLAN_FIELDS).
extern "C" int conv3x3_bf16_fwd(const void* x, const void* w, const void* bias, void* y,
                                const int* plan, void* stream) {
  const HaloPlan p = read_plan(plan);
  const BiasBf16 ep{static_cast<const float*>(bias), static_cast<bf16*>(y)};
  return launch_halo(static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr, ep, p,
                     static_cast<cudaStream_t>(stream));
}

// f32: the same operands in float32, y with Ho = (H - 1) / stride + 1.
extern "C" int conv3x3_f32_fwd(const void* x, const void* w, const void* bias, void* y, int B,
                               int H, int W, int Cin, int Cout, int stride, void* stream) {
  const ConvShape p = conv_shape(B, H, W, Cin, Cout, stride);
  const dim3 grid((unsigned)((p.M + SBM - 1) / SBM), (Cout + SBN - 1) / SBN);
  conv3x3_f32_simt<<<grid, kSimtThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), p);
  return (int)cudaGetLastError();
}
