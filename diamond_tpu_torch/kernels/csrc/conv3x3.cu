// 3x3 convolution over NHWC activations as an implicit GEMM, for Hopper (sm_90a).
//
// Replaces the TPU kernel diamond_tpu/ops/conv3x3.py::conv3x3_im2col (_conv_kernel),
// which builds the 9*C patches of one padded image in VMEM and contracts them in one
// MXU matmul. Here the same product runs as a GEMM whose A operand is never stored:
//   M = B * Ho * Wo output pixels, N = Cout, K = 9 * Cin in (ky, kx, ci) order,
//   A[m, k] = x[b, oy*s - 1 + ky, ox*s - 1 + kx, ci] (zero outside the image),
//   B = the HWIO kernel viewed as (9 * Cin, Cout).
// Stride 1 or 2 with one pixel of zero padding on each side (lax.conv_general_dilated
// with padding ((1, 1), (1, 1))), an optional f32 bias added to the f32 sum, output in
// the input's dtype.
//
// What bounds it: on the rollout's shapes (Cin, Cout <= 128) the GEMM is narrow, so it
// is bound by how fast tiles of x reach the tensor cores, not by their rate: each x
// element is gathered up to nine times (once per tap), mostly from L1/L2.
//
// Design, simple first:
//   * bf16: 64x64 output tile per block of 4 warps, K in steps of 32. The A tile is
//     gathered from x with 16-byte loads when Cin % 8 == 0 (a run of 8 k's is 8
//     adjacent channels of one pixel), element by element otherwise (Cin = 3, 6, 12
//     of the input convs); taps in the padding and K past 9 * Cin load zeros, so no
//     operand is padded in memory. Each warp multiplies a 32x32 sub-tile with WMMA
//     16x16x16 bf16 fragments and f32 accumulators; the epilogue adds the bias and
//     rounds to bf16 once. No pipelining, no TMA or wgmma yet.
//   * f32: the same tiling on CUDA cores (64x64x16 tiles, 4x4 outputs per thread,
//     fmaf), so that f32 results carry no TF32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct ConvShape {
  int B, H, W, Cin, Cout, stride, Ho, Wo, K;
  int64_t M;
};

// Output pixel m: where its sample starts in x and the input row/col of its window's
// top-left tap.
struct RowCoord {
  int64_t base;
  int iy0, ix0;
  bool valid;
};

__device__ __forceinline__ RowCoord row_coord(const ConvShape& p, int64_t m) {
  RowCoord r;
  r.valid = m < p.M;
  const int64_t mm = r.valid ? m : 0;
  const int64_t hw = (int64_t)p.Ho * p.Wo;
  const int b = (int)(mm / hw);
  const int rem = (int)(mm - (int64_t)b * hw);
  const int oy = rem / p.Wo, ox = rem - oy * p.Wo;
  r.base = (int64_t)b * p.H * p.W * p.Cin;
  r.iy0 = oy * p.stride - 1;
  r.ix0 = ox * p.stride - 1;
  return r;
}

// Offset in x of A[m, k], or -1 where the tap lies in the padding or k >= K.
__device__ __forceinline__ int64_t x_offset(const ConvShape& p, const RowCoord& r, int k) {
  if (!r.valid || k >= p.K) return -1;
  const int tap = k / p.Cin, ci = k - tap * p.Cin;
  const int ky = tap / 3, kx = tap - ky * 3;
  const int iy = r.iy0 + ky, ix = r.ix0 + kx;
  if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return -1;
  return r.base + ((int64_t)iy * p.W + ix) * p.Cin + ci;
}

// ---------------------------------------------------------------------------
// bf16 inputs, tensor cores through WMMA

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;  // padded against bank conflicts
constexpr int kWmmaThreads = 128;

__global__ void __launch_bounds__(kWmmaThreads)
conv3x3_bf16_wmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y, ConvShape p) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BM * A_LD];
  __shared__ __align__(32) bf16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // this warp's 32x32 quarter of the tile
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool a_vec = (p.Cin % 8) == 0;
  const bool b_vec = (p.Cout % 8) == 0;
  const bf16 zero = __float2bfloat16(0.f);

  // vector path: this thread gathers rows tid/4 and tid/4 + 32, k-octet tid % 4
  RowCoord rows[2];
  rows[0] = row_coord(p, m0 + tid / 4);
  rows[1] = row_coord(p, m0 + tid / 4 + 32);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    if (a_vec) {
      const int kq = (tid % 4) * 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = tid / 4 + 32 * i;
        const int64_t off = x_offset(p, rows[i], k0 + kq);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (off >= 0) v = *reinterpret_cast<const uint4*>(x + off);
        *reinterpret_cast<uint4*>(&As[r * A_LD + kq]) = v;
      }
    } else {
      for (int e = tid; e < BM * BK; e += kWmmaThreads) {
        const int r = e / BK, kk = e % BK;
        const int64_t off = x_offset(p, row_coord(p, m0 + r), k0 + kk);
        As[r * A_LD + kk] = off >= 0 ? x[off] : zero;
      }
    }
    if (b_vec) {
      for (int e = tid; e < BK * BN / 8; e += kWmmaThreads) {
        const int kr = e / (BN / 8), nv = (e % (BN / 8)) * 8;
        const int k = k0 + kr, n = n0 + nv;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < p.K && n < p.Cout)
          v = *reinterpret_cast<const uint4*>(w + (int64_t)k * p.Cout + n);
        *reinterpret_cast<uint4*>(&Bs[kr * B_LD + nv]) = v;
      }
    } else {
      for (int e = tid; e < BK * BN; e += kWmmaThreads) {
        const int kr = e / BN, nn = e % BN;
        const int k = k0 + kr, n = n0 + nn;
        Bs[kr * B_LD + nn] = (k < p.K && n < p.Cout) ? w[(int64_t)k * p.Cout + n] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
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
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();

  if (b_vec) {
    for (int e = tid; e < BM * BN / 8; e += kWmmaThreads) {
      const int r = e / (BN / 8), cv = (e % (BN / 8)) * 8;
      const int64_t m = m0 + r;
      const int n = n0 + cv;
      if (m >= p.M || n >= p.Cout) continue;
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float lo = Cs[r * C_LD + cv + 2 * j], hi = Cs[r * C_LD + cv + 2 * j + 1];
        if (bias != nullptr) {
          lo += bias[n + 2 * j];
          hi += bias[n + 2 * j + 1];
        }
        h[j] = __floats2bfloat162_rn(lo, hi);
      }
      *reinterpret_cast<uint4*>(y + m * p.Cout + n) = v;
    }
  } else {
    for (int e = tid; e < BM * BN; e += kWmmaThreads) {
      const int r = e / BN, c = e % BN;
      const int64_t m = m0 + r;
      const int n = n0 + c;
      if (m >= p.M || n >= p.Cout) continue;
      float o = Cs[r * C_LD + c];
      if (bias != nullptr) o += bias[n];
      y[m * p.Cout + n] = __float2bfloat16(o);
    }
  }
}

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

// x: (B, H, W, Cin); w: (9 * Cin, Cout) in x's dtype; bias: (Cout,) f32 or null;
// y: (B, Ho, Wo, Cout) with Ho = (H - 1) / stride + 1. dtype: 0 float32, 1 bfloat16.
extern "C" int conv3x3_fwd(const void* x, const void* w, const void* bias, void* y, int B,
                           int H, int W, int Cin, int Cout, int stride, int dtype,
                           void* stream) {
  ConvShape p;
  p.B = B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.K = 9 * Cin;
  p.M = (int64_t)B * p.Ho * p.Wo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    const dim3 grid((unsigned)((p.M + BM - 1) / BM), (Cout + BN - 1) / BN);
    conv3x3_bf16_wmma<<<grid, kWmmaThreads, 0, st>>>(static_cast<const bf16*>(x),
                                                     static_cast<const bf16*>(w), b,
                                                     static_cast<bf16*>(y), p);
  } else if (dtype == 0) {
    const dim3 grid((unsigned)((p.M + SBM - 1) / SBM), (Cout + SBN - 1) / SBN);
    conv3x3_f32_simt<<<grid, kSimtThreads, 0, st>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(w), b,
                                                    static_cast<float*>(y), p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
