// The implicit-GEMM view of a 3x3 SAME convolution over NHWC activations, shared by
// conv3x3.cu (K3) and conv3x3_q8.cu (K5):
//   M = B * Ho * Wo output pixels, N = Cout, K = 9 * Cin in (ky, kx, ci) order,
//   A[m, k] = x[b, oy*s - 1 + ky, ox*s - 1 + kx, ci] (zero outside the image),
//   B = the HWIO kernel viewed as (9 * Cin, Cout).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ConvShape {
  int B, H, W, Cin, Cout, stride, Ho, Wo, K;
  int64_t M;
};

inline ConvShape conv_shape(int B, int H, int W, int Cin, int Cout, int stride) {
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
  return p;
}

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

}  // namespace
