// The weight gradient of the 3x3 SAME stride-1 convolution over NHWC activations, for
// Hopper (sm_90a): K3's backward for its weights.
//
// Replaces the weight half of the VJP that XLA derives for the JAX package's 3x3 convs
// (diamond_tpu/ops/conv3x3.py::conv3x3_im2col has no autodiff rule; the JAX blocks
// differentiate lax.conv). With dy the gradient of the output,
//   dW[ky, kx, ci, co] = sum over b, y, x of x[b, y + ky - 1, x + kx - 1, ci] * dy[b, y, x, co]
// (zero outside the image): an implicit GEMM with M = 9 * Cin rows (tap, ci), N = Cout,
// K = B * H * W pixels, neither operand stored, f32 sums.
//
// What bounds it: bytes at the actor-critic's shapes (B = 32, 64x64x32 -> 32: x and dy
// 16.8 MB, 5.0 µs at 3.35 TB/s, against 2.4 GFLOP, 2.4 µs at 989 TFLOP/s bf16).
//
// Design:
//   * bf16, on the tensor cores (mma.sync m16n8k16 bf16 -> f32). A block of 9 warps
//     owns 16 input channels (a slice of Cin, zero-padded to 16) and all Cout (<= 64,
//     zero-padded to NT = 16, 32 or 64); warp w owns tap w = (ky, kx), so its
//     accumulators are the 16 x NT block of dW of that tap and slice.
//   * K is split: the grid holds `kblocks` blocks per slice, block k walks the tiles k,
//     k + kblocks, ...; a tile is tr whole image rows of one sample. Per tile the block
//     loads the halo of x (tr + 2 rows of W + 2 pixels, its 16 channels, zero outside
//     the image) and the tile's dy (zero rows past the tile, zero channels past Cout)
//     into shared memory by 16-byte cp.async; every warp then reads its tap's A
//     fragment (16 channels x 16 pixels, transposed) from the halo with ldmatrix.trans
//     at per-lane pixel addresses (the tap's shift, row ends and ragged tiles need no
//     re-layout), and the dy fragments the same way.
//   * Each block writes its f32 partial dW; a second kernel sums the partials of a
//     slice in block order and rounds once to the output type: the same bits every run,
//     no atomics.
//   * f32 (the parity runs): the same product on CUDA cores, 64 x 64 tiles of
//     (tap, ci) x Cout over a split of K, A gathered per K step (conv_common.cuh), then
//     the same fixed-order sum; no TF32 rounding.
// The plan (ops/conv_plan.py wgrad_plan) is computed by the wrapper and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 9;               // one per tap
constexpr int kThreads = 32 * kWarps;
constexpr int kCh = 16;                 // input channels per block
constexpr int kHaloPx = kCh * 2 + 16;   // bytes per halo pixel: 16 channels + 16 of padding
constexpr int kSmemLimit = 232448;

// The launch plan, in ops/conv_plan.py WGRAD_FIELDS order.
struct WgradPlan {
  int B, H, W, Cin, Cout, nt, slices, tr, tiles_y, tiles, kblocks, ksteps, dy_stride, halo_bytes,
      smem, grid;
};
constexpr int kWgradFields = 16;

inline WgradPlan read_wgrad_plan(const int* v) {
  WgradPlan p;
  int* dst = &p.B;
  for (int i = 0; i < kWgradFields; ++i) dst[i] = v[i];
  return p;
}

inline bool wgrad_plan_ok(const WgradPlan& p) {
  const int halo = (p.tr + 2) * (p.W + 2) * kHaloPx;
  const int tile_px = p.tr * p.W;
  return p.B > 0 && p.H > 0 && p.W > 0 && p.Cin > 0 && p.Cout > 0 && p.Cout <= p.nt &&
         (p.nt == 16 || p.nt == 32 || p.nt == 64) && p.slices * kCh >= p.Cin &&
         (p.slices - 1) * kCh < p.Cin && p.tr >= 1 && p.tr <= p.H &&
         p.tiles_y * p.tr >= p.H && p.tiles == p.B * p.tiles_y && p.kblocks >= 1 &&
         p.kblocks <= p.tiles && p.ksteps * 16 >= tile_px && (p.ksteps - 1) * 16 < tile_px &&
         p.dy_stride == p.nt * 2 + 16 && p.halo_bytes == (halo + 127) / 128 * 128 &&
         p.smem == p.halo_bytes + p.ksteps * 16 * p.dy_stride && p.smem <= kSmemLimit &&
         p.grid == p.slices * p.kblocks;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16 x 8 f32) += A (16 x 16 bf16, row) * B (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_wgrad_mma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ part, WgradPlan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const halo = smem;
  unsigned char* const dys = smem + p.halo_bytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slice = blockIdx.x % p.slices, kb = blockIdx.x / p.slices;
  const int ci0 = slice * kCh;
  const int ky = warp / 3, kx = warp % 3;
  const int hc = p.W + 2;
  const int hpx = (p.tr + 2) * hc;
  const bool async_x = p.Cin % 8 == 0, async_dy = p.Cout % 8 == 0;
  // this lane's ldmatrix row: matrix i = lane / 8, row r = lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  const int a_px = (mi >> 1) * 8 + mr, a_ch = (mi & 1) * 8;  // A: pixels, then channels
  const int b_px = (mi & 1) * 8 + mr, b_ch = (mi >> 1) * 8;  // B: channels, then pixels

  float acc[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int tile = kb; tile < p.tiles; tile += p.kblocks) {
    const int b = tile / p.tiles_y, y0 = (tile - b * p.tiles_y) * p.tr;
    const int rows = min(p.tr, p.H - y0), tile_px = rows * p.W;
    const bf16* xb = x + (int64_t)b * p.H * p.W * p.Cin;
    const bf16* dyb = dy + ((int64_t)b * p.H + y0) * p.W * p.Cout;
    __syncthreads();  // every warp is done with the last tile
    // the halo: pixel (hy, hx) is x[y0 - 1 + hy, hx - 1, ci0 .. ci0 + 15], two 16-byte halves
    for (int i = tid; i < hpx * 2; i += kThreads) {
      const int px = i >> 1, half = i & 1, hy = px / hc, hx = px - hy * hc;
      const int iy = y0 - 1 + hy, ix = hx - 1, c = ci0 + half * 8;
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      unsigned char* dst = halo + px * kHaloPx + half * 16;
      const bf16* src = xb + ((int64_t)iy * p.W + ix) * p.Cin + c;
      if (async_x) {
        cp_async16(smem_u32(dst), in && c < p.Cin ? src : x, in && c < p.Cin);
      } else {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = in && c + j < p.Cin ? src[j] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
    // dy: rows of NT channels for the tile's pixels, zero past the tile and past Cout
    constexpr int kChunks = NT / 8;
    for (int i = tid; i < p.ksteps * 16 * kChunks; i += kThreads) {
      const int px = i / kChunks, c = (i - px * kChunks) * 8;
      unsigned char* dst = dys + px * p.dy_stride + c * 2;
      const bf16* src = dyb + (int64_t)px * p.Cout + c;
      const bool ok = px < tile_px && c < p.Cout;
      if (async_dy) {
        cp_async16(smem_u32(dst), ok ? src : dy, ok);
      } else {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = ok && c + j < p.Cout ? src[j] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    for (int s = 0; s < p.ksteps; ++s) {
      // A: this warp's tap, 16 channels x 16 pixels; pixels past the tile read pixel 0
      // (their dy rows are zero)
      const int k = s * 16 + a_px, kk = k < tile_px ? k : 0;
      const int py = kk / p.W, pxx = kk - py * p.W;
      uint32_t a[4];
      ldmatrix_x4_trans(a, smem_u32(halo + ((py + ky) * hc + pxx + kx) * kHaloPx + a_ch * 2));
#pragma unroll
      for (int j = 0; j < NT / 8; j += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, smem_u32(dys + (s * 16 + b_px) * p.dy_stride + (j * 8 + b_ch) * 2));
        mma_bf16(acc[j], a, bb[0], bb[1]);
        mma_bf16(acc[j + 1], a, bb[2], bb[3]);
      }
    }
  }

  // this block's partial: part[kb][tap][ci][co], rows ci of the slice, Cout columns
  const int g = lane >> 2, t4 = lane & 3;
  const int cpad = p.slices * kCh;
  float* out = part + ((int64_t)kb * 9 + warp) * cpad * p.Cout;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ci0 + g + (i >> 1) * 8, n = j * 8 + t4 * 2 + (i & 1);
      if (n < p.Cout) out[(int64_t)m * p.Cout + n] = acc[j][i];
    }
}

// f32: 64 x 64 tiles of (tap, ci) x Cout on CUDA cores, K (pixels) split over gridDim.z.
constexpr int SBM = 64, SBN = 64, SBK = 16, kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
wgrad_f32_simt(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ part, ConvShape p, int64_t k_per_split) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SBM, n0 = blockIdx.y * SBN;
  const int64_t k_begin = blockIdx.z * k_per_split;
  const int64_t k_end = k_begin + k_per_split < p.M ? k_begin + k_per_split : p.M;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += SBK) {
    // A[kk][m] = x at pixel k0 + kk shifted by tap m / Cin, channel m % Cin
    const int kk = tid / 16;
    const RowCoord r = row_coord(p, k0 + kk < k_end ? k0 + kk : p.M);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + tx + 16 * i;
      const int64_t off = x_offset(p, r, m);
      As[kk][tx + 16 * i] = off >= 0 ? x[off] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + tx + 16 * i;
      const int64_t k = k0 + kk;
      Bs[kk][tx + 16 * i] = k < k_end && n < p.Cout ? dy[k * p.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < SBK; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[q][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (int64_t)blockIdx.z * p.K * p.Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.Cout) out[(int64_t)m * p.Cout + n] = acc[i][j];
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// dW[tap][ci][co] = sum over parts q = 0, 1, ... of part[q][tap][ci][co] (rows ci of
// cpad), in that order, rounded once to Out.
template <typename Out>
__global__ void wgrad_reduce(const float* __restrict__ part, int parts, int cin, int cpad,
                             int cout, Out* __restrict__ dw) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = 9LL * cin * cout;
  if (i >= total) return;
  const int co = (int)(i % cout), ci = (int)(i / cout % cin), tap = (int)(i / cout / cin);
  const int64_t per = 9LL * cpad * cout;
  const float* src = part + ((int64_t)tap * cpad + ci) * cout + co;
  float s = 0.f;
  for (int q = 0; q < parts; ++q) s = __fadd_rn(s, src[q * per]);
  store_out(dw + i, s);
}

template <int NT>
int launch_wgrad_nt(const bf16* x, const bf16* dy, float* part, const WgradPlan& p,
                    cudaStream_t st) {
  auto kernel = conv3x3_wgrad_mma<NT>;
  static int smem_set = 0;
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  kernel<<<p.grid, kThreads, p.smem, st>>>(x, dy, part, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: x (B, H, W, Cin), dy (B, H, W, Cout), part: (kblocks, 9, slices * 16, Cout) f32
// scratch, dw (3, 3, Cin, Cout) bf16; plan: ops/conv_plan.py wgrad_plan's ints.
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* dy, void* part, void* dw,
                                  const int* plan, void* stream) {
  const WgradPlan p = read_wgrad_plan(plan);
  if (!wgrad_plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  float* pt = static_cast<float*>(part);
  int e;
  switch (p.nt) {
    case 16: e = launch_wgrad_nt<16>(xb, dyb, pt, p, st); break;
    case 32: e = launch_wgrad_nt<32>(xb, dyb, pt, p, st); break;
    case 64: e = launch_wgrad_nt<64>(xb, dyb, pt, p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  const int64_t total = 9LL * p.Cin * p.Cout;
  wgrad_reduce<bf16><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      pt, p.kblocks, p.Cin, p.slices * kCh, p.Cout, static_cast<bf16*>(dw));
  return (int)cudaGetLastError();
}

// f32: the same operands in float32, part: (splits, 9 * Cin, Cout) f32 scratch, dw f32;
// K split into `splits` ranges of k_per_split pixels (a multiple of 16).
extern "C" int conv3x3_wgrad_f32(const void* x, const void* dy, void* part, void* dw,
                                        int B, int H, int W, int Cin, int Cout, int splits,
                                        int64_t k_per_split, void* stream) {
  const ConvShape p = conv_shape(B, H, W, Cin, Cout, 1);
  if (splits < 1 || k_per_split < 1 || k_per_split % SBK || (splits - 1) * k_per_split >= p.M ||
      splits * k_per_split < p.M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((p.K + SBM - 1) / SBM, (Cout + SBN - 1) / SBN, splits);
  wgrad_f32_simt<<<grid, kSimtThreads, 0, st>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(dy),
                                                static_cast<float*>(part), p, k_per_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = 9LL * Cin * Cout;
  wgrad_reduce<float><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), splits, Cin, Cin, Cout, static_cast<float*>(dw));
  return (int)cudaGetLastError();
}
