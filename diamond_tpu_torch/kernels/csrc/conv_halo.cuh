// The Hopper 3x3 SAME convolution shared by conv3x3.cu (K3, bf16) and conv3x3_q8.cu (K5,
// int8): an implicit GEMM over NHWC activations whose A operand is read from a halo tile
// in shared memory and whose products run on wgmma.
//   M = B * Ho * Wo output pixels, N = Cout, K = 9 * Cin in (ky, kx, ci) order,
//   A[m, k] = x[b, oy*s - 1 + ky, ox*s - 1 + kx, ci] (zero outside the image),
//   B = the HWIO kernel viewed as (9 * Cin, Cout).
//
// Design:
//   * Tiles. A tile is tr whole output rows of one image (tw = Wo), or, for Wo wider
//     than the block, tw pixels of one row; at most 64 pixels per warpgroup, so its
//     pixels are consecutive in M. A block of `wgs` warpgroups (1 or 2) owns one tile at
//     a time; warpgroup g computes the tile's pixels [64 g, 64 g + 64) against the
//     block's nt output channels (one wgmma N: 8, 16, 32 or 64, fitted to Cout; a grid
//     with too few tiles splits Cout into nslices slices of nt).
//   * Halo tile. The input pixels the tile reads, (tr-1)*s+3 rows by (tw-1)*s+3
//     columns with the one-pixel border, are loaded into shared memory once per tile,
//     zero outside the image (the SAME padding) and in the channels past Cin up to one
//     wgmma K step (cpad). Each of the nine taps reads its A slice from this tile at a
//     shifted (stride 2: strided) pixel offset, so x leaves L2 about once per tile, not
//     once per tap. A pixel's channels are padded by 16 bytes (pxb), so that the eight
//     rows of an ldmatrix fall in different banks. At stride 2 the even halo columns are
//     stored before the odd ones, so that neighbouring output pixels read neighbouring
//     halo pixels.
//   * A from registers. Each warp loads its 16 rows of a K step with one ldmatrix.x4 at
//     per-row addresses, which handles the shifts, the stride and the ragged edge with
//     no re-layout; the fragment is wgmma's register A. K steps go in groups of four
//     whose fragments alternate between two register sets, so one group's ldmatrix
//     overlaps the previous group's wgmma.
//   * B from shared memory. The block's weights (9 * cpad x nt) are loaded once, by
//     16-byte cp.async, into 8 x 16-byte core matrices without swizzle (LBO = one core
//     matrix to the next along K, SBO = along N): bf16 N-major, straight from the HWIO
//     rows, read transposed by wgmma; int8 K-major (s8 wgmma takes no other), from the
//     K-major copy of w_q made once when the int8 collection is installed.
//   * Pipelining and persistence. The grid holds as many blocks as fit on the card at
//     once (a multiple of nslices); each walks the tiles of its slice. The halo arrives
//     in a ring of `stages` buffers: with two, the next tile's halo is in flight during
//     this tile's math and epilogue. Where x is copied as it is (bf16 into K3, int8
//     codes into K5) it comes by 16-byte cp.async with zero fill; K5's float inputs are
//     loaded by the threads, four 8-channel chunks in flight each, and quantized once
//     per element into the int8 halo tile.
//   * Epilogue. The accumulators go through shared memory (the halo buffer just used),
//     so that each thread converts (bias, scales) and stores 16 contiguous bytes of y.
// The plan (tile, nt, wgs, stages, halo size, shared-memory bytes, grid) is computed by
// the wrapper (ops/conv_plan.py) and passed in as ints (HaloPlan); plan_ok checks it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "q8_common.cuh"

namespace {

// The launch plan, in ops/conv_plan.py's PLAN_FIELDS order.
struct HaloPlan {
  int B, H, W, Cin, Cout, stride, Ho, Wo;
  int cpad, nt, nslices, wgs, tr, tw, hr, hc, pxb, stages;
  int tiles_y, tiles_x, tiles, smem, grid;
};
constexpr int kPlanFields = 23;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use on sm_90

inline HaloPlan read_plan(const int* v) {
  HaloPlan p;
  int* dst = &p.B;
  for (int i = 0; i < kPlanFields; ++i) dst[i] = v[i];
  return p;
}

// Byte offsets in dynamic shared memory: weights, then the halo ring, then (quantizing)
// the per-channel scales and their reciprocals. The same formula as ops/conv_plan.py's smem_bytes.
struct HaloLayout {
  int w_bytes, halo_bytes, scales_off, total;
};

__host__ __device__ inline int align128(int v) { return (v + 127) / 128 * 128; }

// A halo buffer also stages the tile's accumulators on their way out (4 bytes each).
__host__ __device__ inline HaloLayout halo_layout(const HaloPlan& p, int elem_bytes,
                                                  bool quantize) {
  HaloLayout l;
  l.w_bytes = align128(9 * p.cpad * p.nt * elem_bytes);
  const int halo = p.hr * p.hc * p.pxb, stage = 64 * p.wgs * (p.nt * 4 + 16);
  l.halo_bytes = align128(halo > stage ? halo : stage);
  l.scales_off = l.w_bytes + p.stages * l.halo_bytes;
  l.total = l.scales_off + (quantize ? p.Cin * 8 : 0);  // s_c and 1 / s_c
  return l;
}

// A plan this kernel can run, and that agrees with the layout.
inline bool plan_ok(const HaloPlan& p, int elem_bytes, bool quantize) {
  const HaloLayout l = halo_layout(p, elem_bytes, quantize);
  const int ke = 32 / elem_bytes;  // channels of one wgmma K step
  return p.Ho == (p.H - 1) / p.stride + 1 && p.Wo == (p.W - 1) / p.stride + 1 &&
         p.cpad % ke == 0 && p.cpad >= p.Cin && (p.wgs == 1 || p.wgs == 2) &&
         p.tr * p.tw <= 64 * p.wgs && (p.tw == p.Wo || p.tr == 1) &&
         p.hr == (p.tr - 1) * p.stride + 3 && p.hc == (p.tw - 1) * p.stride + 3 &&
         p.pxb == p.cpad * elem_bytes + 16 && (p.stages == 1 || p.stages == 2) &&
         p.nslices * p.nt >= p.Cout && p.tiles_y * p.tr >= p.Ho && p.tiles_x * p.tw >= p.Wo &&
         p.tiles == p.B * p.tiles_y * p.tiles_x && p.grid % p.nslices == 0 && p.grid > 0 &&
         l.total <= p.smem && p.smem <= kSmemLimit;
}

// ---------------------------------------------------------------------------
// PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* a, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// 8 bf16 at src into 16 bytes of shared memory at dst: one cp.async where the source is
// 16-byte aligned (async), else element by element; n of them valid, zeros after.
__device__ __forceinline__ void copy8(unsigned char* dst, const __nv_bfloat16* src,
                                      const __nv_bfloat16* any, int n, bool async) {
  if (async) {
    cp_async16(smem_u32(dst), n > 0 ? src : any, n > 0);
  } else {
    alignas(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? src[j] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of a wgmma register across the asm around it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand without swizzle: start address,
// LBO (next core matrix along K) and SBO (next core matrix along N), all in 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// One wgmma: D (64 x N, this thread's N/2 accumulators) += A (64 x one K step, this
// warp's 16 rows in four registers) * B (one K step x N, from shared memory). float
// accumulators take bf16 m64nNk16, with B N-major (TB = 1: core matrices of 8 K rows of
// 8 N values, read transposed) or K-major (TB = 0: 8 N rows of 8 K values); int
// accumulators s8 m64nNk32, B K-major.
template <typename Acc, int N, int TB = 1>
struct Wgmma;
template <int TB>
struct Wgmma<float, 8, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};
template <int TB>
struct Wgmma<float, 16, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};
template <int TB>
struct Wgmma<float, 32, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};
template <int TB>
struct Wgmma<float, 64, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TB));
  }
};
template <>
struct Wgmma<int, 8> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<int, 16> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<int, 32> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<int, 64> {
  static __device__ __forceinline__ void run(int* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// The kernel

// Eight channels of x at src (8-element aligned) as f32.
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// A: the element type of the halo tile and the weights (bf16, or int8 codes).
// X: the element type of x; where it is not A, x is quantized to int8 codes with the
//    per-channel static scales of act_max as the halo tile fills (q8_common.cuh).
// w: bf16, the HWIO kernel as (9 * Cin, round8(Cout)) (zero columns past Cout), whose
//    rows are copied as they are into N-major core matrices (wgmma reads bf16 B
//    transposed); int8, the K-major copy
//    (round8(Cout), 9 * cpad) of w_q (ops/conv3x3_q8.py kmajor_weights), whose rows are
//    copied into K-major core matrices (s8 wgmma takes only K-major B).
// NT: output channels per block. Epi: the epilogue: Acc, the accumulator type; Out and
//    y, the output's type and (M, Cout) tensor; begin(b) once per tile (image b), and
//    convert(n, acc), the output value of channel n.
template <typename A, typename X, int NT, typename Epi>
__global__ void __launch_bounds__(256, 2)
conv3x3_halo_wgmma(const X* __restrict__ x, const A* __restrict__ w,
                   const float* __restrict__ act_max, Epi ep, HaloPlan p) {
  using Acc = typename Epi::Acc;
  using Raw = typename std::conditional<sizeof(A) == 2, unsigned short, signed char>::type;
  constexpr int ES = sizeof(A);        // bytes of one element of A
  constexpr int NQ = NT / 8;           // core matrices across N
  constexpr int G = 4;  // K steps per wgmma group
  constexpr bool kQuantize = !std::is_same<A, X>::value;
  constexpr uint32_t kStepBytes = NT * 32;  // B of one K step: 2 x NQ core matrices
  extern __shared__ __align__(128) unsigned char smem[];

  using Out = typename Epi::Out;
  const HaloLayout L = halo_layout(p, ES, kQuantize);
  unsigned char* const halo0 = smem + L.w_bytes;
  float* const scales = reinterpret_cast<float*>(smem + L.scales_off);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n0 = (blockIdx.x % p.nslices) * NT;
  const int half = (p.hc + 1) / 2;  // stride 2: even halo columns first, then odd ones

  // Once per block: the quantizing scales; the weights, by cp.async in the first load
  // group.
  if constexpr (kQuantize)
    for (int c = tid; c < p.Cin; c += nthreads) {
      scales[c] = static_scale(act_max[c]);
      scales[p.Cin + c] = __frcp_rn(scales[c]);
    }
  __syncthreads();
  if constexpr (ES == 2) {
    // core matrix (k / 8, n / 8) holds rows k of 16 bytes: n % 8 in 2-byte steps
    const int cw = (p.Cout + 7) / 8 * 8;  // w's row length
    // (a loop with the same trip count in every thread: with a per-thread one, the
    // compiler serializes the wgmma)
    const int total = 9 * p.cpad * NQ;
    for (int i0 = 0; i0 < total; i0 += nthreads) {
      const int i = i0 + tid, r = i % 8, q = i / 8 % NQ, k = i / (8 * NQ) * 8 + r;
      const int tap = k / p.cpad, ci = k - tap * p.cpad, n = n0 + 8 * q;
      const bool ok = i < total && ci < p.Cin && n < cw;
      if (i < total)
        cp_async16(smem_u32(smem + ((k / 8) * NQ + q) * 128 + r * 16),
                   ok ? w + (int64_t)(tap * p.Cin + ci) * cw + n : w, ok);
    }
  } else {
    // core matrix (k / 16, n / 8) holds rows n of 16 bytes: k % 16
    const int kcs = 9 * p.cpad / 16, rows = (p.Cout + 7) / 8 * 8;
    for (int i = tid; i < kcs * NT; i += nthreads) {
      const int r = i % 8, kc = i / 8 % kcs, q = i / (8 * kcs), n = n0 + 8 * q + r;
      cp_async16(smem_u32(smem + (kc * NQ + q) * 128 + r * 16),
                 n < rows ? w + (int64_t)n * 9 * p.cpad + kc * 16 : w, n < rows);
    }
  }

  const int per_image = p.tiles_y * p.tiles_x;
  const bool async_copy = !kQuantize && (p.Cin * ES) % 16 == 0;

  // The halo of tile t into ring buffer buf: cp.async where x is copied in 16-byte
  // chunks, else loads and stores of 8 channels (or single elements) that quantize.
  // Every pixel's channels up to cpad are written (zeros past Cin and outside the
  // image): the buffer staged the last tile's output.
  auto load_halo = [&](int buf, int t) {
    const int b = t / per_image, r = t - b * per_image, ty = r / p.tiles_x;
    const int iy0 = ty * p.tr * p.stride - 1, ix0 = (r - ty * p.tiles_x) * p.tw * p.stride - 1;
    unsigned char* h = halo0 + buf * L.halo_bytes;
    const X* xb = x + (int64_t)b * p.H * p.W * p.Cin;
    const int vec = async_copy ? 16 / (int)sizeof(X) : (p.Cin % 8 == 0 ? 8 : 1);
    const int per_px = p.cpad / vec, total = p.hr * p.hc * per_px;
    if constexpr (kQuantize) {
      if (vec == 8) {  // four chunks of 8 channels per thread loaded, then quantized
        for (int i0 = tid; i0 < total; i0 += 4 * nthreads) {
          float v[4][8];
          int off[4];
          bool ok[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * nthreads, pix = i / per_px, c = (i - pix * per_px) * 8;
            const int hy = pix / p.hc, hx = pix - hy * p.hc, iy = iy0 + hy, ix = ix0 + hx;
            ok[u] = i < total && c < p.Cin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
            const int slot = p.stride == 1 ? hx : (hx & 1) * half + (hx >> 1);
            off[u] = i < total ? (hy * p.hc + slot) * p.pxb + c : -1;
            if (ok[u]) load8(xb + ((int64_t)iy * p.W + ix) * p.Cin + c, v[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (off[u] < 0) continue;
            const int c = (i0 + u * nthreads) % per_px * 8;
            alignas(8) signed char q[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              q[j] = ok[u] ? quantize_q8_rcp(v[u][j], scales[c + j], scales[p.Cin + c + j]) : 0;
            *reinterpret_cast<uint2*>(h + off[u]) = *reinterpret_cast<const uint2*>(q);
          }
        }
        return;
      }
    }
    for (int i = tid; i < total; i += nthreads) {
      const int pix = i / per_px, c = (i - pix * per_px) * vec, hy = pix / p.hc;
      const int hx = pix - hy * p.hc, iy = iy0 + hy, ix = ix0 + hx;
      const bool ok = c < p.Cin && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const X* src = xb + ((int64_t)iy * p.W + ix) * p.Cin + c;
      const int slot = p.stride == 1 ? hx : (hx & 1) * half + (hx >> 1);
      unsigned char* dst = h + (hy * p.hc + slot) * p.pxb + c * ES;
      if (async_copy) {
        cp_async16(smem_u32(dst), ok ? src : x, ok);
      } else if constexpr (kQuantize) {  // single channels (Cin % 8 != 0)
        *reinterpret_cast<signed char*>(dst) =
            ok ? quantize_q8_rcp(to_f32(*src), scales[c], scales[p.Cin + c]) : 0;
      } else {
        const Raw* s = reinterpret_cast<const Raw*>(src);
        Raw* d = reinterpret_cast<Raw*>(dst);
        if (vec == 8) {
          alignas(16) Raw v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = ok ? s[j] : Raw(0);
          if constexpr (ES == 1)
            *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(v);
          else
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
        } else {
          *d = ok ? *s : Raw(0);
        }
      }
    }
  };

  // This thread's place in the wgmma fragments.
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int a_row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
  const int a_col = (lane >> 4) * 16;                                           // and byte
  const int d_row = wg * 64 + warp * 16 + (lane >> 2);  // accumulator rows d_row, d_row + 8
  const int d_col = (lane & 3) * 2;                     // and columns 8 j + d_col, + 1
  const int steps_per_tap = p.cpad * ES / 32, steps = 9 * steps_per_tap;
  const int groups = (steps + G - 1) / G;
  // A address steps from one tap to the next: along the halo row (stride 2: from the
  // even columns to the odd ones and back), then to the next halo row.
  const int col01 = (p.stride == 1 ? 1 : half) * p.pxb;
  const int col12 = (p.stride == 1 ? 1 : 1 - half) * p.pxb;
  const int next_row = (p.hc - (p.stride == 1 ? 2 : 1)) * p.pxb;
  // B of K step s: the descriptor of step 0 plus s steps of its address field (16 bytes)
  constexpr uint32_t kStepDesc = kStepBytes / 16;
  const uint64_t b_desc0 = smem_desc(smem_u32(smem), NT * 16, 128);
  const int tile_step = gridDim.x / p.nslices;

  int tile = blockIdx.x / p.nslices;
  if (p.stages == 2 && tile < p.tiles) load_halo(0, tile);
  cp_async_commit();  // with the weights
  for (int it = 0; tile < p.tiles; tile += tile_step, ++it) {
    const int buf = p.stages == 2 ? (it & 1) : 0;
    if (p.stages == 2) {  // the next tile's halo flies while this one is multiplied
      if (tile + tile_step < p.tiles) load_halo(buf ^ 1, tile + tile_step);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_halo(0, tile);
      cp_async_commit();
      cp_async_wait<0>();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // weights -> wgmma
    __syncthreads();

    const int b = tile / per_image, r = tile - b * per_image, ty = r / p.tiles_x;
    const int oy0 = ty * p.tr, ox0 = (r - ty * p.tiles_x) * p.tw;
    const int npix = p.tw == p.Wo ? min(p.tr, p.Ho - oy0) * p.Wo : min(p.tw, p.Wo - ox0);
    unsigned char* const hbuf = halo0 + buf * L.halo_bytes;
    // Every warpgroup multiplies, also one whose rows lie past the tile (it reads pixel
    // 0 and stores nothing): a branch around wgmma makes the compiler serialize them.
    const int pr = a_row < npix ? a_row : 0, py = pr / p.tw, px = pr - py * p.tw;
    uint32_t a_addr = smem_u32(hbuf) + (py * p.stride * p.hc + px) * p.pxb + a_col;
    int a_cs = 0, a_kx = 0;
    // The next K step's A address: the next 32 bytes of channels, else the next tap.
    auto advance = [&]() {
      a_addr += 32;
      if (++a_cs == steps_per_tap) {
        a_cs = 0;
        a_addr += (a_kx == 2 ? next_row : a_kx == 0 ? col01 : col12) - steps_per_tap * 32;
        a_kx = a_kx == 2 ? 0 : a_kx + 1;
      }
    };

    Acc acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = Acc(0);
    // Groups of G K steps, their A fragments in two register sets that alternate: a set
    // is reloaded once the wgmma group that read it has completed (wait_group 1 leaves
    // just the newest group in flight), so a group's ldmatrix overlaps the previous
    // group's wgmma.
    uint32_t a0[G][4], a1[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < steps) ldmatrix_x4(a0[j], a_addr), advance();
    for (int g = 0; g < groups; g += 2) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (g * G + j < steps)
          Wgmma<Acc, NT>::run(acc, a0[j], b_desc0 + (uint64_t)(g * G + j) * kStepDesc);
      wgmma_commit();
      if (g + 1 < groups) {
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < G; ++j)
          if ((g + 1) * G + j < steps) ldmatrix_x4(a1[j], a_addr), advance();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < G; ++j)
          if ((g + 1) * G + j < steps)
            Wgmma<Acc, NT>::run(acc, a1[j],
                                b_desc0 + (uint64_t)((g + 1) * G + j) * kStepDesc);
        wgmma_commit();
      }
      if (g + 2 < groups) {
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < G; ++j)
          if ((g + 2) * G + j < steps) ldmatrix_x4(a0[j], a_addr), advance();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) fence_operand(acc[i]);

    // Epilogue. Each warp stages its 16 rows of accumulators in the halo buffer (now
    // read by no one), all of them and unconditionally: an accumulator read in a branch
    // makes the compiler serialize the wgmma. It then converts them (Epi::convert) and
    // stores the output 16 bytes at a time where Cout % 8 == 0, rows of consecutive
    // pixels being consecutive in y, else one value at a time.
    Epi e = ep;
    e.begin(b);
    const int64_t m0 = (int64_t)b * p.Ho * p.Wo + (int64_t)oy0 * p.Wo + ox0;
    constexpr int SR = NT * 4 + 16;  // staged row stride, bytes
    __syncthreads();                 // every warp is done with the halo tile
    unsigned char* const stage = hbuf + (wg * 64 + warp * 16) * SR;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
        *reinterpret_cast<uint2*>(stage + ((lane >> 2) + 8 * i) * SR + (8 * j + d_col) * 4) =
            make_uint2(reinterpret_cast<const uint32_t&>(acc[4 * j + 2 * i]),
                       reinterpret_cast<const uint32_t&>(acc[4 * j + 2 * i + 1]));
    __syncwarp();
    const int row0 = wg * 64 + warp * 16;
    Out* const y = e.y;
    if (p.Cout % 8 == 0) {
      constexpr int EPC = 16 / sizeof(Out);  // output elements per 16-byte chunk
      constexpr int CPR = NT / EPC;          // chunks per row
      for (int q = lane; q < 16 * CPR; q += 32) {
        const int rl = q / CPR, n = n0 + (q - rl * CPR) * EPC;
        if (row0 + rl >= npix || n >= p.Cout) continue;
        const Acc* src = reinterpret_cast<const Acc*>(stage + rl * SR) + (n - n0);
        alignas(16) Out o[EPC];
#pragma unroll
        for (int k = 0; k < EPC; ++k) o[k] = e.convert(n + k, src[k]);
        *reinterpret_cast<uint4*>(y + (m0 + row0 + rl) * p.Cout + n) =
            *reinterpret_cast<const uint4*>(o);
      }
    } else {
      for (int q = lane; q < 16 * NT; q += 32) {
        const int rl = q / NT, n = n0 + q - rl * NT;
        if (row0 + rl < npix && n < p.Cout)
          y[(m0 + row0 + rl) * p.Cout + n] =
              e.convert(n, reinterpret_cast<const Acc*>(stage + rl * SR)[n - n0]);
      }
    }
    __syncthreads();  // the buffer is free for the load after next
  }
  cp_async_wait<0>();
}

// Launch one instantiation on plan p (checked against the kernel's layout first).
template <typename A, typename X, int NT, typename Epi>
int launch_nt(const X* x, const A* w, const float* act_max, const Epi& ep, const HaloPlan& p,
              cudaStream_t st) {
  auto kernel = conv3x3_halo_wgmma<A, X, NT, Epi>;
  static int smem_set = 0;  // the dynamic shared memory this instantiation may use so far
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  kernel<<<p.grid, 128 * p.wgs, p.smem, st>>>(x, w, act_max, ep, p);
  return (int)cudaGetLastError();
}

template <typename A, typename X, typename Epi>
int launch_halo(const X* x, const A* w, const float* act_max, const Epi& ep, const HaloPlan& p,
                cudaStream_t st) {
  if (!plan_ok(p, sizeof(A), !std::is_same<A, X>::value)) return (int)cudaErrorInvalidValue;
  switch (p.nt) {
    case 8: return launch_nt<A, X, 8>(x, w, act_max, ep, p, st);
    case 16: return launch_nt<A, X, 16>(x, w, act_max, ep, p, st);
    case 32: return launch_nt<A, X, 32>(x, w, act_max, ep, p, st);
    case 64: return launch_nt<A, X, 64>(x, w, act_max, ep, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
