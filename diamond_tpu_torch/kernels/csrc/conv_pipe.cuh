// K5's pipeline route (conv3x3_q8.cu): the int8 3x3 SAME convolution of the calls with
// many output pixels, as a warp-specialised, multi-stage pipeline for Hopper (sm_90a).
// The halo kernel (conv_halo.cuh) keeps every other call; ops/conv_plan.py k5_route
// chooses by the call's shape.
//   M = B * Ho * Wo output pixels, N = Cout, K = 9 * Cin in (ky, kx, ci) order,
//   A[m, k] = xq[b, oy*s - 1 + ky, ox*s - 1 + kx, ci] (zero outside the image).
//
// What bounds it: bytes at the rollout's large shapes (x once, y once; about 1.5x the
// int8 operations' time at Cin 64, Cout 64, bf16 out). The kernel keeps the next tiles'
// loads in flight behind the math and the stores, and reads x from L2 once per tile.
//
// Design (one persistent block of kThreads per SM; plan: ops/conv_plan.py pipe_plan):
//   * Tiles. A tile is tb images x tr output rows x tw output columns, cut into nm wgmma
//     M-tiles of 64 pixels: 8 x 8 pixels, or one output row of 64 where that reads
//     fewer halo pixels; at 8x8 a tile holds whole images. Every M-tile row is a real
//     pixel except at a ragged edge. Block i walks tiles i, i + grid, ...; its consumer
//     warpgroups (as many as the int8 ring has stages, up to four) take them in turn.
//   * Producer warpgroup (the last). One thread copies each tile's halo (with the
//     one-pixel border) by TMA into a landing ring of 1-2 stages, pixel-major with the
//     channels padded to cpad: the SAME padding and the padded channels are the copy's
//     out-of-bounds zeros; at stride 2 the odd columns and the even ones land as two
//     planes, so that neighbouring output pixels read neighbouring entries. The
//     warpgroup then turns a landed stage into a stage of the int8 ring (3-4 stages),
//     16 bytes of channels of one pixel an item: int8 codes copied, bf16 or f32 x
//     quantized (q8_common.cuh quantize_q8_rcp, the halo kernel's codes), each chunk of
//     16 channels into its own plane of 16 bytes a pixel. Eight consecutive pixels of a
//     plane are 128 contiguous bytes, one core matrix of wgmma's K-major A without
//     swizzle, so every tap's A is a shared-memory descriptor at a shifted address: no
//     ldmatrix, no per-pixel padding in the ring. Planes are skewed by 128 / chunks bytes
//     modulo 128, so the stores of one pixel's chunks fall in distinct banks.
//   * Consumer warpgroups. Per M-tile, 9 * cpad / 32 s8 wgmma m64nNTk32 with A and B
//     from shared memory, as one group; the block's weights (the K-major copy w_k, core
//     matrices as the halo kernel keeps them) are loaded once. After the tile's last
//     M-tile the stage goes back to the producer ("empty" mbarrier), before the epilogue.
//     The role split and the arrival are uniform within each warp and free of branches:
//     a divergent branch among the wgmma groups makes the compiler serialize them.
//   * Epilogue: Epi::apply2 (RescaleQ8 convert's arithmetic: the halo kernel's roundings,
//     in its order) in registers from each thread's column factors, loaded once, staged
//     in each warp's own rows of shared memory (not the ring), then stored as 16-byte
//     vectors of whole output rows. One warpgroup's epilogue overlaps the others' math
//     and the producer's loads.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_halo.cuh"
#include "q8_common.cuh"

namespace {
namespace pipe {

// The launch plan, in ops/conv_plan.py's PIPE_FIELDS order.
struct PipePlan {
  int B, H, W, Cin, Cout, stride, Ho, Wo, cpad, nt, x_bytes, out_bytes;
  int mr, mc, tb, tr, tw, hr, hcp, planes, nm, mt_x, mt_y, tiles_x, tiles_y, tiles;
  int plane_bytes, stage_bytes, src_plane, src_stage, stages, src_stages, staging_row;
  int off_scales, off_w, off_ring, off_src, off_staging, smem, grid;
};
constexpr int kPipeFields = 40;
static_assert(sizeof(PipePlan) == kPipeFields * sizeof(int), "PipePlan is the plan's ints");

constexpr int kConsumerGroups = 4;  // consumer warpgroups, then one producer warpgroup
constexpr int kConsumerThreads = 128 * kConsumerGroups;
constexpr int kConsumerWarps = 4 * kConsumerGroups;
constexpr int kProducerThreads = 128;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kBarrierBytes = 256;
constexpr int kMaxStages = 4;
constexpr int kMaxSrcStages = 2;
constexpr int kNumSms = 132;
constexpr int kBoxMax = 256;

inline PipePlan read_pipe_plan(const int* v) {
  PipePlan p;
  int* dst = &p.B;
  for (int i = 0; i < kPipeFields; ++i) dst[i] = v[i];
  return p;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Byte offsets of dynamic shared memory (ops/conv_plan.py pipe_layout): the ring's
// mbarriers, the quantizing scales and reciprocals (a float x), the weights, the int8
// ring (channel-planar: a plane of 16 bytes a pixel per 16-byte chunk and column plane,
// the planes skewed by 128 / chunks bytes modulo 128 so that the producer's stores of one
// pixel's chunks fall in distinct banks), the ring of x as TMA lands it (pixel-major, cpad
// channels a pixel), the consumer warps' staged output rows.
struct PipeLayout {
  int plane, stage, src_plane, src_stage, row, scales, w, ring, src, staging, total;
};
inline PipeLayout pipe_layout(const PipePlan& p) {
  PipeLayout l;
  const int npx = p.tb * p.hr * p.hcp, chunks = p.cpad / 16;
  l.plane = align128(npx * 16) + (chunks <= 8 ? 16 * (8 / chunks) : 16);
  l.stage = align128(chunks * p.planes * l.plane);
  l.src_plane = align128(npx * p.cpad * p.x_bytes);
  l.src_stage = p.planes * l.src_plane;
  l.row = p.nt * p.out_bytes + 16;
  l.scales = kBarrierBytes;
  l.w = l.scales + (p.x_bytes > 1 ? align128(8 * p.cpad) : 0);
  l.ring = l.w + align128(9 * p.cpad * p.nt);
  l.src = l.ring + p.stages * l.stage;
  l.staging = l.src + p.src_stages * l.src_stage;
  l.total = l.staging + kConsumerWarps * 16 * l.row;
  return l;
}

// A plan this kernel can run, and that agrees with its layout (conv_plan.py pipe_plan_ok).
inline bool pipe_plan_ok(const PipePlan& p) {
  const PipeLayout l = pipe_layout(p);
  const bool rows = p.mr == 1 && p.mc == 64, blocks = p.mr == 8 && p.mc == 8;
  return p.Ho == (p.H - 1) / p.stride + 1 && p.Wo == (p.W - 1) / p.stride + 1 &&
         p.Cin % 16 == 0 && p.cpad == (p.Cin + 31) / 32 * 32 &&
         (p.nt == 8 || p.nt == 16 || p.nt == 32 || p.nt == 64) && p.Cout <= p.nt &&
         (p.x_bytes == 1 || p.x_bytes == 2 || p.x_bytes == 4) &&
         (p.out_bytes == 2 || p.out_bytes == 4) && (p.stride == 1 || p.stride == 2) &&
         p.planes == p.stride && (p.stride == 1 || p.W % 2 == 0) && (rows || blocks) &&
         p.tr == p.mr * p.mt_y && p.tw == p.mc * p.mt_x && p.nm == p.tb * p.mt_y * p.mt_x &&
         p.nm >= 1 && p.nm <= 4 && p.hr == (p.tr - 1) * p.stride + 3 &&
         p.hcp == p.tw + (p.stride == 1 ? 2 : 1) && p.hr <= kBoxMax && p.hcp <= kBoxMax &&
         p.tb <= kBoxMax && p.tiles_x == cdiv(p.Wo, p.tw) && p.tiles_y == cdiv(p.Ho, p.tr) &&
         p.tiles == cdiv(p.B, p.tb) * p.tiles_y * p.tiles_x && p.stages >= 3 &&
         p.stages <= kMaxStages &&
         p.src_stages >= 1 && p.src_stages <= kMaxSrcStages && p.cpad <= kBoxMax &&
         p.plane_bytes == l.plane && p.stage_bytes == l.stage && p.src_plane == l.src_plane &&
         p.src_stage == l.src_stage && p.staging_row == l.row &&
         p.off_scales == l.scales && p.off_w == l.w && p.off_ring == l.ring &&
         p.off_src == l.src && p.off_staging == l.staging && p.smem == l.total &&
         p.smem <= kSmemLimit && p.grid > 0 && p.grid <= p.tiles && p.grid <= kNumSms;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA tensor copies, named barriers, wgmma with A from shared memory

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// An arrival by the threads whose pred holds, without a branch (a branch between wgmma
// groups makes the compiler serialize them).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred P;\nsetp.ne.b32 P, %1, 0;\n@P mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}
// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The box of tensor map m at the given coordinates (innermost first) into shared memory
// at dst (128-byte aligned), completing on bar; out-of-bounds elements read as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* m, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* m, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x N int32, this thread's N/2) += A (64 x 32 int8) * B (32 x N int8), both
// K-major core matrices in shared memory, given by their descriptors.
template <int N>
struct WgmmaSS;
template <>
struct WgmmaSS<8> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The 16 channels of one int8 chunk of one pixel as x landed (X: bf16 or f32, 16 *
// sizeof(X) contiguous bytes) as floats.
template <typename X>
__device__ __forceinline__ void load16(const unsigned char* at, float* v) {
#pragma unroll
  for (int u = 0; u < (int)sizeof(X); ++u) {
    const uint4 q = *reinterpret_cast<const uint4*>(at + 16 * u);
    if constexpr (std::is_same<X, float>::value) {
      v[4 * u] = __uint_as_float(q.x), v[4 * u + 1] = __uint_as_float(q.y);
      v[4 * u + 2] = __uint_as_float(q.z), v[4 * u + 3] = __uint_as_float(q.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[8 * u + 2 * i] = f.x, v[8 * u + 2 * i + 1] = f.y;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel

// A: the element type of the operands (int8 codes; the name and this argument keep the
// halo kernel's, which the benchmark's readers match). X: x's element type; where it is
// not A, x is quantized with the static scales of act_max. w: the K-major copy
// (round8(Cout), 9 * cpad) of w_q. NT: wgmma N (Cout rounded up). Epi: the epilogue
// (conv3x3_q8.cu RescaleQ8).
template <typename A, typename X, int NT, typename Epi>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_halo_wgmma(const __grid_constant__ CUtensorMap tmap, const A* __restrict__ w,
                   const float* __restrict__ act_max, Epi ep, PipePlan p) {
  static_assert(std::is_same<A, signed char>::value, "the pipeline multiplies int8 codes");
  using Out = typename Epi::Out;
  constexpr bool kQuantize = !std::is_same<X, A>::value;
  constexpr int XB = sizeof(X);
  constexpr int NQ = NT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxStages;
  uint64_t* const src_full = empty + kMaxStages;
  float* const scales = reinterpret_cast<float*>(smem + p.off_scales);  // s, then 1 / s
  unsigned char* const wsm = smem + p.off_w;
  unsigned char* const ring = smem + p.off_ring;
  unsigned char* const src = smem + p.off_src;
  // (the warp index broadcast from lane 0: the compiler then knows the role split is
  // uniform within each warp, and does not serialize the consumers' wgmma)
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int chunks = p.cpad / 16;  // 16-byte chunks of an int8 pixel
  const int per_group = p.tiles_x * p.tiles_y;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per warp of the consuming warpgroup
    }
    for (int s = 0; s < p.src_stages; ++s) mbar_init(&src_full[s], 1);
    fence_async_smem();
  }
  __syncthreads();

  // The first image, output row and column of tile t.
  auto origin = [&](int t, int& img0, int& oy0, int& ox0) {
    const int g = t / per_group, r = t - g * per_group, ty = r / p.tiles_x;
    img0 = g * p.tb;
    oy0 = ty * p.tr;
    ox0 = (r - ty * p.tiles_x) * p.tw;
  };

  if (warp >= kConsumerWarps) {
    // The producer warpgroup. issue: tile t's box of x into float-or-code stage sb (one
    // TMA copy, two at stride 2: the odd columns 2j + 1 from j = ox0 - 1, then the even
    // ones from j = ox0).
    const int ptid = tid - kConsumerThreads;
    auto issue = [&](int sb, int t) {
      int img0, oy0, ox0;
      origin(t, img0, oy0, ox0);
      unsigned char* d = src + sb * p.src_stage;
      mbar_expect_tx(&src_full[sb],
                     (uint32_t)(p.planes * p.tb * p.hr * p.hcp * p.cpad * XB));
      if (p.stride == 1) {
        tma_load_4d(d, &tmap, &src_full[sb], 0, ox0 - 1, oy0 - 1, img0);
      } else {
        tma_load_5d(d, &tmap, &src_full[sb], 0, 1, ox0 - 1, 2 * oy0 - 1, img0);
        tma_load_5d(d + p.src_plane, &tmap, &src_full[sb], 0, 0, ox0, 2 * oy0 - 1, img0);
      }
    };
    if constexpr (kQuantize)
      for (int c = ptid; c < p.cpad; c += kProducerThreads) {
        const float s = c < p.Cin ? static_scale(act_max[c]) : 1.f;
        scales[c] = s;
        scales[p.cpad + c] = __frcp_rn(s);
      }
    if (ptid == 0)
      for (int k = 0; k < p.src_stages; ++k)
        if (blockIdx.x + k * gridDim.x < p.tiles) issue(k, blockIdx.x + k * gridDim.x);
    named_sync(2, kProducerThreads);
    // Each landed stage into an int8 stage: 16 bytes of channels of one pixel an item,
    // copied (codes) or quantized (bf16, f32), into its chunk's plane.
    const int npx = p.tb * p.hr * p.hcp, items = p.planes * npx * chunks;
    const int pitch = p.cpad * XB;  // bytes of a pixel as it landed
    int last_c = -1;
    float sc[16], rc[16];
    for (int it = 0, t = blockIdx.x; t < p.tiles; ++it, t += gridDim.x) {
      const int s = it % p.stages, sb = it % p.src_stages;
      mbar_wait(&src_full[sb], (it / p.src_stages) & 1);
      mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
      const unsigned char* sbuf = src + sb * p.src_stage;
      unsigned char* dbuf = ring + s * p.stage_bytes;
      for (int i = ptid; i < items; i += kProducerThreads) {
        const int px = i / chunks, c = i - px * chunks, pl = px / npx, pp = px - pl * npx;
        const unsigned char* from = sbuf + pl * p.src_plane + pp * pitch + c * 16 * XB;
        uint4 out;
        if constexpr (kQuantize) {
          if (c != last_c) {  // this chunk's scales (a thread keeps one chunk where
            last_c = c;       // the chunks divide its stride)
#pragma unroll
            for (int j = 0; j < 16; ++j) sc[j] = scales[16 * c + j], rc[j] = scales[p.cpad + 16 * c + j];
          }
          float v[16];
          load16<X>(from, v);
          uint32_t q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              word |= (uint32_t)(unsigned char)quantize_q8_rcp(v[4 * k + j], sc[4 * k + j],
                                                               rc[4 * k + j])
                      << (8 * j);
            q[k] = word;
          }
          out = make_uint4(q[0], q[1], q[2], q[3]);
        } else {
          out = *reinterpret_cast<const uint4*>(from);
        }
        *reinterpret_cast<uint4*>(dbuf + (c * p.planes + pl) * p.plane_bytes + pp * 16) = out;
      }
      fence_async_smem();  // the generic stores before the consumers' wgmma reads
      named_sync(2, kProducerThreads);
      if (ptid == 0) {
        mbar_arrive(&full[s]);
        const int tn = t + p.src_stages * gridDim.x;
        if (tn < p.tiles) issue(sb, tn);
      }
    }
    return;
  }

  // The consumers. The block's weights first: core matrix (k / 16, n / 8) holds rows n of
  // 16 bytes, k % 16 (the halo kernel's int8 layout).
  {
    // (the same trip count in every thread: with a per-thread one, the compiler may
    // serialize the wgmma)
    const int kcs = 9 * p.cpad / 16, rows = (p.Cout + 7) / 8 * 8, total = kcs * NT;
    for (int i0 = 0; i0 < total; i0 += kConsumerThreads) {
      const int i = i0 + tid, r = i % 8, kc = i / 8 % kcs, q = i / (8 * kcs), n = 8 * q + r;
      if (i < total)
        cp_async16(smem_u32(wsm + (kc * NQ + q) * 128 + r * 16),
                   n < rows ? w + (int64_t)n * 9 * p.cpad + kc * 16 : w, n < rows);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();  // weights -> wgmma
    named_sync(1, kConsumerThreads);
  }

  const int wg = warp / 4, wl = warp % 4, g = lane >> 2, tq = lane & 3;
  const int ks_per_tap = p.cpad / 32;
  const uint32_t lbo = p.planes * p.plane_bytes;           // chunk to chunk along K
  const uint32_t sbo = p.mr == 1 ? 128 : p.stride * p.hcp * 16;  // 8 pixels to the next 8
  const int row_bytes = p.hcp * 16, img_bytes = p.hr * row_bytes;
  const uint64_t b_desc0 = smem_desc(smem_u32(wsm), NT * 16, 128);
  constexpr uint32_t kStepDesc = NT * 32 / 16;  // one K step of B, in descriptor units
  unsigned char* const stage_y = smem + p.off_staging + warp * 16 * p.staging_row;
  const int ys = p.staging_row / (int)sizeof(Out);  // staged row, in elements
  Out* const y = ep.y;
  // The epilogue's factors of this thread's columns 8 j + 2 tq + u, once (columns past
  // Cout take channel Cout - 1's and are not stored).
  float wsc[NQ][2], bsc[NQ][2];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = min(8 * j + 2 * tq + u, p.Cout - 1);
      wsc[j][u] = ep.column_scale(n);
      bsc[j][u] = ep.column_bias(n);
    }

  // The warpgroups that take tiles: no more than the ring has stages. A parity wait tells
  // a phase only from the one before it, so a wait on a stage's "full" barrier a whole
  // ring cycle early would pass at once. With no more warpgroups than stages, the stage's
  // previous tile lands before the tile the warpgroup took last, and no wait is early.
  const int groups = min(kConsumerGroups, p.stages);
  int it = wg;
  for (int t = blockIdx.x + wg * gridDim.x; wg < groups && t < p.tiles;
       t += groups * gridDim.x, it += groups) {
    const int s = it % p.stages;
    int img0, oy0, ox0;
    origin(t, img0, oy0, ox0);
    mbar_wait(&full[s], (it / p.stages) & 1);
    const uint32_t sbase = smem_u32(ring + s * p.stage_bytes);
    for (int mt = 0; mt < p.nm; ++mt) {
      const int per_img = p.mt_y * p.mt_x, ib = mt / per_img, rm = mt - ib * per_img;
      const int my = rm / p.mt_x, mx = rm - my * p.mt_x;
      const uint32_t mbase = sbase + ib * img_bytes + p.stride * my * p.mr * row_bytes +
                             mx * p.mc * 16;
      int acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
      wgmma_fence();
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - 3 * ky;
        // stride 2: tap kx = 0 reads the odd plane at the pixel's own entry, kx = 1 the
        // even plane, kx = 2 the odd plane one entry on
        const uint32_t col = p.stride == 1 ? kx * 16 : kx == 1 ? p.plane_bytes : kx == 2 ? 16 : 0;
        const uint32_t a0 = mbase + ky * row_bytes + col;
        for (int ks = 0; ks < ks_per_tap; ++ks)
          WgmmaSS<NT>::run(acc, smem_desc(a0 + 2 * ks * lbo, lbo, sbo),
                           b_desc0 + (uint64_t)(tap * ks_per_tap + ks) * kStepDesc);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) fence_operand(acc[i]);
      __syncwarp();  // after the tile's last M-tile the stage goes back to the producer
      mbar_arrive_if(&empty[s], lane == 0 && mt == p.nm - 1);

      // Epilogue: this warp's rows 16 wl + g and + 8, columns 8 j + 2 tq and + 1,
      // converted in pairs (Epi::apply2, convert's arithmetic) and staged, then whole rows
      // of y out.
      const int img = img0 + ib;
      Epi e = ep;
      e.begin(img < p.B ? img : p.B - 1);
      Out* const st = reinterpret_cast<Out*>(stage_y);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          e.apply2(st + (g + 8 * h) * ys + 8 * j + 2 * tq, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1], wsc[j][0], wsc[j][1], bsc[j][0], bsc[j][1]);
      __syncwarp();
      const int orow = oy0 + my * p.mr, ocol = ox0 + mx * p.mc;
      auto pixel = [&](int rl, int64_t& m) {  // output pixel of the warp's row rl
        const int r = 16 * wl + rl;
        const int oy = p.mr == 1 ? orow : orow + (r >> 3);
        const int ox = p.mr == 1 ? ocol + r : ocol + (r & 7);
        m = ((int64_t)img * p.Ho + oy) * p.Wo + ox;
        return img < p.B && oy < p.Ho && ox < p.Wo;
      };
      if (p.Cout == NT && NT * sizeof(Out) % 16 == 0) {
        constexpr int kChunks = NT * sizeof(Out) / 16;  // 16-byte chunks of a row of y
#pragma unroll
        for (int q = lane; q < 16 * kChunks; q += 32) {
          const int rl = q / kChunks, c = q % kChunks;
          int64_t m;
          if (pixel(rl, m))
            *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(y + m * NT) + c * 16) =
                *reinterpret_cast<const uint4*>(stage_y + rl * p.staging_row + c * 16);
        }
      } else {
        for (int q = lane; q < 16 * p.Cout; q += 32) {
          const int rl = q / p.Cout, n = q - rl * p.Cout;
          int64_t m;
          if (pixel(rl, m)) y[m * p.Cout + n] = st[rl * ys + n];
        }
      }
      __syncwarp();  // the staged rows are free for the next M-tile
    }
  }
}

// ---------------------------------------------------------------------------
// The host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (no link to libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// x (B, H, W, Cin) as the tensor map whose box is a tile's halo with its channels padded
// to cpad (the padding, like the image's border, read as zeros): stride 1, dimensions
// (Cin, W, H, B) and box (cpad, hcp, hr, tb); stride 2, the columns as pairs, (Cin, 2,
// W / 2, H, B) and box (cpad, 1, hcp, hr, tb) of one column parity.
inline int make_tmap(CUtensorMap* m, const void* x, const PipePlan& p) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType dt = p.x_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : p.x_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t px = (cuuint64_t)p.Cin * p.x_bytes, row = px * p.W, img = row * p.H;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r;
  if (p.stride == 1) {
    const cuuint64_t dims[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W, (cuuint64_t)p.H,
                                (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {px, row, img};
    const cuuint32_t box[4] = {(cuuint32_t)p.cpad, (cuuint32_t)p.hcp, (cuuint32_t)p.hr,
                               (cuuint32_t)p.tb};
    r = fn(m, dt, 4, const_cast<void*>(x), dims, strides, box, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[5] = {(cuuint64_t)p.Cin, 2, (cuuint64_t)p.W / 2, (cuuint64_t)p.H,
                                (cuuint64_t)p.B};
    const cuuint64_t strides[4] = {px, 2 * px, row, img};
    const cuuint32_t box[5] = {(cuuint32_t)p.cpad, 1, (cuuint32_t)p.hcp, (cuuint32_t)p.hr,
                               (cuuint32_t)p.tb};
    r = fn(m, dt, 5, const_cast<void*>(x), dims, strides, box, ones,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename A, typename X, int NT, typename Epi>
int launch_nt(const CUtensorMap& m, const A* w, const float* act_max, const Epi& ep,
              const PipePlan& p, cudaStream_t st) {
  auto kernel = conv3x3_halo_wgmma<A, X, NT, Epi>;
  static int smem_set = 0;  // the dynamic shared memory this instantiation may use so far
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  kernel<<<p.grid, kThreads, p.smem, st>>>(m, w, act_max, ep, p);
  return (int)cudaGetLastError();
}

template <typename A, typename X, typename Epi>
int launch_pipe(const X* x, const A* w, const float* act_max, const Epi& ep, const PipePlan& p,
                cudaStream_t st) {
  if (!pipe_plan_ok(p) || p.x_bytes != (int)sizeof(X) ||
      p.out_bytes != (int)sizeof(typename Epi::Out))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const int err = make_tmap(&m, x, p);
  if (err != 0) return err;
  switch (p.nt) {
    case 8: return launch_nt<A, X, 8>(m, w, act_max, ep, p, st);
    case 16: return launch_nt<A, X, 16>(m, w, act_max, ep, p, st);
    case 32: return launch_nt<A, X, 32>(m, w, act_max, ep, p, st);
    case 64: return launch_nt<A, X, 64>(m, w, act_max, ep, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace pipe
}  // namespace
