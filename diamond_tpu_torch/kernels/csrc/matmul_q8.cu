// Int8 matrix product with static per-input-channel activation scales, for Hopper
// (sm_90a): K6.
//
// Replaces diamond_tpu/ops/quant.py::matmul_q8_static, which XLA computes on the TPU's
// int8 MXU (the int8 rollout's 1x1 convs, dense layers and LSTM gates):
//   xq = clip(round(x / s_c), +-127) with the calibrated per-input-channel scale
//   s_c = max(act_max_k, 1e-8) * 1.05 / 127,
//   acc = xq @ w_q in int32,   y = f32(acc) * w_scale[n].
//
// Epilogue, in the JAX package's order (quant.py:209, then .astype(dtype) and
// + b.astype(dtype) at blocks.py:104, :109 and :149, :154), as K5's (conv3x3_q8.cu
// RescaleQ8): f32(acc) with round-to-nearest-even, times w_scale[n]; in bf16 that product
// is rounded to bf16, the bias rounded to bf16 is added and the sum rounded again; in f32
// the bias is added to it. Every rounding is pinned by intrinsics, so no multiply-add is
// contracted. x is quantized to the code a true IEEE division by s_c gives
// (quantize_words: x times 1/s_c rounded once, and the division where that lies near a
// rounding tie or past the clip), as K4 and K5 quantize. The int32 sums are exact in any
// order, so every tile shape and split of K below gives the same bits.
//
// What bounds it: bytes. At the sites' shapes (K <= 512, N <= 2048) a call does at most
// ~70 int8 operations per byte of x, w_q and y, far below the card's int8 balance of ~590
// (1,979 TOP/s over 3.35 TB/s): the kernel has to read x once and write y once, and at
// small M a call is a chain of latencies.
//
// Two variants, chosen per call on the host (ops/matmul_plan.py, whose plan the kernel
// checks against its own layout, matmul_plan_ok):
//
// * Bulk (M >= 16,384: the denoiser's up-path projections at 64x64 and 32x32): a
//   persistent grid, three blocks an SM, each walking 64-row tiles of one 64-column tile
//   of y. Warp 4 is the producer: it copies each tile's x rows (one cp.async.bulk a row)
//   into a ring of stages in shared memory, each slot with a "full" mbarrier (completed
//   by the copies' bytes) and an "empty" one (one arrival per consumer warp). Warps 0-3,
//   one warpgroup, are the consumers. Once per block they compute the channel scales and
//   reciprocals and the columns' w_scale and bias into shared memory, and stage the
//   column tile of the K-major weight copy w_k (N, round32(K)) (ops/matmul_q8.py
//   kmajor_2d) as wgmma's B. Then, for each tile, warp w reads its rows 16w..16w+15
//   straight from the ring in the order of wgmma's A fragment, quantizes them in
//   registers, and the warpgroup runs s8 wgmma m64n64k32 on them; the slot goes back to
//   the producer, and each warp stages its rescaled rows in shared memory and stores them
//   as 16-byte vectors of whole rows while the next copies are in flight. A lane (g, t)
//   takes channels 8t..8t+7 of each 32-channel step as one 16-byte read: channels
//   8t..8t+3 fill the fragment's k = 4t..4t+3 and 8t+4..8t+7 its k = 16+4t..16+4t+3, and
//   the weights are staged with the same permutation, which leaves the sum unchanged.
//   Row strides in shared memory are padded so that these reads fall in distinct banks.
// * Small (everything else: the sites at M <= 8,192, batch-1 play, the LSTM's gates, rows
//   the bulk copy cannot move): one tile of y a block, warps of 16 rows by nt 8-column
//   mma.sync tiles. The block's chunk of x and of the weights is copied into shared
//   memory by every thread (16-byte cp.async where x's rows allow it, else element by
//   element), act_max is loaded and the scales computed while those copies are in
//   flight, and the epilogue's w_scale and bias are loaded at the start: one round of
//   global latency. x is quantized once into int8 codes in shared memory (each element by
//   one thread), then the warps run the mma. Where K is long and the tiles few, K is
//   split over a thread-block cluster: each rank sums its span of K, the first rank adds
//   the others' int32 partials through distributed shared memory and runs the epilogue.
//
// It launches on the caller's stream, allocates nothing and never synchronises with the
// host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "q8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The ints of ops/matmul_plan.py MatmulPlan, in its order.
struct MatmulPlan {
  int M, K, N, ldx, x_bytes, out_bytes, variant, vec, bm, bn, nt, warps, threads, kp, kc,
      split, kspan, stages, xstride, qstride, wstride, ystride, row_tiles, col_tiles, grid,
      smem;
};
constexpr int kPlanInts = 26;
static_assert(sizeof(MatmulPlan) == kPlanInts * sizeof(int), "MatmulPlan is the plan's ints");

struct MatmulArgs {
  const void* x;
  const float* act_max;
  const signed char* w_k;
  const float* w_scale;
  const float* bias;  // null: no bias
  void* y;
};

constexpr int kSmall = 0, kBulk = 1;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int kBarrierBytes = 128;  // the bulk variant's mbarriers
constexpr int kMaxStages = 4;
constexpr int kMinStages = 2;
constexpr int kBulkMaxK = 512;
constexpr int kBulkWarps = 4;       // consumer warps of a bulk block: one warpgroup
constexpr int kBulkRows = 64;       // rows of a bulk tile
constexpr int kSmallMaxWarps = 8;
constexpr int kSmallMaxNt = 4;
constexpr int kMaxChunk = 256;
constexpr int kMaxCluster = 8;

__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

struct BulkLayout {
  int scales, factors, w, ring, stage, ystage, total;
};
__host__ __device__ inline BulkLayout bulk_layout(const MatmulPlan& p) {
  BulkLayout l;
  l.scales = kBarrierBytes;
  l.factors = l.scales + align128(8 * p.kp);
  l.w = l.factors + align128(8 * p.bn);
  l.ring = l.w + p.bn * p.wstride;
  l.stage = align128(p.bm * p.xstride);
  l.ystage = l.ring + p.stages * l.stage;
  l.total = l.ystage + align128(p.warps * 16 * p.ystride);
  return l;
}

struct SmallLayout {
  int w, x, q, part, total;
};
__host__ __device__ inline SmallLayout small_layout(const MatmulPlan& p) {
  SmallLayout l;
  l.w = align128(8 * p.kc);
  l.x = l.w + align128(p.bn * p.wstride);
  l.q = l.x + align128(p.bm * p.xstride);
  l.part = l.q + align128(p.bm * p.qstride);
  l.total = l.part + (p.split > 1 ? align128(p.bm * p.bn * 4) : 0);
  return l;
}

// A plan this kernel can run, and that agrees with its layout (matmul_plan.py plan_ok).
inline bool matmul_plan_ok(const MatmulPlan& p) {
  const int kp = (p.K + 31) & ~31;
  if (p.M < 1 || p.K < 1 || p.N < 1 || p.kp != kp || (p.ldx < p.K && p.M > 1) ||
      (p.x_bytes != 2 && p.x_bytes != 4) || (p.out_bytes != 2 && p.out_bytes != 4) ||
      p.bn % 8 || p.bn < 8 || p.bn > 64 || p.bm % 16 || p.bm < 16 ||
      (int64_t)p.row_tiles * p.bm < p.M || (int64_t)(p.row_tiles - 1) * p.bm >= p.M ||
      (int64_t)p.col_tiles * p.bn < p.N || (int64_t)(p.col_tiles - 1) * p.bn >= p.N ||
      p.smem <= 0 || p.smem > kSmemLimit)
    return false;
  const int64_t tiles = (int64_t)p.row_tiles * p.col_tiles;
  if (p.variant == kBulk) {
    const int xb = p.kp * p.x_bytes;
    const int xs = p.x_bytes == 2 ? (xb % 128 == 0 ? xb + 64 : xb) : xb + 16;
    const int ws = (p.kp + 127) & ~127;
    return p.vec == 1 && ((int64_t)p.ldx * p.x_bytes) % 16 == 0 && (p.K * p.x_bytes) % 16 == 0 &&
           p.kp <= kBulkMaxK && p.bm == kBulkRows && p.bn == 64 && p.warps == kBulkWarps &&
           p.threads == 32 * (kBulkWarps + 1) && p.nt == 8 &&
           p.kc == p.kp && p.split == 1 && p.stages >= kMinStages && p.stages <= kMaxStages &&
           p.xstride == xs && p.wstride == ws && p.ystride == (p.bn + 8) * p.out_bytes &&
           (p.N * p.out_bytes) % 16 == 0 && p.grid % p.col_tiles == 0 &&
           p.grid >= p.col_tiles && p.grid <= tiles && p.smem == bulk_layout(p).total;
  }
  const int tiles8 = p.bn / 8;
  const bool vec_ok = ((int64_t)p.ldx * p.x_bytes) % 16 == 0 && (p.K * p.x_bytes) % 16 == 0;
  return p.variant == kSmall && (p.vec == 0 || (p.vec == 1 && vec_ok)) &&
         (p.bm == 16 || p.bm == 32 || p.bm == 64) &&
         (p.nt == 1 || p.nt == 2 || p.nt == 4) && tiles8 % p.nt == 0 &&
         p.warps == (p.bm / 16) * (tiles8 / p.nt) && p.warps <= kSmallMaxWarps &&
         p.threads == 32 * p.warps && p.split >= 1 && p.split <= kMaxCluster &&
         p.kspan % 32 == 0 && (int64_t)p.split * p.kspan >= p.kp &&
         (p.split - 1) * p.kspan < p.kp && p.kc % 32 == 0 && p.kc > 0 && p.kc <= p.kspan &&
         p.kc <= kMaxChunk && p.xstride == p.kc * p.x_bytes + 16 && p.qstride == p.kc + 16 &&
         p.wstride == p.kc + 16 && (int64_t)p.grid == tiles * p.split &&
         p.smem == small_layout(p).total;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk and 16-byte asynchronous copies, cluster memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to this block's
// shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from src (16-byte aligned) to dst, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The consumer warps' own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Every thread of the cluster: this block's shared stores before, the others' after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// Quantize, mma, epilogue

// The codes of v[0..V) (V = 4 or 8) from the reciprocals r of their scales s, as V / 4
// words of four int8 codes. The fast path rounds the exact product v * r once to an
// integer, half to even (an fma with 1.5 * 2^23, whose result holds the integer in its low
// byte). The true quotient v / s rounded lies within 1.5e-5 of v * r where |v / s| <=
// 127.5, so where every element's v * r lies farther than 0.5 - kNearTie from a
// half-integer (q8_common.cuh) and within +-127 of 0, these are the codes the true
// division gives, clip included. Otherwise the whole vector takes the true division and
// the clip (quantize_q8).
template <int V>
__device__ __forceinline__ void quantize_words(const float* v, const float* s, const float* r,
                                               uint32_t* w) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  uint32_t b[V];
  float dmax = 0.f, amax = 0.f;  // the largest distance from an integer, and |integer|
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float m = __fmaf_rn(v[j], r[j], kRound);
    const float q = __fsub_rn(kRound, m);  // -round(v * r)
    dmax = fmaxf(dmax, fabsf(__fmaf_rn(v[j], r[j], q)));
    amax = fmaxf(amax, fabsf(q));
    b[j] = __float_as_uint(m);
  }
  if (dmax > kNearTie || amax > 127.f) {
#pragma unroll
    for (int j = 0; j < V; ++j) b[j] = static_cast<unsigned char>(quantize_q8(v[j], s[j]));
  }
#pragma unroll
  for (int k = 0; k < V / 4; ++k)  // the low bytes of four codes into one word
    w[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], 0x0040),
                       __byte_perm(b[4 * k + 2], b[4 * k + 3], 0x0040), 0x5410);
}

// V consecutive elements of x at p (16-byte aligned where V * sizeof(X) >= 16, else
// V * sizeof(X)-byte aligned), as floats.
template <typename X, int V>
__device__ __forceinline__ void load_vec(const void* p, float* v) {
  if constexpr (std::is_same<X, float>::value) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 u = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
    }
  } else if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
  }
}

template <int V>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 u = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bias as the epilogue adds it: in f32, or rounded to bf16 (held as a float), once
// per column.
template <typename Out>
__device__ __forceinline__ float bias_in(float b) {
  if constexpr (std::is_same<Out, float>::value) return b;
  return __bfloat162float(__float2bfloat16_rn(b));
}

// y's element in Out: f32(acc) * w_scale, then the bias b (bias_in) in Out where there is
// one.
template <typename Out>
__device__ __forceinline__ Out rescale(int acc, float ws, bool has_bias, float b) {
  const float o = __fmul_rn(__int2float_rn(acc), ws);
  if constexpr (std::is_same<Out, float>::value) {
    return has_bias ? __fadd_rn(o, b) : o;
  } else {
    const bf16 h = __float2bfloat16_rn(o);
    if (!has_bias) return h;
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(h), b));
  }
}

// Two neighbours of y's row, rescale's steps on each, stored as one pair (bf16: both
// rounded by one conversion instruction).
__device__ __forceinline__ void store_rescaled(float* p, int a0, int a1, float2 ws,
                                               bool has_bias, float2 b) {
  float2 o = make_float2(__fmul_rn(__int2float_rn(a0), ws.x), __fmul_rn(__int2float_rn(a1), ws.y));
  if (has_bias) o = make_float2(__fadd_rn(o.x, b.x), __fadd_rn(o.y, b.y));
  *reinterpret_cast<float2*>(p) = o;
}
__device__ __forceinline__ void store_rescaled(bf16* p, int a0, int a1, float2 ws,
                                               bool has_bias, float2 b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(__int2float_rn(a0), ws.x),
                                           __fmul_rn(__int2float_rn(a1), ws.y));
  if (has_bias) {
    const float2 f = __bfloat1622float2(h);
    h = __floats2bfloat162_rn(__fadd_rn(f.x, b.x), __fadd_rn(f.y, b.y));
  }
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, bf16 a, bf16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// The epilogue's factors of a warp's columns n0 + 8j + 2t + {0, 1}, j < nt.
template <int kNt, typename Out>
__device__ __forceinline__ void load_factors(const MatmulArgs& a, int n0, int nt, int N, int t,
                                             float (*wsc)[2], float (*bs)[2]) {
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + j * 8 + 2 * t + e;
      const bool in = j < nt && n < N;
      wsc[j][e] = in ? a.w_scale[n] : 0.f;
      bs[j][e] = in && a.bias != nullptr ? bias_in<Out>(a.bias[n]) : 0.f;
    }
}

// ---------------------------------------------------------------------------
// The bulk variant

// The weights' column tile (64 columns of w_k, zeros past N and past K up to kw
// channels, a whole number of wgmma groups) as wgmma's K-major B without swizzle: core
// matrix (kc, q), 8 columns 8q.. of 16 bytes of K, at (kc * 8 + q) * 128. The 32 channels
// of a K step go in the lane order of the A fragments (matmul_q8_bulk): chunk 2s takes
// channels 8t..8t+3 of step s for t = 0..3, chunk 2s + 1 channels 8t+4..8t+7.
__device__ __forceinline__ void stage_weights(unsigned char* wsm, const signed char* w_k,
                                              int kp, int kw, int n0, int cols, int tid,
                                              int threads) {
  const int steps = kw / 32;
  for (int i = tid; i < 64 * steps; i += threads) {
    const int n = i / steps, s = i - n * steps;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (n < cols && s * 32 < kp) {
      const uint4* src = reinterpret_cast<const uint4*>(w_k + (int64_t)(n0 + n) * kp + s * 32);
      lo = src[0];
      hi = src[1];
    }
    unsigned char* row = wsm + (n >> 3) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(row + (2 * s) * 1024) = make_uint4(lo.x, lo.z, hi.x, hi.z);
    *reinterpret_cast<uint4*>(row + (2 * s + 1) * 1024) = make_uint4(lo.y, lo.w, hi.y, hi.w);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of a wgmma register across the asm around it.
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory descriptor of a K-major operand without swizzle: start address, LBO (next
// core matrix along K) and SBO (next core matrix along N), in 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x 64 int32, this thread's 32) += A (64 x 32 int8, this warp's 16 rows in four
// registers) * B (32 x 64 int8, K-major core matrices in shared memory).
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Warps 0-3 (one warpgroup) consume 64-row tiles; warp 4 produces them.
template <typename X, typename Out>
__global__ void __launch_bounds__(32 * (kBulkWarps + 1), 3)
matmul_q8_bulk(const MatmulPlan p, const MatmulArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BulkLayout l = bulk_layout(p);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* sc = reinterpret_cast<float*>(smem + l.scales);
  float* rc = sc + p.kp;
  float* fw = reinterpret_cast<float*>(smem + l.factors);  // w_scale and bias of the tile
  float* fb = fw + p.bn;
  unsigned char* ring = smem + l.ring;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ct = blockIdx.x % p.col_tiles;
  const int first = blockIdx.x / p.col_tiles, step = gridDim.x / p.col_tiles;
  const int n0 = ct * p.bn, cols = min(p.bn, p.N - n0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBulkWarps);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kBulkWarps) {  // the producer: one bulk copy a row of x's tiles
    const uint32_t row_bytes = (uint32_t)(p.K * sizeof(X));
    const X* x = static_cast<const X*>(a.x);
    int it = 0;
    for (int rt = first; rt < p.row_tiles; rt += step, ++it) {
      const int s = it % p.stages;
      mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
      const int64_t row0 = (int64_t)rt * kBulkRows;
      const int rows = (int)min((int64_t)kBulkRows, (int64_t)p.M - row0);
      unsigned char* dst = ring + s * l.stage;
      if (lane == 0) mbar_expect_tx(&full[s], rows * row_bytes);
      __syncwarp();
      for (int r = lane; r < rows; r += 32)
        bulk_load(dst + r * p.xstride, x + (row0 + r) * p.ldx, row_bytes, &full[s]);
    }
    return;
  }

  // the consumers: warp cw owns rows 16 cw .. 16 cw + 15 of every tile
  const int cw = warp, ctid = threadIdx.x, g = lane >> 2, t = lane & 3;
  constexpr int kThreads = 32 * kBulkWarps;
  for (int k = ctid; k < p.kp; k += kThreads) {
    const float s = k < p.K ? static_scale(a.act_max[k]) : 1.f;
    sc[k] = s;
    rc[k] = __frcp_rn(s);
  }
  for (int c = ctid; c < p.bn; c += kThreads) {
    fw[c] = c < cols ? a.w_scale[n0 + c] : 0.f;
    fb[c] = c < cols && a.bias != nullptr ? bias_in<Out>(a.bias[n0 + c]) : 0.f;
  }
  stage_weights(smem + l.w, a.w_k, p.kp, p.wstride, n0, cols, ctid, kThreads);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // weights -> wgmma
  consumers_sync(kThreads);

  const bool has_bias = a.bias != nullptr;
  const uint64_t desc0 = smem_desc(smem_u32(smem + l.w), 1024, 128);
  Out* stage_y = reinterpret_cast<Out*>(smem + l.ystage + cw * 16 * p.ystride);
  const int ys = p.ystride / (int)sizeof(Out);  // elements
  const int vpr = cols * (int)sizeof(Out) / 16;  // 16-byte vectors of a row of the tile
  const int ksteps = p.kp / 32, groups = p.wstride / 128;
  int it = 0;
  for (int rt = first; rt < p.row_tiles; rt += step, ++it) {
    const int s = it % p.stages;
    const int64_t row0 = (int64_t)rt * kBulkRows + cw * 16;
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    mbar_wait(&full[s], (it / p.stages) & 1);
    // Every warp multiplies, also one whose rows lie past M (it stores nothing): wgmma
    // takes the whole warpgroup. Groups of four K steps: the steps' A fragments are
    // quantized into registers, then their four wgmma run as one group.
    const unsigned char* xr = ring + s * l.stage + (cw * 16 + g) * p.xstride;
    for (int gi = 0; gi < groups; ++gi) {
      uint32_t af[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ks = gi * 4 + u;
        if (ks < ksteps) {
          const int k = ks * 32 + 8 * t;  // the lane's channels k .. k + 7
          float r8[8], v0[8], v1[8];
          uint32_t w0[2], w1[2];
          load_floats<8>(rc + k, r8);
          load_vec<X, 8>(xr + k * sizeof(X), v0);
          load_vec<X, 8>(xr + 8 * p.xstride + k * sizeof(X), v1);
          quantize_words<8>(v0, sc + k, r8, w0);
          quantize_words<8>(v1, sc + k, r8, w1);
          af[u][0] = w0[0], af[u][1] = w1[0], af[u][2] = w0[1], af[u][3] = w1[1];
        } else {
          af[u][0] = af[u][1] = af[u][2] = af[u][3] = 0;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wgmma_s8(acc, af[u], desc0 + (uint64_t)((gi * 4 + u) * 2048 / 16));
      wgmma_commit();
      wgmma_wait_all();
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the slot goes back to the producer
    if (row0 >= p.M) continue;

    // the tile's rows g and g + 8, columns 8j + 2t and + 1, staged, then whole rows out
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 wf = *reinterpret_cast<const float2*>(fw + j * 8 + 2 * t);
      const float2 bf = *reinterpret_cast<const float2*>(fb + j * 8 + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_rescaled(stage_y + (g + 8 * h) * ys + j * 8 + 2 * t, acc[4 * j + 2 * h],
                       acc[4 * j + 2 * h + 1], wf, has_bias, bf);
    }
    __syncwarp();
    const int rows = (int)min((int64_t)16, (int64_t)p.M - row0);
    unsigned char* yb = static_cast<unsigned char*>(a.y) + (row0 * p.N + n0) * sizeof(Out);
    const unsigned char* sb = reinterpret_cast<const unsigned char*>(stage_y);
    for (int v = lane; v < rows * vpr; v += 32) {
      const int r = v / vpr, c = v - r * vpr;
      *reinterpret_cast<uint4*>(yb + (int64_t)r * p.N * sizeof(Out) + c * 16) =
          *reinterpret_cast<const uint4*>(sb + r * p.ystride + c * 16);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// The small variant

// kVec: x's base, row stride and row length are whole 16-byte vectors.
template <typename X, typename Out, bool kVec>
__global__ void __launch_bounds__(32 * kSmallMaxWarps)
matmul_q8_small(const MatmulPlan p, const MatmulArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmallLayout l = small_layout(p);
  float* sc = reinterpret_cast<float*>(smem);
  float* rc = sc + p.kc;
  signed char* ws = reinterpret_cast<signed char*>(smem + l.w);
  unsigned char* xs = smem + l.x;
  signed char* xq = reinterpret_cast<signed char*>(smem + l.q);
  int* part = reinterpret_cast<int*>(smem + l.part);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % p.split, tile = blockIdx.x / p.split;
  const int ct = tile % p.col_tiles, rt = tile / p.col_tiles;
  const int64_t m0 = (int64_t)rt * p.bm;
  const int n0 = ct * p.bn;
  const int rows = (int)min((int64_t)p.bm, (int64_t)p.M - m0), cols = min(p.bn, p.N - n0);
  const int wn = p.bn / 8 / p.nt;  // warps across the tile's columns
  const int wr = (warp / wn) * 16, wc = (warp % wn) * p.nt * 8;
  const bool mine = wr < rows && wc < cols;  // the warp has outputs to compute
  const int kbeg = rank * p.kspan, kend = min(p.kp, kbeg + p.kspan);
  const X* x = static_cast<const X*>(a.x);

  float wsc[kSmallMaxNt][2], bs[kSmallMaxNt][2];  // loaded first, used last
  load_factors<kSmallMaxNt, Out>(a, n0 + wc, p.nt, p.N, t, wsc, bs);

  int acc[kSmallMaxNt][4];
#pragma unroll
  for (int j = 0; j < kSmallMaxNt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += p.kc) {
    const int kw = min(p.kc, kend - k0);  // a multiple of 32
    // the weights' rows n0 .. n0 + bn - 1 (zeros past N) and x's rows of the chunk
    const int wv = kw / 16;
    for (int i = tid; i < p.bn * wv; i += p.threads) {
      const int r = i / wv, c = (i - r * wv) * 16;
      const bool in = r < cols;
      cp_async16(ws + r * p.wstride + c, a.w_k + (in ? (int64_t)(n0 + r) * p.kp + k0 + c : 0),
                 in);
    }
    if constexpr (kVec) {
      constexpr int E = 16 / sizeof(X);
      const int xv = kw / E;
      for (int i = tid; i < rows * xv; i += p.threads) {
        const int r = i / xv, c = (i - r * xv) * E;
        const bool in = k0 + c < p.K;  // K is a whole number of vectors
        cp_async16(xs + r * p.xstride + c * sizeof(X), x + (in ? (m0 + r) * p.ldx + k0 + c : 0),
                   in);
      }
    }
    cp_async_commit();
    if constexpr (!kVec) {
      for (int i = tid; i < rows * kw; i += p.threads) {
        const int r = i / kw, c = i - r * kw;
        X* d = reinterpret_cast<X*>(xs + r * p.xstride) + c;
        *d = k0 + c < p.K ? x[(m0 + r) * p.ldx + k0 + c] : X(0.f);
      }
    }
    for (int i = tid; i < kw; i += p.threads) {  // while the copies are in flight
      const float s = k0 + i < p.K ? static_scale(a.act_max[k0 + i]) : 1.f;
      sc[i] = s;
      rc[i] = __frcp_rn(s);
    }
    cp_async_wait_all();
    __syncthreads();

    // x's codes, four channels a thread at a time, each element once
    const int qv = kw / 4;
    for (int i = tid; i < rows * qv; i += p.threads) {
      const int r = i / qv, c = (i - r * qv) * 4;
      float v[4], r4[4];
      uint32_t w;
      load_vec<X, 4>(xs + r * p.xstride + c * sizeof(X), v);
      load_floats<4>(rc + c, r4);
      quantize_words<4>(v, sc + c, r4, &w);
      *reinterpret_cast<uint32_t*>(xq + r * p.qstride + c) = w;
    }
    __syncthreads();

    if (mine) {
#pragma unroll 4
      for (int s = 0; s < kw / 32; ++s) {
        const signed char* ar = xq + (wr + g) * p.qstride + s * 32 + t * 4;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ar);
        af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * p.qstride);
        af[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * p.qstride + 16);
#pragma unroll
        for (int j = 0; j < kSmallMaxNt; ++j) {
          if (j < p.nt) {
            const signed char* br = ws + (wc + j * 8 + g) * p.wstride + s * 32 + t * 4;
            mma_s8(acc[j], af, *reinterpret_cast<const uint32_t*>(br),
                   *reinterpret_cast<const uint32_t*>(br + 16));
          }
        }
      }
    }
    __syncthreads();  // the chunk's buffers are free for the next
  }

  if (p.split > 1) {  // the cluster's first block adds the other ranks' int32 partials
    const int base = warp * p.nt * 128 + lane;
    if (mine) {
#pragma unroll
      for (int j = 0; j < kSmallMaxNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j < p.nt) part[base + (j * 4 + e) * 32] = acc[j][e];
    }
    cluster_sync();
    if (rank == 0 && mine) {
      for (int q = 1; q < p.split; ++q) {
        const uint32_t remote = cluster_addr(part + base, q);
#pragma unroll
        for (int j = 0; j < kSmallMaxNt; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j < p.nt) acc[j][e] += ld_cluster(remote + 4 * (j * 4 + e) * 32);
      }
    }
    cluster_sync();  // the partials stay until the first block has read them
    if (rank != 0) return;
  }
  if (!mine) return;

  // accumulator tile j: rows g and g + 8 of the warp's 16, columns 2t and 2t + 1, stored
  // as one pair where both columns exist and y's rows keep the pair aligned (N even)
  const bool has_bias = a.bias != nullptr;
  Out* y = static_cast<Out*>(a.y);
#pragma unroll
  for (int j = 0; j < kSmallMaxNt; ++j) {
    const int n = n0 + wc + j * 8 + 2 * t;
    if (j >= p.nt || n >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + wr + g + h * 8;
      if (row >= p.M) continue;
      const Out o0 = rescale<Out>(acc[j][2 * h], wsc[j][0], has_bias, bs[j][0]);
      Out* dst = y + row * p.N + n;
      if (n + 1 < p.N) {
        const Out o1 = rescale<Out>(acc[j][2 * h + 1], wsc[j][1], has_bias, bs[j][1]);
        if (p.N % 2 == 0) {
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

// ---------------------------------------------------------------------------
// Launch

template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  done = e == cudaSuccess;
  return e;
}

template <typename X, typename Out>
int launch(const MatmulPlan& p, const MatmulArgs& a, cudaStream_t st) {
  if (p.variant == kBulk) {
    static bool done = false;
    auto kernel = &matmul_q8_bulk<X, Out>;
    cudaError_t e = allow_smem(kernel, done);
    if (e != cudaSuccess) return (int)e;
    kernel<<<p.grid, p.threads, p.smem, st>>>(p, a);
    return (int)cudaGetLastError();
  }
  static bool done_vec = false, done_any = false;
  auto kernel = p.vec ? &matmul_q8_small<X, Out, true> : &matmul_q8_small<X, Out, false>;
  cudaError_t e = allow_smem(kernel, p.vec ? done_vec : done_any);
  if (e != cudaSuccess) return (int)e;
  if (p.split == 1) {
    kernel<<<p.grid, p.threads, p.smem, st>>>(p, a);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x: M rows of K channels (f32 or bf16, plan.x_bytes), row r at x + r * plan.ldx
// elements; act_max: (K,) f32; w_k: the K-major copy (N, round32(K)) of w_q, int8, 16-byte
// aligned (ops/matmul_q8.py kmajor_2d); w_scale: (N,) f32; bias: (N,) f32 or null; y: (M,
// N) contiguous (f32 or bf16, plan.out_bytes); plan: the ints of ops/matmul_plan.py
// MatmulPlan.
extern "C" int matmul_q8_fwd(const void* x, const void* act_max, const void* w_k,
                             const void* w_scale, const void* bias, void* y, const int* plan,
                             void* stream) {
  MatmulPlan p;
  int* dst = &p.M;
  for (int i = 0; i < kPlanInts; ++i) dst[i] = plan[i];
  const bool vec_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!matmul_plan_ok(p) || (p.vec && !vec_ok) || reinterpret_cast<uintptr_t>(w_k) % 16 ||
      (p.variant == kBulk && reinterpret_cast<uintptr_t>(y) % 16))
    return (int)cudaErrorInvalidValue;
  const MatmulArgs a{x,
                     static_cast<const float*>(act_max),
                     static_cast<const signed char*>(w_k),
                     static_cast<const float*>(w_scale),
                     static_cast<const float*>(bias),
                     y};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.x_bytes == 4 && p.out_bytes == 4) return launch<float, float>(p, a, st);
  if (p.x_bytes == 4 && p.out_bytes == 2) return launch<float, bf16>(p, a, st);
  if (p.x_bytes == 2 && p.out_bytes == 4) return launch<bf16, float>(p, a, st);
  return launch<bf16, bf16>(p, a, st);
}
