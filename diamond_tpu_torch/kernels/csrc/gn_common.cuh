// The fused GroupNorm kernel of the port, for Hopper (sm_90a): one template,
// gn_cluster_kernel, that K1/K2 (fused_norms.cu) and K4's static epilogue (fused_q8.cu)
// instantiate, and the 16-byte vector helpers fused_q8.cu's per-sample epilogue also uses.
//
// y = [SiLU]((x - mean_g) * inv_g * mul_c + add_c) over NHWC x, groups of C/G adjacent
// channels, mean_g = E[x], inv_g = rsqrt(E[x^2] - E[x]^2 + eps) per sample in f32 (the
// JAX package's single-pass moments), and mul/add the FiLM rows (1 + scale_b, shift_b) or
// GroupNorm's affine (scale, bias). The output is x's dtype (K1/K2) or the int8 codes
// clip(round(y / s_c), +-127) of y rounded to x's dtype (K4, with the consuming conv's
// static scales), so K4's codes equal quantize(K1/K2 output) exactly.
//
// What bounds it: bytes, and close behind them the element work. x is read and y
// written once; between them each element takes ~10 f32 operations and two
// special-function ones (the SiLU's exponential and reciprocal, at 1/8 of the f32 rate),
// K4 ~10 more for the quantize, so the apply pass of a block runs near the SM's compute
// rate. Most calls of the rollout are small (8x8 to 32x32), where one launch's latency
// is the cost.
//
// Design (the launch plan is ops/norm_plan.py's, passed in as ints and checked by
// norm_plan_ok):
//   * One launch per call: B thread-block clusters of n blocks (n <= 8, or 16 with the
//     non-portable cluster attribute where the card can place such a cluster, which the
//     wrapper asks once per plan through max_clusters_gn), one cluster per sample,
//     launched with cudaLaunchKernelEx. Block r owns ppb whole pixels of the sample. No
//     scratch tensor, no second kernel, nothing allocated or synchronised on the host.
//   * x on chip, read once: thread 0 copies the block's pixels into shared memory with
//     1-D bulk copies (cp.async.bulk, completing on an mbarrier), in up to kMaxChunks
//     chunks of whole steps, each on its own barrier, so the statistics of one chunk run
//     while the next lands. A sample beyond n blocks' shared memory keeps rpx pixels per
//     block on chip and reads the rest from device memory in both passes.
//   * Statistics: thread t reads the vectors t, t + T, ... (T threads, a multiple of
//     C / V, so it keeps the same V channels) and sums x and x^2 in f32; full warp w
//     reduces groups w, w + T/32, ... over the T/G threads whose channels lie in them.
//   * Moments through distributed shared memory, pushed: each block stores its G
//     partials (sum, sum of squares) into slot [rank] of every block of the cluster with
//     remote stores (st.async) that complete on the receiving block's barrier, then
//     sums slots 0..n-1 in that order once its barrier has seen all n; every block and
//     every run gets the same mean and 1/std (no atomics, no order that changes). One
//     cluster barrier, arrived at when a block's barriers are initialised and waited on
//     only after its statistics, keeps a store from reaching a barrier before it exists;
//     a block leaves only after receiving every store meant for it, so no block's shared
//     memory is written after it has gone.
//   * Where a backward follows (K1/K2 under autograd), rank 0 of each cluster also writes
//     the sample's mean and 1/std per group (GnArgs::moments), which the backward
//     (gn_bwd.cu) reads instead of recomputing them; the rollout passes null.
//   * Apply from shared memory: normalize, affine, SiLU, then 16-byte stores (bf16/f32)
//     or 4/8-byte int8 stores, two vectors in flight per thread. The FiLM/affine rows are
//     read as f32 or bf16 as they come, loaded while the copies fly; K4's 1/s_c is
//     computed once per channel and block into shared memory.
//   * Element arithmetic pinned by intrinsics (gn_element), the same in every
//     instantiation; the SiLU is o / (1 + e^-o) with the hardware exponential and a
//     fast division, and K4 quantizes by a multiply with 1/s_c that falls back to the
//     true division near a rounding tie (q8_common.cuh q8_rcp_bits, exact).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "q8_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 64;
constexpr int kMaxCluster = 16;  // 8 portable, 16 with the non-portable attribute
constexpr int kMaxChunks = 8;
constexpr int kSmemDynamic = 232448 - 4096;  // a block's 227 KB less the static part
constexpr float kGnEps = 1e-5f;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// v[0..V) rounded to T and back, in pairs: the values a T-typed output holds.
template <int V>
__device__ __forceinline__ void round_to(float* v, float) {}
template <int V>
__device__ __forceinline__ void round_to(float* v, __nv_bfloat16) {
#pragma unroll
  for (int j = 0; j < V; j += 2) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v[j], v[j + 1]));
    v[j] = f.x;
    v[j + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// [SiLU]((v - mean) * inv * mul + add), every rounding pinned by intrinsics, so each
// instantiation computes the same bits: the SiLU divides by 1 + e^-o with the hardware
// exponential (__expf) and a fast division (__fdividef), which give 0 where e^-o
// overflows, the limit of the SiLU there.
__device__ __forceinline__ float gn_element(float v, float mean, float inv, float mul, float add,
                                           int silu) {
  const float o = __fmaf_rn(__fmul_rn(__fsub_rn(v, mean), inv), mul, add);
  return silu ? __fdividef(o, __fadd_rn(1.f, __expf(-o))) : o;
}

// ---------------------------------------------------------------------------
// The launch plan, in ops/norm_plan.py's PLAN_FIELDS order.

struct NormPlan {
  int B, HW, C, G, elem_bytes, vec, threads, n, ppb, rpx, cpx, chunks, smem, resident;
};

inline NormPlan read_norm_plan(const int* v) {
  NormPlan p;
  int* dst = &p.B;
  for (int i = 0; i < 14; ++i) dst[i] = v[i];
  return p;
}

// A plan this kernel can run, and that agrees with its layout (norm_plan.py plan_ok).
inline bool norm_plan_ok(const NormPlan& p, int elem_bytes) {
  const int V = 16 / elem_bytes;
  if (p.elem_bytes != elem_bytes || p.vec != V || p.B < 1 || p.HW < 1 || p.G < 1 ||
      p.G > kMaxGroups || p.C % V || p.C % p.G || (p.C / p.G) % V)
    return false;
  const int cv = p.C / V;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % cv) return false;
  const int step_px = p.threads / cv;
  const int64_t ppb = p.ppb;
  return p.n >= 1 && p.n <= kMaxCluster && p.n * ppb >= p.HW && (p.n - 1) * ppb < p.HW &&
         p.rpx >= 1 && p.rpx <= p.ppb && p.resident == (p.rpx == p.ppb ? 1 : 0) && p.cpx >= 1 &&
         p.cpx % step_px == 0 && p.chunks == (p.rpx + p.cpx - 1) / p.cpx &&
         p.chunks <= kMaxChunks &&
         (int64_t)p.rpx * p.C * elem_bytes + 4 * p.C + 8 * p.n * p.G <= p.smem &&
         p.smem <= kSmemDynamic;
}

// What a call computes besides x and the plan.
struct GnArgs {
  const void* x;
  void* out;                // x's dtype, or int8 codes
  const void* scale;        // mul_c = scale_c or 1 + scale_c (one_plus)
  const void* shift;        // add_c
  int64_t aff_bstride;      // elements from one sample's scale/shift row to the next (0: shared)
  int aff_bf16;             // scale/shift are bf16 (else f32)
  int one_plus;
  int silu;
  const float* act_max;     // K4: (C,) calibrated maxima of the consuming conv's input
  float* moments;           // (B, G, 2) f32: each group's mean and 1/std, for the backward
                            // (gn_bwd.cu); null where no backward follows
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, bulk copies, cluster barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// The initialised barriers visible to this block's bulk copies (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ... and to the other blocks of the cluster, once they pass a cluster barrier.
__device__ __forceinline__ void mbar_fence_init_cluster() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete (the bulk copies of this block).
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

// The same, acquiring at cluster scope: what other blocks stored to this block's shared
// memory and completed on the barrier is visible.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
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
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The address of this block's shared variable p in the shared memory of cluster block rank.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// (a, b) into another block's shared memory at cluster address dst, completing 8 bytes
// on that block's barrier at cluster address bar.
__device__ __forceinline__ void remote_store2(uint32_t dst, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

// Arrive without ordering this thread's memory operations (the barriers' initialisation
// is ordered by mbar_fence_init_cluster), so the arrival does not wait for its loads.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The kernel

// Element i of a f32 or bf16 row as loaded (a bf16's 16 bits), and as a float: no
// arithmetic on the loaded value until it is used, so the load's latency hides.
__device__ __forceinline__ uint32_t aff_raw(const void* p, int64_t i, int bf16) {
  return bf16 ? static_cast<const uint16_t*>(p)[i] : static_cast<const uint32_t*>(p)[i];
}
__device__ __forceinline__ float aff_float(uint32_t raw, int bf16) {
  return __uint_as_float(bf16 ? raw << 16 : raw);  // a bf16 is the high half of its f32
}

// The V codes of v[0..V) with the static scales of act_max[0..V) by their reciprocals r
// (q8_common.cuh q8_rcp_bits; the rare element near a rounding tie divides truly by its
// scale, recomputed there), one 4- or 8-byte store.
template <int V>
__device__ __forceinline__ void store_q8_rcp(signed char* p, const float* v,
                                             const float* act_max, const float* r) {
  uint32_t b[V];
  float dmax = 0.f;  // one test for the vector: is any element near a tie?
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float dist;
    b[j] = q8_rcp_bits(v[j], r[j], dist);
    dmax = fmaxf(dmax, dist);
  }
  if (dmax > kNearTie) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float dist;
      q8_rcp_bits(v[j], r[j], dist);
      if (dist > kNearTie)
        b[j] = static_cast<unsigned char>(quantize_q8(v[j], static_scale(act_max[j])));
    }
  }
  uint32_t w[V / 4];
#pragma unroll
  for (int k = 0; k < V / 4; ++k)  // the low bytes of four codes into one word
    w[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], 0x0040),
                       __byte_perm(b[4 * k + 2], b[4 * k + 3], 0x0040), 0x5410);
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

template <typename T, bool kQ8>
__global__ void __launch_bounds__(kMaxThreads, 3)
gn_cluster_kernel(const GnArgs a, const NormPlan p) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem_x[];
  __shared__ float s_sum[kMaxThreads], s_sq[kMaxThreads];
  __shared__ float s_mean[kMaxGroups], s_inv[kMaxGroups];
  __shared__ __align__(8) uint64_t s_bar[kMaxChunks + 1];  // the chunks', then the partials'

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / p.n, t = threadIdx.x, nt = p.threads, C = p.C, G = p.G;
  const int gs = C / G, c0 = (t * V) % C;
  const int span_px = min(p.ppb, p.HW - rank * p.ppb);
  const int64_t step = (int64_t)nt * V;
  const int64_t span = (int64_t)span_px * C;                // elements of this block
  const int64_t res = (int64_t)min(span_px, p.rpx) * C;     // of them on chip
  const int64_t chunk = (int64_t)p.cpx * C;
  const int nchunks = static_cast<int>((res + chunk - 1) / chunk);
  const int64_t base = (int64_t)b * p.HW * C + (int64_t)rank * p.ppb * C;
  const T* xg = static_cast<const T*>(a.x) + base;
  // dynamic shared memory: x's span, K4's 1/s_c per channel, every rank's G partials
  const T* xs = reinterpret_cast<const T*>(smem_x);
  float* s_rc = reinterpret_cast<float*>(smem_x + (int64_t)p.rpx * C * sizeof(T));
  float* s_part = s_rc + C;  // [rank][group][sum, sum of squares]
  uint64_t* part_bar = &s_bar[kMaxChunks];

  if (t == 0) {
    for (int k = 0; k < nchunks; ++k) mbar_init(&s_bar[k], 1);
    mbar_init(part_bar, 1);
    mbar_fence_init();
    for (int k = 0; k < nchunks; ++k) {
      const int64_t off = k * chunk;
      const uint32_t bytes = static_cast<uint32_t>((res - off < chunk ? res - off : chunk) * sizeof(T));
      mbar_expect_tx(&s_bar[k], bytes);
      bulk_load(smem_x + off * sizeof(T), xg + off, bytes, &s_bar[k]);
    }
    if (p.n > 1) {
      mbar_fence_init_cluster();
      mbar_expect_tx(part_bar, 8u * p.n * G);  // the n ranks' stores to come
    }
  }

  // the coefficients of the thread's channels: loaded while the copies fly, converted
  // once the statistics are done
  uint32_t sraw[V], hraw[V];
  const int64_t ar = (int64_t)b * a.aff_bstride + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sraw[j] = aff_raw(a.scale, ar + j, a.aff_bf16);
    hraw[j] = aff_raw(a.shift, ar + j, a.aff_bf16);
  }
  const float am0 = kQ8 && t < C ? a.act_max[t] : 0.f;
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (p.n > 1) cluster_arrive_relaxed();  // ... or stores to them from another block
  if constexpr (kQ8)  // each channel's 1/s_c once per block, read back after a barrier
    for (int c = t; c < C; c += nt)
      s_rc[c] = __frcp_rn(static_scale(c == t ? am0 : a.act_max[c]));

  // statistics: chunk by chunk as they land, then the part left in device memory
  float sum = 0.f, sq = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    mbar_wait(&s_bar[k], 0);
    const int64_t end = (k + 1) * chunk < res ? (k + 1) * chunk : res;
    for (int64_t i = k * chunk + (int64_t)t * V; i < end; i += step) {
      float v[V];
      load_vec(xs + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sum = __fadd_rn(sum, v[j]);
        sq = __fmaf_rn(v[j], v[j], sq);
      }
    }
  }
  for (int64_t i = res + (int64_t)t * V; i < span; i += step) {
    float v[V];
    load_vec(xg + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sum = __fadd_rn(sum, v[j]);
      sq = __fmaf_rn(v[j], v[j], sq);
    }
  }
  s_sum[t] = sum;
  s_sq[t] = sq;
  __syncthreads();
  if (p.n > 1) cluster_wait();  // every block's barriers are ready for its partials

  // this block's partial per group: full warp w reduces groups w, w + T/32, ... over the
  // T/G threads whose channels lie in the group (cpg of every pixel's C/V threads), and
  // stores it into slot [rank][g] of every block of the cluster
  const int warp = t / 32, lane = t % 32, warps = nt / 32;
  const int cv = C / V, cpg = gs / V, per_group = nt / G;
  for (int g = warp; warp < warps && g < G; g += warps) {
    float s = 0.f, q = 0.f;
    for (int k = lane; k < per_group; k += 32) {
      const int u = k / cpg * cv + g * cpg + k % cpg;
      s = __fadd_rn(s, s_sum[u]);
      q = __fadd_rn(q, s_sq[u]);
    }
    s = warp_sum(s);
    q = warp_sum(q);
    float* slot = s_part + 2 * (rank * G + g);
    if (p.n == 1) {
      if (lane == 0) {
        slot[0] = s;
        slot[1] = q;
      }
    } else if (lane < p.n) {  // lane r stores to rank r
      remote_store2(cluster_addr(slot, lane), s, q, cluster_addr(part_bar, lane));
    }
  }

  // the coefficients, while the partials travel
  float mul[V], add[V], rc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sv = aff_float(sraw[j], a.aff_bf16);
    mul[j] = a.one_plus ? __fadd_rn(1.f, sv) : sv;
    add[j] = aff_float(hraw[j], a.aff_bf16);
  }

  // every block sums ranks 0..n-1 in order: the same bits everywhere
  if (p.n == 1) __syncthreads();
  if (t < G) {
    if (p.n > 1) mbar_wait_cluster(part_bar, 0);
    float s = 0.f, q = 0.f;
    for (int r = 0; r < p.n; ++r) {
      s = __fadd_rn(s, s_part[2 * (r * G + t)]);
      q = __fadd_rn(q, s_part[2 * (r * G + t) + 1]);
    }
    const float count = static_cast<float>((int64_t)p.HW * gs);
    const float mean = __fdiv_rn(s, count);
    const float var = __fsub_rn(__fdiv_rn(q, count), __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, kGnEps));
    s_mean[t] = mean;
    s_inv[t] = inv;
    if (a.moments != nullptr && rank == 0)
      reinterpret_cast<float2*>(a.moments)[b * G + t] = make_float2(mean, inv);
  }
  __syncthreads();

  const float mean = s_mean[c0 / gs], inv = s_inv[c0 / gs];
  if constexpr (kQ8) {
#pragma unroll
    for (int j = 0; j < V; ++j) rc[j] = s_rc[c0 + j];
  }
  using Out = typename std::conditional<kQ8, signed char, T>::type;
  Out* yg = static_cast<Out*>(a.out) + base;
  auto apply = [&](const T* src, int64_t i) {
    float v[V];
    load_vec(src + i, v);
    if constexpr (kQ8) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = gn_element(v[j], mean, inv, mul[j], add[j], 1);
      round_to<V>(v, T{});
      store_q8_rcp<V>(yg + i, v, a.act_max + c0, rc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = gn_element(v[j], mean, inv, mul[j], add[j], a.silu);
      store_vec(yg + i, v);
    }
  };
  int64_t i = (int64_t)t * V;
  for (; i + step < res; i += 2 * step) {  // two vectors a step, for more in flight
    apply(xs, i);
    apply(xs, i + step);
  }
  if (i < res) apply(xs, i);
  for (i = res + (int64_t)t * V; i < span; i += step) apply(xg, i);
}

// The function attributes any plan needs, set once per instantiation: the most dynamic
// shared memory a plan asks, and clusters above 8 blocks.
template <typename T, bool kQ8>
cudaError_t gn_set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = gn_cluster_kernel<T, kQ8>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

// The launch configuration of plan p: B clusters of n blocks (attr holds the cluster size).
inline cudaLaunchConfig_t gn_config(const NormPlan& p, cudaLaunchAttribute* attr,
                                    cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.n);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of the kernel on plan p (checked against the kernel's layout first).
template <typename T, bool kQ8>
int launch_gn(const GnArgs& a, const NormPlan& p, cudaStream_t st) {
  if (!norm_plan_ok(p, sizeof(T))) return (int)cudaErrorInvalidValue;
  cudaError_t e = gn_set_attributes<T, kQ8>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_config(p, &attr, st);
  e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, kQ8>, a, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The clusters of plan p the current card can run at once, 0 where it cannot place one
// (a cluster of 16 blocks needs 16 of p's blocks in one GPC, which an H100 SXM has and a
// smaller part or a partition of a card may not); a negative CUDA error code on failure.
template <typename T, bool kQ8>
int max_clusters_gn(const NormPlan& p) {
  if (!norm_plan_ok(p, sizeof(T))) return -(int)cudaErrorInvalidValue;
  cudaError_t e = gn_set_attributes<T, kQ8>();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_config(p, &attr, 0);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, gn_cluster_kernel<T, kQ8>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// x's dtype from the plan: 4-byte elements float32, 2-byte bfloat16.
template <bool kQ8>
int dispatch_gn(const GnArgs& a, const int* plan, void* stream) {
  const NormPlan p = read_norm_plan(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.elem_bytes == 4) return launch_gn<float, kQ8>(a, p, st);
  if (p.elem_bytes == 2) return launch_gn<__nv_bfloat16, kQ8>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

template <bool kQ8>
int dispatch_max_clusters(const int* plan) {
  const NormPlan p = read_norm_plan(plan);
  if (p.elem_bytes == 4) return max_clusters_gn<float, kQ8>(p);
  if (p.elem_bytes == 2) return max_clusters_gn<__nv_bfloat16, kQ8>(p);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace
