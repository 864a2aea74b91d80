// The backward of the fused GroupNorm(+SiLU) kernels, for Hopper (sm_90a): K2's gradient
// (a learned affine) and K1's (AdaGN: a FiLM row per sample), one template.
//
// Replaces the backwards of diamond_tpu/ops/fused_norms.py::groupnorm_silu and
// ::adagn_silu, jax.custom_vjps whose backwards are the XLA VJPs of _gn_silu_ref and
// _adagn_silu_ref (the TPU has no backward Pallas kernel). With x̂ = (x - mean_g) * inv_g
// (the forward's moments), the multiplier m = scale (K2) or 1 + scale_b (K1), the shift
// a = bias or shift_b, o = x̂ * m + a, dO = dy * SiLU'(o) (dy without the SiLU) and
// g = dO * m, per group of N = HW * C/G elements of a sample:
//   dx     = inv_g * (g - mean_g(g) - x̂ * mean_g(g * x̂)),
//   K2: dscale = sum over B, H, W of dO * x̂,   dbias = sum over B, H, W of dO;
//   K1: dscale_b = sum over H, W of dO * x̂,    dshift_b = sum over H, W of dO (per sample).
//
// What bounds it: bytes. x and dy are read once and dx written once (25.2 MB at
// B = 32, 64x64x32 bf16, 7.5 µs at 3.35 TB/s); each element takes ~15 f32 operations
// and two special-function ones (SiLU''s exponential and reciprocal). A sample of the
// denoiser's 64x64 levels (x and dy: 1-2 MB in bf16) is more than the 8 blocks of a
// portable cluster can hold while several blocks share an SM, so part of each span is
// read from device memory twice; the L2 policies below keep that part in L2.
//
// Design (the launch plan is ops/norm_plan.py ``bwd_plan``, the backward's own, timed by
// scripts/time_norm_grads.py --explore):
//   * The forward saved each group's mean and 1/std (gn_common.cuh GnArgs::moments): the
//     backward reads them, so it has one reduction round and does not depend on the
//     forward's plan.
//   * One launch per call: B clusters of n <= 8 blocks (a portable cluster size), one
//     cluster per sample; block r owns the ppb whole pixels from r * ppb. Thread 0
//     bulk-copies the first rpx of them, x and dy, into shared memory in chunks, both
//     arrays' chunk k on mbarrier k, with an L2 evict-first policy (they are not read
//     from device memory again). Where the span is longer than rpx (a block's shared
//     memory is sized for four blocks an SM), the rest is read from device memory,
//     first, while the copies land: x kept in L2, dy streamed.
//   * The summing pass: per vector of V elements x̂, o, SiLU'(o) once, dO and g; the
//     thread sums g and g * x̂ (its V channels lie in one group) and, per channel, dO * x̂
//     and dO, and writes g back over dy in shared memory (for the part read from device
//     memory: into dx, read back by the same thread), so the dx pass evaluates no
//     sigmoid. bf16 rounds g once there (f32 keeps it exact).
//   * One exchange round, pushed: each block stores its per-group sums into slot [rank]
//     of every block of the cluster (st.async on that block's mbarrier), and its per-
//     channel sums (over its threads in a fixed order) into slot [rank] of the block that
//     finishes the channel (rank c % n); each sums the slots in rank order: every block,
//     every run, the same bits, no float atomics, no cluster barrier after the first.
//     The finished per-sample sums of the 2C channels are K1's FiLM gradient, written in
//     the rows' dtype; K2 writes them (f32) into a (B, 2C) scratch and thread 0 takes a
//     ticket (an atomic counter, after a fence).
//   * dx from shared memory, then from device memory last-written first (the likeliest
//     still in L2), two vectors' loads in flight, stores streamed.
//   * K2: the block with the last ticket sums the B scratch rows in sample order (16
//     rows' loads in flight per thread) and writes dscale and dbias in the affine's
//     dtype, then resets the counter to 0: the same bits whatever order the blocks
//     finish in, and no second launch.
// Element arithmetic pinned by intrinsics as in the forward (the sigmoid 1 / (1 + e^-o)
// with __expf and __fdividef); rounding to bf16 to nearest even (__float2bfloat16_rn, as
// torch's .to() rounds).

#include "gn_common.cuh"

namespace {

constexpr int kBwdClusterMax = 8;  // portable clusters only
constexpr int kSmemBlock = 232448;  // a block's shared memory, static and dynamic

struct GnBwdArgs {
  const void* x;
  const void* dy;          // x's dtype
  const float* moments;    // (B, G, 2): each group's mean and 1/std, from the forward
  void* dx;                // x's dtype
  const void* scale;       // K2: (C,); K1: the FiLM rows' scale half, row b at b * 2C
  const void* bias;        // K2: (C,); K1: their shift half (scale + C), same stride
  int aff_bf16;            // f32 or bf16 rows, and so the gradient's dtype
  int silu;
  void* out;               // K1: (B, 2C), d scale_b then d shift_b; K2: (2, C), dscale
                           // then dbias; both in the rows' dtype
  float* rows;             // K2: (B, 2C) f32 scratch, each sample's sums
  unsigned* ticket;        // K2: the blocks that finished; 0 before and after a launch
};

// Shared memory of x's and dy's on-chip spans.
__host__ __device__ inline int64_t gn_bwd_data_bytes(const NormPlan& p) {
  return (2 * (int64_t)p.rpx * p.C * p.elem_bytes + 15) / 16 * 16;
}

// Channels of the sample's 2C sums that each rank of the cluster finishes (rank r:
// r, r + n, ...), at most.
__host__ __device__ inline int gn_bwd_owned(const NormPlan& p) {
  return (2 * p.C + p.n - 1) / p.n;
}

// Dynamic shared memory of the backward: the data, every thread's per-channel sums
// ([2][threads][V] f32), every rank's G partials, and (n > 1) the sums every rank sends
// for the channels this block finishes (ops/norm_plan.py bwd_smem).
__host__ __device__ inline int64_t gn_bwd_smem(const NormPlan& p) {
  const int64_t recv = p.n > 1 ? 4 * (int64_t)p.n * gn_bwd_owned(p) : 0;
  return gn_bwd_data_bytes(p) + 8 * (int64_t)p.threads * p.vec + 8 * (int64_t)p.n * p.G +
         (recv + 15) / 16 * 16;
}

// A backward plan this kernel can run (norm_plan.py bwd_plan_ok).
inline bool norm_bwd_plan_ok(const NormPlan& p, int elem_bytes) {
  const int V = 16 / elem_bytes;
  if (p.elem_bytes != elem_bytes || p.vec != V || p.B < 1 || p.HW < 1 || p.G < 1 ||
      p.G > kMaxGroups || p.C % V || p.C % p.G || (p.C / p.G) % V)
    return false;
  const int cv = p.C / V;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % cv || p.threads < p.G)
    return false;
  const int step_px = p.threads / cv;
  const int64_t ppb = p.ppb;
  return p.n >= 1 && p.n <= kBwdClusterMax && p.n * ppb >= p.HW && (p.n - 1) * ppb < p.HW &&
         p.rpx >= 1 && p.rpx <= p.ppb && p.resident == (p.rpx == p.ppb ? 1 : 0) && p.cpx >= 1 &&
         p.cpx % step_px == 0 && p.chunks == (p.rpx + p.cpx - 1) / p.cpx &&
         p.chunks <= kMaxChunks && gn_bwd_smem(p) == p.smem && p.smem <= kSmemDynamic;
}

// SiLU'(o) = s * (1 + o * (1 - s)), s = 1 / (1 + e^-o): 0 where e^-o overflows.
__device__ __forceinline__ float dsilu(float o) {
  const float s = __fdividef(1.f, __fadd_rn(1.f, __expf(-o)));
  return __fmul_rn(s, __fmaf_rn(o, __fsub_rn(1.f, s), 1.f));
}

// This block's G partials (a per-thread value, summed over the T/G threads of each
// group by full warps) into slot [rank][g] of every block of the cluster: the forward's
// order (gn_common.cuh).
__device__ __forceinline__ void push_partials(const float* s_a, const float* s_b, float* s_part,
                                              uint64_t* bar, int rank, int n, int C, int G,
                                              int V, int nt, int t) {
  const int warp = t / 32, lane = t % 32, warps = nt / 32;
  const int cv = C / V, cpg = C / G / V, per_group = nt / G;
  for (int g = warp; warp < warps && g < G; g += warps) {
    float s = 0.f, q = 0.f;
    for (int k = lane; k < per_group; k += 32) {
      const int u = k / cpg * cv + g * cpg + k % cpg;
      s = __fadd_rn(s, s_a[u]);
      q = __fadd_rn(q, s_b[u]);
    }
    s = warp_sum(s);
    q = warp_sum(q);
    float* slot = s_part + 2 * (rank * G + g);
    if (n == 1) {
      if (lane == 0) {
        slot[0] = s;
        slot[1] = q;
      }
    } else if (lane < n) {  // lane r stores to rank r
      remote_store2(cluster_addr(slot, lane), s, q, cluster_addr(bar, lane));
    }
  }
}

// v into another block's shared memory at cluster address dst, completing 4 bytes on
// that block's barrier at cluster address bar.
__device__ __forceinline__ void remote_store1(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(dst),
      "f"(v), "r"(bar)
      : "memory");
}

// v into element i of a f32 or bf16 array.
__device__ __forceinline__ void store_as(void* p, int64_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// 16 bytes (one vector of V elements) as loaded, unpacked only where it is used, so that
// a thread's loads of two vectors are in flight together: from shared memory, and from
// device memory with an L2 policy (kept: read again in this kernel; streamed: read once;
// last use).
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ uint4 load16_stream(const T* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ uint4 load16_last(const T* p) {
  return __ldlu(reinterpret_cast<const uint4*>(p));
}

// V floats as T, stored with an evict-first policy (dx is not read again here).
__device__ __forceinline__ void store_stream(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), r);
}

// An L2 policy that evicts first what it tags: x's and dy's spans copied on chip are not
// read from device memory again, so they should not push out what is.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// gn_common.cuh's bulk_load with an L2 cache policy.
__device__ __forceinline__ void bulk_load_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}
__device__ __forceinline__ void unpack(uint4 r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, bool kFilm, bool kSilu>
__global__ void __launch_bounds__(kMaxThreads, 3)
gn_bwd_kernel(const GnBwdArgs a, const NormPlan p) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem_b[];
  __shared__ float s_a[kMaxThreads], s_b[kMaxThreads];
  __shared__ float s_m1[kMaxGroups], s_m2[kMaxGroups];
  // the chunks' barriers, then the group partials', then the channel sums'
  __shared__ __align__(8) uint64_t s_bar[kMaxChunks + 2];
  __shared__ unsigned s_ticket;

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / p.n, t = threadIdx.x, nt = p.threads, C = p.C, G = p.G;
  const int gs = C / G, c0 = (t * V) % C, grp = c0 / gs;
  const int span_px = min(p.ppb, p.HW - rank * p.ppb);
  const int64_t step = (int64_t)nt * V;
  const int64_t span = (int64_t)span_px * C;                // elements of this block
  const int64_t res = (int64_t)min(span_px, p.rpx) * C;     // of them on chip
  const int64_t chunk = (int64_t)p.cpx * C;
  const int nchunks = static_cast<int>((res + chunk - 1) / chunk);
  const int64_t base = (int64_t)b * p.HW * C + (int64_t)rank * p.ppb * C;
  const T* xg = static_cast<const T*>(a.x) + base;
  const T* dyg = static_cast<const T*>(a.dy) + base;
  T* dxg = static_cast<T*>(a.dx) + base;
  const int64_t arr = (int64_t)p.rpx * C;  // elements of one array's region
  T* xs = reinterpret_cast<T*>(smem_b);
  T* gsm = xs + arr;                                       // dy, then g
  float* s_chan = reinterpret_cast<float*>(smem_b + gn_bwd_data_bytes(p));  // [2][T][V]
  float* s_part = s_chan + 2 * nt * V;                     // [rank][g][2]
  float* s_recv = s_part + 2 * p.n * G;                    // [rank][owned]
  const int owned = gn_bwd_owned(p);
  const int mine = (2 * C - rank + p.n - 1) / p.n;  // the channels this block finishes
  uint64_t* part_bar = &s_bar[kMaxChunks];
  uint64_t* chan_bar = &s_bar[kMaxChunks + 1];

  if (t == 0) {
    for (int k = 0; k < nchunks; ++k) mbar_init(&s_bar[k], 1);
    mbar_init(part_bar, 1);
    mbar_init(chan_bar, 1);
    mbar_fence_init();
    const uint64_t pol = evict_first_policy();
    for (int k = 0; k < nchunks; ++k) {
      const int64_t off = k * chunk;
      const uint32_t bytes =
          static_cast<uint32_t>((res - off < chunk ? res - off : chunk) * sizeof(T));
      mbar_expect_tx(&s_bar[k], 2 * bytes);
      bulk_load_hint(xs + off, xg + off, bytes, &s_bar[k], pol);
      bulk_load_hint(gsm + off, dyg + off, bytes, &s_bar[k], pol);
    }
    if (p.n > 1) {
      mbar_fence_init_cluster();
      mbar_expect_tx(part_bar, 8u * p.n * G);   // the n ranks' stores to come
      mbar_expect_tx(chan_bar, 4u * p.n * mine);
    }
  }

  uint32_t sraw[V], hraw[V];
  const int64_t ar = (kFilm ? (int64_t)b * 2 * C : 0) + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sraw[j] = aff_raw(a.scale, ar + j, a.aff_bf16);
    hraw[j] = aff_raw(a.bias, ar + j, a.aff_bf16);
  }
  const float2 mom = reinterpret_cast<const float2*>(a.moments)[b * G + grp];
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (p.n > 1) cluster_arrive_relaxed();  // ... or stores to them from another block

  float sc[V], bi[V];  // m and a, as the forward computes them (gn_common.cuh)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sv = aff_float(sraw[j], a.aff_bf16);
    sc[j] = kFilm ? __fadd_rn(1.f, sv) : sv;
    bi[j] = aff_float(hraw[j], a.aff_bf16);
  }
  const float mean = mom.x, inv = mom.y;

  // the summing pass: g of one vector of x and dy into gdst, the thread's sums
  float g1 = 0.f, g2 = 0.f, dsc[V], dbi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) dsc[j] = dbi[j] = 0.f;
  auto sum_vec = [&](uint4 xr, uint4 dr, T* gdst) {
    float v[V], d[V];
    unpack(xr, v, T{});
    unpack(dr, d, T{});
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(v[j], mean), inv);
      if constexpr (kSilu) d[j] = __fmul_rn(d[j], dsilu(__fmaf_rn(xh, sc[j], bi[j])));
      const float gm = __fmul_rn(d[j], sc[j]);
      g1 = __fadd_rn(g1, gm);
      g2 = __fmaf_rn(gm, xh, g2);
      dsc[j] = __fmaf_rn(d[j], xh, dsc[j]);
      dbi[j] = __fadd_rn(dbi[j], d[j]);
      v[j] = gm;
    }
    store_vec(gdst, v);
  };
  // the part in device memory first, while the copies land: x kept in L2 for the dx
  // pass, dy streamed, g into dx; two vectors' loads in flight ...
  {
    int64_t i = res + (int64_t)t * V;
    for (; i + step < span; i += 2 * step) {
      const uint4 x0 = load16(xg + i), d0 = load16_stream(dyg + i);
      const uint4 x1 = load16(xg + i + step), d1 = load16_stream(dyg + i + step);
      sum_vec(x0, d0, dxg + i);
      sum_vec(x1, d1, dxg + i + step);
    }
    if (i < span) sum_vec(load16(xg + i), load16_stream(dyg + i), dxg + i);
  }
  // ... then the chunks on chip as they land (g over dy)
  for (int k = 0; k < nchunks; ++k) {
    mbar_wait(&s_bar[k], 0);
    const int64_t end = (k + 1) * chunk < res ? (k + 1) * chunk : res;
    int64_t i = k * chunk + (int64_t)t * V;
    for (; i + step < end; i += 2 * step) {
      const uint4 x0 = load16(xs + i), d0 = load16(gsm + i);
      const uint4 x1 = load16(xs + i + step), d1 = load16(gsm + i + step);
      sum_vec(x0, d0, gsm + i);
      sum_vec(x1, d1, gsm + i + step);
    }
    if (i < end) sum_vec(load16(xs + i), load16(gsm + i), gsm + i);
  }
  // the thread's sums: per group (g, g * x̂) and per channel (dO * x̂, dO)
  s_a[t] = g1;
  s_b[t] = g2;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_chan[t * V + j] = dsc[j];
    s_chan[(nt + t) * V + j] = dbi[j];
  }
  __syncthreads();
  if (p.n > 1) cluster_wait();  // every block's barriers are ready for its stores
  push_partials(s_a, s_b, s_part, part_bar, rank, p.n, C, G, V, nt, t);

  // this block's per-channel sums: threads k * C/V + c/V hold channel c, summed in k
  // order; where the cluster is one block they are the sample's, else each goes to the
  // rank that finishes its channel (c % n), into slot [rank]
  auto finish = [&](int c, float s) {  // the sample's sum for FiLM / scratch column c
    if constexpr (kFilm) {
      store_as(a.out, (int64_t)b * 2 * C + c, s, a.aff_bf16);
    } else {
      a.rows[(int64_t)b * 2 * C + c] = s;
    }
  };
  {
    const int cv = C / V, steps_px = nt / cv;
    for (int c = t; c < 2 * C; c += nt) {
      const int which = c / C, cc = c - which * C;
      const float* src = s_chan + (int64_t)which * nt * V + cc;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < steps_px; ++k) s = __fadd_rn(s, src[(int64_t)k * cv * V]);
      if (p.n == 1) {
        finish(c, s);
      } else {
        const int owner = c % p.n;
        remote_store1(cluster_addr(s_recv + rank * owned + c / p.n, owner), s,
                      cluster_addr(chan_bar, owner));
      }
    }
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
    s_m1[t] = __fdiv_rn(s, count);
    s_m2[t] = __fdiv_rn(q, count);
  }
  if (p.n > 1 && t < mine) {  // the sample's sums of this block's channels, in rank order
    mbar_wait_cluster(chan_bar, 0);
    for (int k = t; k < mine; k += nt) {
      float s = 0.f;
      for (int r = 0; r < p.n; ++r) s = __fadd_rn(s, s_recv[r * owned + k]);
      finish(rank + k * p.n, s);
    }
  }
  __syncthreads();  // the means are in place; K2: this block's scratch columns written ...
  unsigned ticket = 0;  // (read after the dx pass: the atomic's latency hides behind it)
  if (!kFilm && t == 0) {
    __threadfence();  // ... and visible to the card before its ticket
    ticket = atomicAdd(a.ticket, 1u);
  }

  // dx = inv * (g - mean(g) - x̂ * mean(g * x̂)), two vectors' loads in flight
  const float m1 = s_m1[grp], m2 = s_m2[grp];
  auto apply = [&](uint4 xr, uint4 gr, T* dst) {
    float v[V], gv[V];
    unpack(xr, v, T{});
    unpack(gr, gv, T{});
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = __fmul_rn(__fsub_rn(v[j], mean), inv);
      v[j] = __fmul_rn(inv, __fsub_rn(__fsub_rn(gv[j], m1), __fmul_rn(xh, m2)));
    }
    store_stream(dst, v);
  };
  {  // the part on chip
    int64_t i = (int64_t)t * V;
    for (; i + step < res; i += 2 * step) {
      const uint4 x0 = load16(xs + i), g0 = load16(gsm + i);
      const uint4 x1 = load16(xs + i + step), g1r = load16(gsm + i + step);
      apply(x0, g0, dxg + i);
      apply(x1, g1r, dxg + i + step);
    }
    if (i < res) apply(load16(xs + i), load16(gsm + i), dxg + i);
  }
  {  // the part in device memory, last written first (the likeliest still in L2)
    const int64_t first = res + (int64_t)t * V;
    int64_t i = first < span ? first + (span - 1 - first) / step * step : first - step;
    for (; i - step >= first; i -= 2 * step) {
      const uint4 x0 = load16_last(xg + i), g0 = load16_last(dxg + i);
      const uint4 x1 = load16_last(xg + i - step), g1r = load16_last(dxg + i - step);
      apply(x0, g0, dxg + i);
      apply(x1, g1r, dxg + i - step);
    }
    if (i >= first) apply(load16_last(xg + i), load16_last(dxg + i), dxg + i);
  }

  if constexpr (!kFilm) {  // the block with the last ticket sums the samples in order
    if (t == 0) s_ticket = ticket;
    __syncthreads();  // (its loads below depend on the ticket: they follow every fence)
    if (s_ticket == gridDim.x - 1) {  // K threads a column: rows k, k + K, ..., then k order
      const int cols = 2 * C, K = cols <= nt ? nt / cols : 1;
      for (int c = t % cols; c < cols && t < K * cols; c += nt) {
        float s = 0.f;
        for (int r0 = t / cols; r0 < p.B; r0 += 16 * K) {  // 16 rows' loads in flight
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            v[u] = r0 + u * K < p.B ? __ldcg(a.rows + (int64_t)(r0 + u * K) * cols + c) : 0.f;
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (r0 + u * K < p.B) s = __fadd_rn(s, v[u]);
        }
        if (K == 1) {
          store_as(a.out, c, s, a.aff_bf16);
        } else {
          s_a[t] = s;
        }
      }
      if (K > 1) {
        __syncthreads();
        if (t < cols) {
          float s = 0.f;
          for (int k = 0; k < K; ++k) s = __fadd_rn(s, s_a[k * cols + t]);
          store_as(a.out, t, s, a.aff_bf16);
        }
      }
      if (t == 0) *a.ticket = 0u;  // ready for the next launch
    }
  }
}

template <typename T, bool kFilm, bool kSilu>
int launch_gn_bwd(const GnBwdArgs& a, const NormPlan& p, cudaStream_t st) {
  static bool attr_set = false;  // the most dynamic shared memory a block can have
  auto kernel = gn_bwd_kernel<T, kFilm, kSilu>;
  if (!attr_set) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    const int most = kSmemBlock - static_cast<int>(fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most < kSmemDynamic ? most : kSmemDynamic);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_config(p, &attr, st);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kFilm>
int dispatch_gn_bwd(const GnBwdArgs& a, const int* plan, void* stream) {
  const NormPlan p = read_norm_plan(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.elem_bytes == 4 && norm_bwd_plan_ok(p, 4))
    return a.silu ? launch_gn_bwd<float, kFilm, true>(a, p, st)
                  : launch_gn_bwd<float, kFilm, false>(a, p, st);
  if (p.elem_bytes == 2 && norm_bwd_plan_ok(p, 2))
    return a.silu ? launch_gn_bwd<__nv_bfloat16, kFilm, true>(a, p, st)
                  : launch_gn_bwd<__nv_bfloat16, kFilm, false>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: (B, H, W, C) of the plan's dtype (elem_bytes); moments: (B, G, 2) f32, the
// forward's mean and 1/std per group; scale, bias: (C,) of aff_dtype (0 float32, 1
// bfloat16); dsb: (2, C) of aff_dtype, dscale then dbias; rows: (B, 2C) f32 scratch;
// ticket: one unsigned int, 0 (the kernel leaves it 0). plan: ops/norm_plan.py bwd_plan's
// ints. One launch.
extern "C" int groupnorm_silu_bwd(const void* x, const void* dy, const void* moments,
                                  const void* scale, const void* bias, int aff_dtype, void* dx,
                                  void* dsb, void* rows, void* ticket, int silu, const int* plan,
                                  void* stream) {
  const GnBwdArgs a{x, dy, static_cast<const float*>(moments), dx, scale, bias, aff_dtype,
                    silu, dsb, static_cast<float*>(rows), static_cast<unsigned*>(ticket)};
  return dispatch_gn_bwd<false>(a, plan, stream);
}

// K1's backward. x, dy, dx: (B, H, W, C) of the plan's dtype; moments: (B, G, 2) f32;
// scale_shift: (B, 2C) FiLM rows of aff_dtype (0 float32, 1 bfloat16), scale then shift;
// dss: (B, 2C) of aff_dtype, their gradient. plan: ops/norm_plan.py bwd_plan's ints. One
// launch.
extern "C" int adagn_silu_bwd(const void* x, const void* dy, const void* moments,
                              const void* scale_shift, int aff_dtype, void* dx, void* dss,
                              int silu, const int* plan, void* stream) {
  const int C = plan[2];
  const void* shift = static_cast<const char*>(scale_shift) + (int64_t)C * (aff_dtype ? 2 : 4);
  const GnBwdArgs a{x, dy, static_cast<const float*>(moments), dx, scale_shift, shift, aff_dtype,
                    silu, dss, nullptr, nullptr};
  return dispatch_gn_bwd<true>(a, plan, stream);
}
