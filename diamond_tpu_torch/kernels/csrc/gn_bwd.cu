// The backward of the fused GroupNorm(+SiLU) kernels, for Hopper (sm_90a): K2's gradient
// (a learned affine) and K1's (AdaGN: a FiLM row per sample), one template.
//
// Replaces the backwards of diamond_tpu/ops/fused_norms.py::groupnorm_silu and
// ::adagn_silu, jax.custom_vjps whose backwards are the XLA VJPs of _gn_silu_ref and
// _adagn_silu_ref (the TPU has no backward Pallas kernel). With x̂ = (x - mean_g) * inv_g
// (the forward's moments), the multiplier m = scale (K2) or 1 + scale_b (K1), the shift
// a = bias or shift_b, o = x̂ * m + a and dO = dy * SiLU'(o) (dy without the SiLU), per
// group g of N = HW * C/G elements of a sample:
//   dx     = inv_g * (dO*m - mean_g(dO*m) - x̂ * mean_g(dO*m * x̂)),
//   K2: dscale = sum over B, H, W of dO * x̂,   dbias = sum over B, H, W of dO;
//   K1: dscale_b = sum over H, W of dO * x̂,    dshift_b = sum over H, W of dO (per sample).
//
// What bounds it: bytes. x and dy are read once and dx written once (25.2 MB at
// B = 32, 64x64x32 bf16, 7.5 µs at 3.35 TB/s); each element takes ~30 f32 operations
// and two special-function ones (the sigmoid's exponential and reciprocal), about a
// quarter of that time at the card's f32 rate.
//
// Design: gn_common.cuh's forward kernel with a second reduction round, on the
// forward's launch plan (ops/norm_plan.py ``bwd_plan``: the same clusters, blocks,
// threads and pixel spans), so that it recomputes the forward's moments bit for bit:
//   * one cluster of n blocks per sample; block r bulk-copies its span of x AND dy
//     into shared memory (chunks of both on one mbarrier each; a span beyond the
//     block's shared memory keeps rpx pixels there and reads the rest from device
//     memory in every pass);
//   * round 1, the moments, exactly as the forward: per-thread sums, per-group warp
//     sums, partials pushed to every block of the cluster (st.async on its barrier)
//     and summed in rank order;
//   * round 2: each thread recomputes o and dO for its vectors and sums dO*scale and
//     dO*scale*x̂ (its V channels lie in one group), and dO*x̂ and dO per channel; the
//     group sums go round the cluster as in round 1, on a second barrier; the
//     per-channel sums are reduced over the block's threads in a fixed order and
//     written as the block's (2, C) f32 partial;
//   * dx from shared memory, 16-byte stores;
//   * K2: a second small kernel sums the B * n block partials of dscale and dbias in
//     block order: the same bits every run, no atomics;
//   * K1: the FiLM gradient is per sample and one cluster holds one sample, so each
//     block leaves its (2, C) sums in its own shared memory, and after a cluster barrier
//     rank r sums channels r, r + n, ... of every rank's sums in rank order through
//     distributed shared memory and writes them once into the (B, 2C) output; a last
//     cluster barrier keeps each block's shared memory alive until the others have read
//     it. One launch, no scratch.
// Element arithmetic pinned by intrinsics as in the forward (o is gn_element's, the
// sigmoid 1 / (1 + e^-o) with __expf and __fdividef).

#include "gn_common.cuh"

namespace {

struct GnBwdArgs {
  const void* x;
  const void* dy;     // x's dtype
  void* dx;           // x's dtype
  const void* scale;  // K2: (C,); K1: the FiLM rows' scale half, row b at b * 2C
  const void* bias;   // K2: (C,); K1: their shift half (scale + C), same stride
  int aff_bf16;       // f32 or bf16 rows
  int silu;
  float* part;        // K2: (B * n, 2, C) f32, each block's sums of dO * x̂, then of dO;
                      // K1: (B, 2C) f32, the FiLM gradient (d scale_b, then d shift_b)
};

// Dynamic shared memory of the backward: x's and dy's spans, both rounds' partials of
// every rank, and each thread's per-channel sums (ops/norm_plan.py bwd_plan).
__host__ __device__ inline int64_t gn_bwd_smem(const NormPlan& p) {
  return 2 * (int64_t)p.rpx * p.C * p.elem_bytes + 16 * (int64_t)p.n * p.G +
         8 * (int64_t)p.threads * p.vec;
}

// A backward plan this kernel can run: the forward's layout rules, with x and dy in
// shared memory (norm_plan.py bwd_plan_ok).
inline bool norm_bwd_plan_ok(const NormPlan& p, int elem_bytes) {
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
         p.chunks <= kMaxChunks && gn_bwd_smem(p) <= p.smem && p.smem <= kSmemDynamic;
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

template <typename T, bool kFilm>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_bwd_cluster_kernel(const GnBwdArgs a, const NormPlan p) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem_b[];
  __shared__ float s_a[kMaxThreads], s_b[kMaxThreads];
  __shared__ float s_mean[kMaxGroups], s_inv[kMaxGroups], s_m1[kMaxGroups], s_m2[kMaxGroups];
  __shared__ __align__(8) uint64_t s_bar[kMaxChunks + 2];  // the chunks', then each round's

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / p.n, t = threadIdx.x, nt = p.threads, C = p.C, G = p.G;
  const int gs = C / G, c0 = (t * V) % C;
  const int span_px = min(p.ppb, p.HW - rank * p.ppb);
  const int64_t step = (int64_t)nt * V;
  const int64_t span = (int64_t)span_px * C;
  const int64_t res = (int64_t)min(span_px, p.rpx) * C;
  const int64_t chunk = (int64_t)p.cpx * C;
  const int nchunks = static_cast<int>((res + chunk - 1) / chunk);
  const int64_t base = (int64_t)b * p.HW * C + (int64_t)rank * p.ppb * C;
  const T* xg = static_cast<const T*>(a.x) + base;
  const T* dyg = static_cast<const T*>(a.dy) + base;
  T* dxg = static_cast<T*>(a.dx) + base;
  const int64_t arr = (int64_t)p.rpx * C;  // elements of one array's region
  const T* xs = reinterpret_cast<const T*>(smem_b);
  const T* dys = xs + arr;
  float* s_p1 = reinterpret_cast<float*>(smem_b + 2 * arr * sizeof(T));
  float* s_p2 = s_p1 + 2 * p.n * G;
  float* s_chan = s_p2 + 2 * p.n * G;  // [2][threads][V]: sums of dO * x̂, then of dO
  uint64_t* bar1 = &s_bar[kMaxChunks];
  uint64_t* bar2 = &s_bar[kMaxChunks + 1];

  if (t == 0) {
    for (int k = 0; k < nchunks; ++k) mbar_init(&s_bar[k], 1);
    mbar_init(bar1, 1);
    mbar_init(bar2, 1);
    mbar_fence_init();
    for (int k = 0; k < nchunks; ++k) {
      const int64_t off = k * chunk;
      const uint32_t bytes =
          static_cast<uint32_t>((res - off < chunk ? res - off : chunk) * sizeof(T));
      mbar_expect_tx(&s_bar[k], 2 * bytes);
      bulk_load(smem_b + off * sizeof(T), xg + off, bytes, &s_bar[k]);
      bulk_load(smem_b + (arr + off) * sizeof(T), dyg + off, bytes, &s_bar[k]);
    }
    if (p.n > 1) {
      mbar_fence_init_cluster();
      mbar_expect_tx(bar1, 8u * p.n * G);  // the n ranks' stores of each round
      mbar_expect_tx(bar2, 8u * p.n * G);
    }
  }

  uint32_t sraw[V], hraw[V];
  const int64_t ar = (kFilm ? (int64_t)b * 2 * C : 0) + c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sraw[j] = aff_raw(a.scale, ar + j, a.aff_bf16);
    hraw[j] = aff_raw(a.bias, ar + j, a.aff_bf16);
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (p.n > 1) cluster_arrive_relaxed();  // ... or stores to them from another block

  // round 1: the forward's moments, in its order (gn_common.cuh)
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
  s_a[t] = sum;
  s_b[t] = sq;
  __syncthreads();
  if (p.n > 1) cluster_wait();  // every block's barriers are ready for its partials
  push_partials(s_a, s_b, s_p1, bar1, rank, p.n, C, G, V, nt, t);

  float sc[V], bi[V];  // m and a: the forward's (gn_common.cuh, one_plus for K1)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float sv = aff_float(sraw[j], a.aff_bf16);
    sc[j] = kFilm ? __fadd_rn(1.f, sv) : sv;
    bi[j] = aff_float(hraw[j], a.aff_bf16);
  }
  if (p.n == 1) __syncthreads();
  if (t < G) {
    if (p.n > 1) mbar_wait_cluster(bar1, 0);
    float s = 0.f, q = 0.f;
    for (int r = 0; r < p.n; ++r) {
      s = __fadd_rn(s, s_p1[2 * (r * G + t)]);
      q = __fadd_rn(q, s_p1[2 * (r * G + t) + 1]);
    }
    const float count = static_cast<float>((int64_t)p.HW * gs);
    const float mean = __fdiv_rn(s, count);
    const float var = __fsub_rn(__fdiv_rn(q, count), __fmul_rn(mean, mean));
    s_mean[t] = mean;
    s_inv[t] = rsqrtf(__fadd_rn(var, kGnEps));
  }
  __syncthreads();
  const float mean = s_mean[c0 / gs], inv = s_inv[c0 / gs];

  // x̂ and dO of V elements of x and dy
  auto grads = [&](const T* xsrc, const T* dsrc, int64_t i, float* xh, float* d) {
    float v[V];
    load_vec(xsrc + i, v);
    load_vec(dsrc + i, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xh[j] = __fmul_rn(__fsub_rn(v[j], mean), inv);
      if (a.silu) d[j] = __fmul_rn(d[j], dsilu(__fmaf_rn(xh[j], sc[j], bi[j])));
    }
  };

  // round 2: sums of dO*scale and dO*scale*x̂ per thread, of dO*x̂ and dO per channel
  float g1 = 0.f, g2 = 0.f, dsc[V], dbi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) dsc[j] = dbi[j] = 0.f;
  auto accumulate = [&](const T* xsrc, const T* dsrc, int64_t i) {
    float xh[V], d[V];
    grads(xsrc, dsrc, i, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gsc = __fmul_rn(d[j], sc[j]);
      g1 = __fadd_rn(g1, gsc);
      g2 = __fmaf_rn(gsc, xh[j], g2);
      dsc[j] = __fmaf_rn(d[j], xh[j], dsc[j]);
      dbi[j] = __fadd_rn(dbi[j], d[j]);
    }
  };
  for (int64_t i = (int64_t)t * V; i < res; i += step) accumulate(xs, dys, i);
  for (int64_t i = res + (int64_t)t * V; i < span; i += step) accumulate(xg, dyg, i);
  s_a[t] = g1;
  s_b[t] = g2;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_chan[t * V + j] = dsc[j];
    s_chan[(nt + t) * V + j] = dbi[j];
  }
  __syncthreads();
  push_partials(s_a, s_b, s_p2, bar2, rank, p.n, C, G, V, nt, t);

  // this block's per-channel sums: threads k * C/V + c/V hold channel c, summed in k
  // order. K2 writes them as the block's partial; K1 leaves them in place of thread 0's
  // term (s_chan[which * T * V + cc], which no other channel's sum reads) for the cluster
  // to sum, or writes them where the cluster is one block.
  {
    const int cv = C / V, steps_px = nt / cv;
    float* out = kFilm ? a.part + (int64_t)b * 2 * C : a.part + ((int64_t)b * p.n + rank) * 2 * C;
    for (int c = t; c < 2 * C; c += nt) {
      const int which = c / C, cc = c - which * C;
      float* src = s_chan + (int64_t)which * nt * V + cc;
      float s = 0.f;
      for (int k = 0; k < steps_px; ++k) s = __fadd_rn(s, src[(int64_t)k * cv * V]);
      if (!kFilm || p.n == 1) {
        out[c] = s;
      } else {
        src[0] = s;
      }
    }
  }
  if (kFilm && p.n > 1) {  // the sample's FiLM gradient: rank r sums channels r, r + n, ...
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's sums are in its shared memory
    float* out = a.part + (int64_t)b * 2 * C;
    for (int c = rank + p.n * t; c < 2 * C; c += p.n * nt) {
      const int which = c / C, cc = c - which * C;
      float* mine = s_chan + (int64_t)which * nt * V + cc;
      float s = 0.f;
      for (int r = 0; r < p.n; ++r) s = __fadd_rn(s, *cluster.map_shared_rank(mine, r));
      out[c] = s;
    }
  }

  if (p.n == 1) __syncthreads();
  if (t < G) {
    if (p.n > 1) mbar_wait_cluster(bar2, 0);
    float s = 0.f, q = 0.f;
    for (int r = 0; r < p.n; ++r) {
      s = __fadd_rn(s, s_p2[2 * (r * G + t)]);
      q = __fadd_rn(q, s_p2[2 * (r * G + t) + 1]);
    }
    const float count = static_cast<float>((int64_t)p.HW * gs);
    s_m1[t] = __fdiv_rn(s, count);
    s_m2[t] = __fdiv_rn(q, count);
  }
  __syncthreads();

  // dx = inv * (dO*scale - mean(dO*scale) - x̂ * mean(dO*scale*x̂))
  const float m1 = s_m1[c0 / gs], m2 = s_m2[c0 / gs];
  auto apply = [&](const T* xsrc, const T* dsrc, int64_t i) {
    float xh[V], d[V];
    grads(xsrc, dsrc, i, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j)
      d[j] = __fmul_rn(inv, __fsub_rn(__fsub_rn(__fmul_rn(d[j], sc[j]), m1), __fmul_rn(xh[j], m2)));
    store_vec(dxg + i, d);
  };
  for (int64_t i = (int64_t)t * V; i < res; i += step) apply(xs, dys, i);
  for (int64_t i = res + (int64_t)t * V; i < span; i += step) apply(xg, dyg, i);
  if (kFilm && p.n > 1) cg::this_cluster().sync();  // no block's sums vanish before they are read
}

// out[j] = sum over rows r = 0, 1, ... of part[r][j], in that order: dscale (j < C) and
// dbias (j >= C) from the blocks' partials.
__global__ void gn_bwd_reduce(const float* __restrict__ part, int rows, int width,
                              float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s = __fadd_rn(s, part[(int64_t)r * width + j]);
  out[j] = s;
}

template <typename T, bool kFilm>
cudaError_t gn_bwd_set_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = gn_bwd_cluster_kernel<T, kFilm>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDynamic);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return e;
}

template <typename T, bool kFilm>
int launch_gn_bwd(const GnBwdArgs& a, float* dsb, const NormPlan& p, cudaStream_t st) {
  if (!norm_bwd_plan_ok(p, sizeof(T))) return (int)cudaErrorInvalidValue;
  cudaError_t e = gn_bwd_set_attributes<T, kFilm>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_config(p, &attr, st);
  e = cudaLaunchKernelEx(&cfg, gn_bwd_cluster_kernel<T, kFilm>, a, p);
  if (e != cudaSuccess) return (int)e;
  if (kFilm) return (int)cudaGetLastError();
  const int width = 2 * p.C;
  gn_bwd_reduce<<<(width + 255) / 256, 256, 0, st>>>(a.part, p.B * p.n, width, dsb);
  return (int)cudaGetLastError();
}

template <typename T, bool kFilm>
int max_clusters_gn_bwd(const NormPlan& p) {
  if (!norm_bwd_plan_ok(p, sizeof(T))) return -(int)cudaErrorInvalidValue;
  cudaError_t e = gn_bwd_set_attributes<T, kFilm>();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_config(p, &attr, 0);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, gn_bwd_cluster_kernel<T, kFilm>, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

template <bool kFilm>
int dispatch_gn_bwd(const GnBwdArgs& a, float* out, const NormPlan& p, cudaStream_t st) {
  if (p.elem_bytes == 4) return launch_gn_bwd<float, kFilm>(a, out, p, st);
  if (p.elem_bytes == 2) return launch_gn_bwd<__nv_bfloat16, kFilm>(a, out, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: (B, H, W, C) of the plan's dtype (elem_bytes); scale, bias: (C,) of
// aff_dtype (0 float32, 1 bfloat16); part: (B * n, 2, C) f32 scratch; dsb: (2, C) f32,
// dscale then dbias. plan: ops/norm_plan.py bwd_plan's ints. Two launches: the cluster
// kernel, then the fixed-order sum of the partials.
extern "C" int groupnorm_silu_bwd(const void* x, const void* dy, const void* scale,
                                  const void* bias, int aff_dtype, void* dx, void* part,
                                  void* dsb, int silu, const int* plan, void* stream) {
  const NormPlan p = read_norm_plan(plan);
  const GnBwdArgs a{x, dy, dx, scale, bias, aff_dtype, silu, static_cast<float*>(part)};
  return dispatch_gn_bwd<false>(a, static_cast<float*>(dsb), p,
                                static_cast<cudaStream_t>(stream));
}

// K1's backward. x, dy, dx: (B, H, W, C) of the plan's dtype; scale_shift: (B, 2C) FiLM
// rows of aff_dtype (0 float32, 1 bfloat16), scale then shift; dss: (B, 2C) f32, their
// gradient. plan: ops/norm_plan.py bwd_plan's ints. One launch.
extern "C" int adagn_silu_bwd(const void* x, const void* dy, const void* scale_shift,
                              int aff_dtype, void* dx, void* dss, int silu, const int* plan,
                              void* stream) {
  const NormPlan p = read_norm_plan(plan);
  const void* shift = static_cast<const char*>(scale_shift) + (int64_t)p.C * (aff_dtype ? 2 : 4);
  const GnBwdArgs a{x, dy, dx, scale_shift, shift, aff_dtype, silu, static_cast<float*>(dss)};
  return dispatch_gn_bwd<true>(a, nullptr, p, static_cast<cudaStream_t>(stream));
}

// The clusters of the backward plan (film: K1's kernel, else K2's) the current card can
// run at once (0: it cannot place one), or a negative CUDA error code.
extern "C" int gn_bwd_max_clusters(const int* plan, int film) {
  const NormPlan p = read_norm_plan(plan);
  if (p.elem_bytes == 4)
    return film ? max_clusters_gn_bwd<float, true>(p) : max_clusters_gn_bwd<float, false>(p);
  if (p.elem_bytes == 2)
    return film ? max_clusters_gn_bwd<__nv_bfloat16, true>(p)
                : max_clusters_gn_bwd<__nv_bfloat16, false>(p);
  return -(int)cudaErrorInvalidValue;
}
