// The weight and bias gradients of the 3x3 SAME convolution (stride 1 or 2) over NHWC
// activations, for Hopper (sm_90a): K3's backward for its parameters.
//
// Replaces the weight half of the VJP that XLA derives for the JAX package's 3x3 convs
// (diamond_tpu/ops/conv3x3.py::conv3x3_im2col has no autodiff rule; the JAX blocks
// differentiate lax.conv). With dy the gradient of the output (B, Ho, Wo, Cout),
//   dW[ky, kx, ci, co] = sum over b, oy, ox of x[b, s*oy + ky - 1, s*ox + kx - 1, ci]
//                                               * dy[b, oy, ox, co]   (zero outside x),
//   db[co] = sum over b, oy, ox of dy[b, oy, ox, co]:
// an implicit GEMM with M = 9 * Cin rows (tap, ci), N = Cout, K = B * Ho * Wo pixels,
// neither operand stored, f32 sums.
//
// What bounds it: at the denoiser's shapes the bytes of x and dy and the products are
// close (64x64x64 -> 64 at B = 32: 33.6 MB, 10.0 µs at 3.35 TB/s, against 9.7 GFLOP,
// 9.8 µs at 989 TFLOP/s bf16); stride 2 needs a quarter of the stride-1 products; the
// 8x8-16x16 levels are bound by latency.
//
// Design (bf16):
//   * wgmma m64nNk16 bf16 -> f32, N = Cout padded to nt (8, 16, 32 or 64). A block of 3
//     warpgroups owns a channel group (cg <= 64 channels of Cin, padded to 16) and all
//     of its 9 * cg GEMM rows: the rows, in (tap, ci) order, make `mtiles` M-tiles of 64,
//     dealt to the warpgroups `mpw` each (M-tile wg + 3 j), so at Cin <= 32 one M-tile
//     holds several taps. dy leaves L2 once per channel group, not once per 16 channels.
//     Where too few K splits fill the card (small images), the M-tiles are shared out
//     over `mgroups` blocks instead, which adds blocks but no partials.
//   * A (64 rows (tap, ci) x 16 pixels) from registers: each warp loads its 16 rows with
//     one ldmatrix.x4.trans from the halo tile of x, at per-lane addresses: the lane's
//     8-channel chunk fixes its tap's shift, its pixel the row; rows past the group and
//     pixels past the tile read chunk 0 / pixel 0 (their rows are dropped, their dy rows
//     are zero). B (16 pixels x nt) is the dy tile in shared memory, read by wgmma
//     through a descriptor (N-major core matrices, read transposed), once per M-tile
//     rather than once per warp.
//   * Tiles are tr whole dy rows of one image (at most 256 pixels); a tile's halo is the
//     x rows and columns its windows read, (tr - 1) * s + 3 by (Wo - 1) * s + 3, with the
//     even columns stored before the odd ones at stride 2, so that neighbouring pixels
//     read neighbouring halo pixels. Stride 2 runs on dy as it is: no interleave, a
//     quarter of the stride-1 products.
//   * Pipelining: a persistent grid, one block per SM, `kblocks` per channel group, each
//     walking tiles kb, kb + kblocks, ...; the halo and dy of tile t + 1 are copied into
//     the second of two stage buffers while wgmma runs on tile t, and each K step's A
//     fragments load while the previous step's wgmma runs.
//   * The bias gradient in the same pass: the blocks of channel group 0 sum the columns
//     of every dy tile they hold, in f32 from shared memory, in a fixed order, while the
//     tile's last wgmma runs, and write one partial row each.
//   * The partials. The K splits' f32 partials (147 KB a block at Cin = Cout = 64) would
//     cost more device time to write and sum than the math: so `cluster` (2) blocks of
//     neighbouring K splits form a thread-block cluster, stage their accumulators in
//     shared memory, and each sums its share of the rows over the cluster's blocks in
//     rank order through distributed shared memory: one partial per cluster. A second
//     kernel sums those in order and rounds once: the same bits every run, no atomics.
//   * f32 (the parity runs): the same product on CUDA cores, 64 x 64 tiles of (tap, ci)
//     x Cout over a split of K, stride 1 or 2 read natively, A gathered per K step
//     (conv_common.cuh), the bias sums beside it, then the same fixed-order sum; no TF32
//     rounding.
// The plan (ops/conv_plan.py wgrad_plan) is computed by the wrapper and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_common.cuh"
#include "conv_halo.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWgs = 3;  // warpgroups per block
constexpr int kThreads = 128 * kWgs;

// The launch plan, in ops/conv_plan.py WGRAD_FIELDS order.
struct WgradPlan {
  int B, H, W, Cin, Cout, stride, Ho, Wo, cg, ngroups, mtiles, mpw, mgroups, nt, tr, tiles_y,
      tiles, ksteps, hr, hc, pxb, halo_bytes, dy_bytes, stages, cluster, kblocks, smem, grid;
};
constexpr int kWgradFields = 28;

inline WgradPlan read_wgrad_plan(const int* v) {
  WgradPlan p;
  int* dst = &p.B;
  for (int i = 0; i < kWgradFields; ++i) dst[i] = v[i];
  return p;
}

inline bool wgrad_plan_ok(const WgradPlan& p) {
  const int hr = (p.tr - 1) * p.stride + 3, hc = (p.Wo - 1) * p.stride + 3;
  const int halo = align128(hr * hc * p.pxb);
  const int dyb = (p.tr * p.Wo + 15) / 16 * 16 * p.nt * 2;
  // the stage buffers; then the block's accumulators, staged for the cluster's sum; the
  // bias sums' scratch
  const int stages = p.stages * (halo + dyb), staged = kWgs * p.mpw * 64 * (p.nt + 4) * 4;
  const int need = stages > staged ? stages : staged;
  const int smem = need > kThreads * 32 ? need : kThreads * 32;
  return p.B > 0 && p.H > 0 && p.W > 0 && p.Cin > 0 && p.Cout > 0 && p.Cout <= p.nt &&
         (p.stride == 1 || p.stride == 2) && p.Ho == (p.H - 1) / p.stride + 1 &&
         p.Wo == (p.W - 1) / p.stride + 1 &&
         (p.nt == 8 || p.nt == 16 || p.nt == 32 || p.nt == 64) && p.cg % 16 == 0 &&
         p.cg > 0 && p.cg <= 64 && p.ngroups * p.cg >= p.Cin && (p.ngroups - 1) * p.cg < p.Cin &&
         p.mtiles * 64 >= 9 * p.cg && p.mpw >= 1 && p.mpw <= 3 && p.mgroups >= 1 &&
         p.mgroups * kWgs * p.mpw >= p.mtiles && (p.mgroups - 1) * kWgs * p.mpw < p.mtiles &&
         p.tr >= 1 && p.tr <= p.Ho && p.tiles_y * p.tr >= p.Ho && p.tiles == p.B * p.tiles_y &&
         p.ksteps * 16 >= p.tr * p.Wo && (p.ksteps - 1) * 16 < p.tr * p.Wo && p.hr == hr &&
         p.hc == hc && p.pxb == p.cg * 2 + 16 && p.halo_bytes == halo && p.dy_bytes == dyb &&
         (p.stages == 1 || p.stages == 2) && (p.cluster == 1 || p.cluster == 2) &&
         p.kblocks % p.cluster == 0 && p.kblocks >= 1 && p.kblocks <= p.tiles &&
         p.smem == smem && p.smem <= kSmemLimit &&
         p.grid == p.ngroups * p.kblocks * p.mgroups;
}

// The address of this block's shared variable at local address a in cluster block rank r.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
// Every block of the cluster has arrived (its shared-memory writes released to the
// cluster) before any goes on.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// part: (kblocks / cluster * ngroups, rows = mgroups * 3 * MPW * 64, NT) f32: the
// partial of (kb / cluster, g) holds the rows (tap, ci - g * cg) = tap * cg + ci - g * cg,
// M-tile mt at rows 64 mt ..; pdb: (kblocks, NT) f32 or null. Blocks kb .. kb + cluster - 1
// (kb a multiple of cluster) of one (g, mg) form a thread-block cluster.
template <int NT, int MPW>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_wgrad_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    float* __restrict__ part, float* __restrict__ pdb, WgradPlan p) {
  constexpr int NQ = NT / 8;                    // core matrices across N
  constexpr uint32_t kStepDesc = NT * 32 / 16;  // one K step of dy in the descriptor
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = p.halo_bytes + p.dy_bytes;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int kb = blockIdx.x % p.kblocks, gm = blockIdx.x / p.kblocks;  // gm = g * mgroups + mg
  const int g = gm / p.mgroups, mg = gm - g * p.mgroups;
  const int c0 = g * p.cg, cpt = p.cg / 8;  // the group's first channel; chunks per tap
  const int half = (p.hc + 1) / 2;          // stride 2: even halo columns first
  const bool async_x = p.Cin % 8 == 0, async_dy = p.Cout % 8 == 0;
  const int ntiles = (p.tiles - kb + p.kblocks - 1) / p.kblocks;  // this block's tiles
  const bool bias = pdb != nullptr && g == 0 && mg == 0;

  // Tile t's halo of x and its dy into stage buffer buf: every thread issues the same
  // number of copies (one past the end repeats the last chunk), so the loops hold no
  // per-thread trip count or branch (either makes ptxas serialize the wgmma).
  auto load_tile = [&](int buf, int t) {
    const int b = t / p.tiles_y, y0 = (t - b * p.tiles_y) * p.tr;
    const int tile_px = min(p.tr, p.Ho - y0) * p.Wo;
    unsigned char* const h = smem + buf * stage_bytes;
    unsigned char* const d = h + p.halo_bytes;
    const bf16* xb = x + (int64_t)b * p.H * p.W * p.Cin;
    const int iy0 = y0 * p.stride - 1, total = p.hr * p.hc * cpt;
    for (int i0 = 0; i0 < total; i0 += kThreads) {
      const int i = min(i0 + tid, total - 1);
      const int px = i / cpt, ch = i - px * cpt, hy = px / p.hc, hx = px - hy * p.hc;
      const int iy = iy0 + hy, ix = hx - 1, c = c0 + ch * 8;
      const bool in = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int slot = p.stride == 1 ? hx : (hx & 1) * half + (hx >> 1);
      copy8(h + (hy * p.hc + slot) * p.pxb + ch * 16,
            xb + ((int64_t)iy * p.W + ix) * p.Cin + c, x, in ? min(8, p.Cin - c) : 0, async_x);
    }
    // dy pixel px, channels 8q .. 8q + 7 -> core matrix (px / 8, q), row px % 8; eight
    // neighbouring threads take the eight rows of one core matrix (distinct banks)
    const bf16* dyb = dy + ((int64_t)b * p.Ho + y0) * p.Wo * p.Cout;
    const int dtotal = p.ksteps * 16 * NQ;
    for (int i0 = 0; i0 < dtotal; i0 += kThreads) {
      const int i = min(i0 + tid, dtotal - 1);
      const int q = (i >> 3) % NQ, px = (i / (8 * NQ)) * 8 + (i & 7);
      copy8(d + ((px >> 3) * NQ + q) * 128 + (px & 7) * 16, dyb + (int64_t)px * p.Cout + q * 8,
            dy, px < tile_px ? min(8, p.Cout - q * 8) : 0, async_dy);
    }
  };
  // The bias sums of the dy tile in stage buffer buf (the rows past the tile are zero):
  // thread tid adds rows 8 c + r8 of column chunk q (c = ph, ph + nph, ...; r8 = tid % 8,
  // q = tid / 8 % NQ, ph = tid / (8 NQ)) to bsum, in that order.
  constexpr int kPhases = kThreads / (8 * NQ);
  float bsum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) bsum[e] = 0.f;
  auto bias_tile = [&](int buf) {
    const unsigned char* d = smem + buf * stage_bytes + p.halo_bytes;
    const int r8 = tid & 7, bq = (tid >> 3) % NQ, ph = tid / (8 * NQ), groups8 = p.ksteps * 2;
    for (int c0r = 0; c0r < groups8; c0r += kPhases) {
      const int c = c0r + ph;
      if (c < groups8) {
        const uint4 u = *reinterpret_cast<const uint4*>(d + (c * NQ + bq) * 128 + r8 * 16);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          bsum[2 * e] += f.x;
          bsum[2 * e + 1] += f.y;
        }
      }
    }
  };

  // This lane's ldmatrix row: matrix mi = lane / 8 holds rows (channel chunk mi & 1) of
  // pixels 8 (mi >> 1) + lane % 8. Per M-tile slot j (M-tile mt = mg * 3 * MPW + wg + 3 j):
  // the byte offset of its chunk's tap shift and channels in the halo (chunks past the
  // group read chunk 0).
  const int mi = lane >> 3, a_px = (mi >> 1) * 8 + (lane & 7);
  const int mt0 = mg * kWgs * MPW + wg;
  uint32_t soff[MPW];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    int chunk = (mt0 + kWgs * j) * 8 + warp * 2 + (mi & 1);
    if (chunk >= 9 * cpt) chunk = 0;
    const int tap = chunk / cpt, cc = chunk - tap * cpt, ky = tap / 3, kx = tap - ky * 3;
    const int koff = p.stride == 1 ? kx : (kx == 0 ? 0 : kx == 1 ? half : 1);
    soff[j] = (ky * p.hc + koff) * p.pxb + cc * 16;
  }

  float acc[MPW][NT / 2];
#pragma unroll
  for (int j = 0; j < MPW; ++j)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[j][i] = 0.f;

  if (p.stages == 2) load_tile(0, kb);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int buf = p.stages == 2 ? (it & 1) : 0, tile = kb + it * p.kblocks;
    if (p.stages == 2) {  // the next tile flies while this one is multiplied
      if (it + 1 < ntiles) load_tile(buf ^ 1, tile + p.kblocks);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      load_tile(0, tile);
      cp_async_commit();
      cp_async_wait<0>();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // dy -> wgmma
    __syncthreads();

    const int b = tile / p.tiles_y, y0 = (tile - b * p.tiles_y) * p.tr;
    const int tile_px = min(p.tr, p.Ho - y0) * p.Wo;
    unsigned char* const hbuf = smem + buf * stage_bytes;
    const uint32_t hbase = smem_u32(hbuf);
    const uint64_t desc0 = smem_desc(smem_u32(hbuf + p.halo_bytes), NT * 16, 128);
    // the A address of K step s, less the slot's offset
    auto pix_addr = [&](int s) -> uint32_t {
      int k = s * 16 + a_px;
      k = k < tile_px ? k : 0;
      const int py = k / p.Wo, px = k - py * p.Wo;
      return hbase + (py * p.stride * p.hc + px) * p.pxb;
    };
    // K steps in two register sets that alternate: a set is reloaded once the wgmma
    // group that read it has completed (wait_group 1 leaves just the newest in flight).
    uint32_t a0[MPW][4], a1[MPW][4];
    uint32_t pa = pix_addr(0);
#pragma unroll
    for (int j = 0; j < MPW; ++j) ldmatrix_x4_trans(a0[j], pa + soff[j]);
    for (int s = 0; s < p.ksteps; s += 2) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < MPW; ++j)
        Wgmma<float, NT>::run(acc[j], a0[j], desc0 + (uint64_t)s * kStepDesc);
      wgmma_commit();
      if (s + 1 < p.ksteps) {
        pa = pix_addr(s + 1);
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < MPW; ++j) ldmatrix_x4_trans(a1[j], pa + soff[j]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < MPW; ++j)
          Wgmma<float, NT>::run(acc[j], a1[j], desc0 + (uint64_t)(s + 1) * kStepDesc);
        wgmma_commit();
      }
      if (s + 2 < p.ksteps) {
        pa = pix_addr(s + 2);
        wgmma_wait<1>();
#pragma unroll
        for (int j = 0; j < MPW; ++j) ldmatrix_x4_trans(a0[j], pa + soff[j]);
      }
    }
    if (bias) bias_tile(buf);  // while the last wgmma runs
    wgmma_wait<0>();
    __syncthreads();  // every warpgroup is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < MPW; ++j)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) fence_operand(acc[j][i]);

  // Each warp stages its accumulators in this block's shared memory (rows (wg + 3 j) *
  // 64 + warp * 16 + lane / 4 and + 8, columns 8 jj + 2 (lane % 4); every row,
  // unconditionally: an accumulator read under a branch makes ptxas serialize the wgmma).
  constexpr int SRF = NT + 4;  // staged row stride, floats
  float* const stage = reinterpret_cast<float*>(smem);
  const int d_row = warp * 16 + (lane >> 2), d_col = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    float* const rows = stage + ((wg + kWgs * j) * 64 + d_row) * SRF + d_col;
#pragma unroll
    for (int jj = 0; jj < NT / 8; ++jj) {
      *reinterpret_cast<float2*>(rows + jj * 8) = make_float2(acc[j][4 * jj], acc[j][4 * jj + 1]);
      *reinterpret_cast<float2*>(rows + 8 * SRF + jj * 8) =
          make_float2(acc[j][4 * jj + 2], acc[j][4 * jj + 3]);
    }
  }

  // The partial: block rank r of the cluster sums its share of the staged rows over ranks
  // 0, 1, ... in that order, through distributed shared memory, and writes it once.
  cluster_sync();
  {
    constexpr int R = kWgs * MPW * 64, Q = NT / 4;  // the block's rows; float4s per row
    const int rank = kb % p.cluster, share = R / p.cluster;
    const uint32_t base = smem_u32(smem);
    float* const out = part + ((int64_t)(kb / p.cluster) * p.ngroups + g) * p.mgroups * R * NT +
                       (int64_t)mg * R * NT;
    for (int i = tid; i < share * Q; i += kThreads) {
      const int row = rank * share + i / Q, c4 = i % Q;
      const uint32_t a = base + (row * SRF + c4 * 4) * 4;
      float4 v = ld_cluster_f4(cluster_addr(a, 0));
      for (int q = 1; q < p.cluster; ++q) {
        const float4 u = ld_cluster_f4(cluster_addr(a, q));
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(out + (int64_t)row * NT + c4 * 4) = v;
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
  if (bias) {  // the bias row: each column's sums over phases and rows, in that order
    float* const red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[tid * 8 + e] = bsum[e];  // the staged rows are read
    __syncthreads();
    if (tid < NT) {
      const int q = tid / 8, e = tid % 8;
      float s = 0.f;
      for (int f = 0; f < kPhases; ++f)
        for (int r = 0; r < 8; ++r) s += red[((f * NQ + q) * 8 + r) * 8 + e];
      pdb[(int64_t)kb * NT + tid] = s;
    }
  }
}

// f32: 64 x 64 tiles of (tap, ci) x Cout on CUDA cores, K (dy pixels) split over
// gridDim.z; the blocks of the first row tile also sum dy's columns (pdb: (splits,
// Cout), or null).
constexpr int SBM = 64, SBN = 64, SBK = 16, kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
wgrad_f32_simt(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ part, float* __restrict__ pdb, ConvShape p,
               int64_t k_per_split) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * SBM, n0 = blockIdx.y * SBN;
  const int64_t k_begin = blockIdx.z * k_per_split;
  const int64_t k_end = k_begin + k_per_split < p.M ? k_begin + k_per_split : p.M;
  const bool bias = pdb != nullptr && blockIdx.x == 0 && ty == 0;
  float acc[4][4], dbs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += SBK) {
    // A[kk][m] = x at dy pixel k0 + kk's window, shifted by tap m / Cin, channel m % Cin
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
      if (bias)
#pragma unroll
        for (int j = 0; j < 4; ++j) dbs[j] += b[j];
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
  if (bias)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.Cout) pdb[(int64_t)blockIdx.z * p.Cout + n] = dbs[j];
    }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// dW[tap][ci][co] = sum over parts q = 0, 1, ... of the partial's row tap * cg + ci % cg
// of group ci / cg, in that order, rounded once to Out; then (pdb non-null) db[co] =
// sum over its dbparts rows q of pdb[q][co], f32. A part is `per` floats; a group
// `gstride`; a row `nstride`; a bias row `dbstride`. One output per thread: the sum is
// bound by the loads in flight, and fewer threads with wider loads measured slower.
template <typename Out>
__global__ void wgrad_reduce(const float* __restrict__ part, int parts, int64_t per, int cg,
                             int64_t gstride, int nstride, int cin, int cout,
                             Out* __restrict__ dw, const float* __restrict__ pdb, int dbparts,
                             int dbstride, float* __restrict__ db) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = 9LL * cin * cout;
  if (i < total) {
    const int co = (int)(i % cout), ci = (int)(i / cout % cin), tap = (int)(i / cout / cin);
    const int g = ci / cg;
    const float* src = part + g * gstride + (int64_t)(tap * cg + ci - g * cg) * nstride + co;
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s = __fadd_rn(s, src[q * per]);
    store_out(dw + i, s);
  } else if (pdb != nullptr && i < total + cout) {
    const int co = (int)(i - total);
    float s = 0.f;
    for (int q = 0; q < dbparts; ++q) s = __fadd_rn(s, pdb[(int64_t)q * dbstride + co]);
    db[co] = s;
  }
}

template <typename Out>
int launch_reduce(const float* part, int parts, int64_t per, int cg, int64_t gstride,
                  int nstride, int cin, int cout, Out* dw, const float* pdb, int dbparts,
                  int dbstride, float* db, cudaStream_t st) {
  const int64_t total = 9LL * cin * cout + (pdb != nullptr ? cout : 0);
  wgrad_reduce<Out><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, parts, per, cg, gstride, nstride, cin, cout, dw, pdb, dbparts, dbstride, db);
  return (int)cudaGetLastError();
}

template <int NT, int MPW>
int launch_wgrad(const bf16* x, const bf16* dy, float* part, float* pdb, const WgradPlan& p,
                 cudaStream_t st) {
  auto kernel = conv3x3_wgrad_wgmma<NT, MPW>;
  static int smem_set = 0;
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, dy, part, pdb, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NT>
int launch_wgrad_nt(const bf16* x, const bf16* dy, float* part, float* pdb, const WgradPlan& p,
                    cudaStream_t st) {
  switch (p.mpw) {
    case 1: return launch_wgrad<NT, 1>(x, dy, part, pdb, p, st);
    case 2: return launch_wgrad<NT, 2>(x, dy, part, pdb, p, st);
    case 3: return launch_wgrad<NT, 3>(x, dy, part, pdb, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: x (B, H, W, Cin), dy (B, Ho, Wo, Cout); part: (kblocks / cluster * ngroups,
// mgroups * 3 * mpw * 64, nt) f32
// scratch, pdb: (kblocks, nt) f32 scratch or null (no bias); dw (3, 3, Cin, Cout) bf16,
// db (Cout,) f32 or null; plan: ops/conv_plan.py wgrad_plan's ints.
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* dy, void* part, void* pdb,
                                  void* dw, void* db, const int* plan, void* stream) {
  const WgradPlan p = read_wgrad_plan(plan);
  if (!wgrad_plan_ok(p) || (pdb == nullptr) != (db == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  float* pt = static_cast<float*>(part);
  float* pb = static_cast<float*>(pdb);
  int e;
  switch (p.nt) {
    case 8: e = launch_wgrad_nt<8>(xb, dyb, pt, pb, p, st); break;
    case 16: e = launch_wgrad_nt<16>(xb, dyb, pt, pb, p, st); break;
    case 32: e = launch_wgrad_nt<32>(xb, dyb, pt, pb, p, st); break;
    case 64: e = launch_wgrad_nt<64>(xb, dyb, pt, pb, p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  const int64_t rows = (int64_t)p.mgroups * kWgs * p.mpw * 64;
  return launch_reduce(pt, p.kblocks / p.cluster, p.ngroups * rows * p.nt, p.cg, rows * p.nt,
                       p.nt, p.Cin, p.Cout, static_cast<bf16*>(dw), pb, p.kblocks, p.nt,
                       static_cast<float*>(db), st);
}

// f32: the same operands in float32; part: (splits, 9 * Cin, Cout) f32 scratch, pdb:
// (splits, Cout) or null, dw f32, db f32 or null; K (the B * Ho * Wo dy pixels) split
// into `splits` ranges of k_per_split pixels (a multiple of 16).
extern "C" int conv3x3_wgrad_f32(const void* x, const void* dy, void* part, void* pdb, void* dw,
                                 void* db, int B, int H, int W, int Cin, int Cout, int stride,
                                 int splits, int64_t k_per_split, void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const ConvShape p = conv_shape(B, H, W, Cin, Cout, stride);
  if (splits < 1 || k_per_split < 1 || k_per_split % SBK || (splits - 1) * k_per_split >= p.M ||
      splits * k_per_split < p.M || (pdb == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((p.K + SBM - 1) / SBM, (Cout + SBN - 1) / SBN, splits);
  wgrad_f32_simt<<<grid, kSimtThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(part),
      static_cast<float*>(pdb), p, k_per_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(static_cast<const float*>(part), splits, 9LL * Cin * Cout, Cin, 0, Cout,
                       Cin, Cout, static_cast<float*>(dw), static_cast<const float*>(pdb), splits,
                       Cout, static_cast<float*>(db), st);
}
