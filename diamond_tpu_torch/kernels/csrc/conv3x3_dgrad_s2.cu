// The data gradient of the stride-2 3x3 SAME convolution over NHWC activations, for
// Hopper (sm_90a): K3's backward for its input at stride 2 (the Downsample convs).
//
// Replaces the data half of the VJP that XLA derives for the JAX package's stride-2
// convs (lax.conv_general_dilated, window strides 2, padding ((1, 1), (1, 1))). With dy
// (B, Ho, Wo, Cout) the gradient of the output and w (3, 3, Cin, Cout),
//   dx[b, iy, ix, ci] = sum over taps with iy = 2 oy + ky - 1, ix = 2 ox + kx - 1 of
//                       sum over co of dy[b, oy, ox, co] * w[ky, kx, ci, co].
// dx row 2i takes tap ky = 1 from dy row i; row 2i + 1 takes ky = 0 from dy row i + 1 and
// ky = 2 from row i; columns the same. So the four parity classes (py, px) of dx use 1,
// 2, 2 and 4 taps, 9 in all (not the 36 of a stride-1 conv over the zero-interleaved dy):
// per class a GEMM with M = the class's pixels (on dy's grid), N = Cin, K = taps x Cout.
// The tap table is ops/conv_plan.py S2_TAPS; the plan carries it and s2_plan_ok checks it
// against s2_tap below.
//
// What bounds it: bytes (64x64x64 at B = 32: dy 4.2 MB read, dx 16.8 MB written, 6.3 µs
// at 3.35 TB/s, against 2.4 GFLOP, 2.4 µs at 989 TFLOP/s bf16); the small levels by
// latency.
//
// Design (bf16):
//   * A tile is tr whole rows of dy's grid (or tw pixels of one row), at most 128
//     pixels, 64 per warpgroup; its halo is dy's (tr + 1) x (tw + 1) pixels (zero past
//     the image), Cout padded to kpad, copied by 16-byte cp.async, in two stage buffers
//     where they fit, so the next tile's halo loads during this tile's math. The grid is
//     persistent: as many blocks as fit, a multiple of the N slices.
//   * A from registers: for a tap with dy offset (ro, co) each warp loads its 16 pixels'
//     rows with ldmatrix.x4 at the halo pixel (i + ro, j + co): the offsets, the ragged
//     edge and the tile's end are per-lane addresses. B from shared memory: the block's
//     slice of w (nt input channels), all 9 taps, held for every tile, as K-major core
//     matrices copied from the HWIO rows as they are (w[ky, kx, ci, :] is contiguous in
//     co = K), read by wgmma m64nNk16 without transposition: no flipped or transposed
//     copy of w.
//   * Per class: the accumulators (64 pixels x nt, f32) take its taps' products, K steps
//     in groups of 4 (64 channels of Cout) whose fragments alternate between two
//     register sets from tap to tap, so that one tap's ldmatrix overlaps the previous
//     tap's wgmma. Then each warp stages its rows as bf16 in shared memory (all of them,
//     unconditionally: an accumulator read under a branch makes ptxas serialize the
//     wgmma) and stores 16 bytes of dx at a time to the class's pixels (2i + py, 2j + px).
//   * f32 (the parity runs): one thread per dx element on CUDA cores, summing its class's
//     taps over Cout in a fixed order.
// The plan (ops/conv_plan.py dgrad_s2_plan) is computed by the wrapper and checked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_halo.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kS2Wgs = 2;  // warpgroups per block
constexpr int kS2Threads = 128 * kS2Wgs;

// Per parity class c of (0, 0), (0, 1), (1, 0), (1, 1): its first entry in the tap
// table and its count; entry e, field k of the table: (dy row offset, dy column offset,
// ky, kx). Functions, so that device code folds them where the indices are constants.
__host__ __device__ constexpr int class_start(int c) { return c == 0 ? 0 : c == 1 ? 1 : c == 2 ? 3 : 5; }
__host__ __device__ constexpr int class_taps(int c) { return c == 0 ? 1 : c == 3 ? 4 : 2; }
__host__ __device__ constexpr int s2_tap(int e, int k) {
  constexpr int t[9][4] = {{0, 0, 1, 1},                              // (0, 0)
                           {0, 1, 1, 0}, {0, 0, 1, 2},                // (0, 1)
                           {1, 0, 0, 1}, {0, 0, 2, 1},                // (1, 0)
                           {1, 1, 0, 0}, {1, 0, 0, 2}, {0, 1, 2, 0}, {0, 0, 2, 2}};  // (1, 1)
  return t[e][k];
}

// The launch plan, in ops/conv_plan.py S2_FIELDS order, then the tap table.
struct S2Plan {
  int B, H, W, Cin, Cout, Ho, Wo, kpad, nt, nslices, tr, tw, hr, hc, pxb, stages;
  int tiles_y, tiles_x, tiles, w_bytes, halo_bytes, smem, grid;
  int taps[36];
};
constexpr int kS2Fields = 23 + 36;

inline S2Plan read_s2_plan(const int* v) {
  S2Plan p;
  int* dst = &p.B;
  for (int i = 0; i < kS2Fields; ++i) dst[i] = v[i];
  return p;
}

inline int s2_smem(const S2Plan& p) {
  return 9 * p.kpad * p.nt * 2 + p.stages * align128(p.hr * p.hc * p.pxb) +
         4 * kS2Wgs * 16 * (p.nt * 2 + 16);
}

inline bool s2_plan_ok(const S2Plan& p) {
  for (int e = 0; e < 9; ++e)
    for (int k = 0; k < 4; ++k)
      if (p.taps[4 * e + k] != s2_tap(e, k)) return false;
  return p.B > 0 && p.Cin > 0 && p.Cout > 0 && p.Ho == (p.H - 1) / 2 + 1 &&
         p.Wo == (p.W - 1) / 2 + 1 && p.kpad % 16 == 0 && p.kpad >= p.Cout &&
         p.kpad < p.Cout + 16 && (p.nt == 8 || p.nt == 16 || p.nt == 32 || p.nt == 64) &&
         p.nslices * p.nt >= p.Cin && p.tr * p.tw <= 64 * kS2Wgs &&
         (p.tw == p.Wo || p.tr == 1) && p.hr == p.tr + 1 && p.hc == p.tw + 1 &&
         p.pxb == p.kpad * 2 + 16 && (p.stages == 1 || p.stages == 2) &&
         p.tiles_y * p.tr >= p.Ho && p.tiles_x * p.tw >= p.Wo &&
         p.tiles == p.B * p.tiles_y * p.tiles_x && p.grid % p.nslices == 0 && p.grid > 0 &&
         p.w_bytes == 9 * p.kpad * p.nt * 2 && p.halo_bytes == align128(p.hr * p.hc * p.pxb) &&
         p.smem == s2_smem(p) && p.smem <= kSmemLimit;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return reinterpret_cast<const uint32_t&>(v);
}

template <int NT>
__global__ void __launch_bounds__(kS2Threads, 2)
conv3x3_dgrad_s2_wgmma(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                       bf16* __restrict__ dx, S2Plan p) {
  constexpr int NQ = NT / 8;   // core matrices across N
  constexpr int G = 4;         // K steps per group: 64 channels of Cout
  constexpr int SR = NT * 2 + 16;  // staged row stride, bytes
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const halo0 = smem + p.w_bytes;
  unsigned char* const staging = halo0 + p.stages * p.halo_bytes;
  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % p.nslices) * NT;
  const int kch = p.kpad / 8;              // 8-channel chunks of a dy pixel / a w row
  const int tap_bytes = p.kpad * NT * 2;   // one tap of the weights
  const bool async_dy = p.Cout % 8 == 0;

  // Once per block, in the first copy group: the weights of this slice, tap by tap,
  // K-major: core matrix (k / 8, n / 8) holds rows n of 8 channels k.
  {
    const int total = 9 * kch * NT;
    for (int i0 = 0; i0 < total; i0 += kS2Threads) {
      const int i = i0 + tid;
      if (i < total) {
        const int n = i % NT, kc = i / NT % kch, tap = i / (NT * kch), ci = n0 + n;
        copy8(smem + tap * tap_bytes + (kc * NQ + n / 8) * 128 + (n % 8) * 16,
                 w + ((int64_t)tap * p.Cin + ci) * p.Cout + kc * 8, w,
                 ci < p.Cin ? min(8, p.Cout - kc * 8) : 0, async_dy);
      }
    }
  }

  const int per_image = p.tiles_y * p.tiles_x;
  // The halo of tile t into ring buffer buf: dy pixels (i0 + hy, j0 + hx), zero past the
  // image and in the channels past Cout.
  auto load_halo = [&](int buf, int t) {
    const int b = t / per_image, r = t - b * per_image, ty = r / p.tiles_x;
    const int i0 = ty * p.tr, j0 = (r - ty * p.tiles_x) * p.tw;
    unsigned char* const h = halo0 + buf * p.halo_bytes;
    const bf16* dyb = dy + (int64_t)b * p.Ho * p.Wo * p.Cout;
    const int total = p.hr * p.hc * kch;
    for (int k0 = 0; k0 < total; k0 += kS2Threads) {
      const int i = k0 + tid;
      if (i < total) {
        const int pix = i / kch, c = (i - pix * kch) * 8, hy = pix / p.hc, hx = pix - hy * p.hc;
        const int oy = i0 + hy, ox = j0 + hx;
        const bool in = oy < p.Ho && ox < p.Wo;
        copy8(h + pix * p.pxb + c * 2, dyb + ((int64_t)oy * p.Wo + ox) * p.Cout + c, dy,
                 in ? min(8, p.Cout - c) : 0, async_dy);
      }
    }
  };

  // This thread's place in the fragments.
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int a_row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row
  const int a_col = (lane >> 4) * 16;                                           // and byte
  const int spt = p.kpad / 16;  // K steps per tap
  const uint64_t b_desc0 = smem_desc(smem_u32(smem), NT * 16, 128);
  constexpr uint32_t kStepDesc = NT * 32 / 16;
  const uint32_t tap_desc = tap_bytes / 16;
  unsigned char* const stage = staging + (wg * 4 + warp) * 16 * SR;
  const int tile_step = gridDim.x / p.nslices;

  int tile = blockIdx.x / p.nslices;
  if (p.stages == 2 && tile < p.tiles) load_halo(0, tile);
  cp_async_commit();  // with the weights
  for (int it = 0; tile < p.tiles; tile += tile_step, ++it) {
    const int buf = p.stages == 2 ? (it & 1) : 0;
    if (p.stages == 2) {
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
    const int i0 = ty * p.tr, j0 = (r - ty * p.tiles_x) * p.tw;
    const int npix = p.tw == p.Wo ? min(p.tr, p.Ho - i0) * p.Wo : min(p.tw, p.Wo - j0);
    // Every warpgroup multiplies, also one whose rows lie past the tile (it reads pixel
    // 0 and stores nothing): a branch around wgmma makes ptxas serialize them.
    const int pr = a_row < npix ? a_row : 0, pi = pr / p.tw, pj = pr - pi * p.tw;
    const uint32_t a_pix =
        smem_u32(halo0 + buf * p.halo_bytes) + (pi * p.hc + pj) * p.pxb + a_col;

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int py = c >> 1, px = c & 1;
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int kc0 = 0; kc0 < spt; kc0 += G) {
        uint32_t a0[G][4], a1[G][4];
        // one tap: its K steps' fragments into set a, then their wgmma as one group
        auto tap_group = [&](uint32_t(&a)[G][4], int e) {
          const uint32_t a_tap =
              a_pix + (s2_tap(e, 0) * p.hc + s2_tap(e, 1)) * p.pxb + kc0 * 32;
          const uint64_t d_tap = b_desc0 + (uint64_t)(s2_tap(e, 2) * 3 + s2_tap(e, 3)) * tap_desc +
                                 (uint64_t)kc0 * kStepDesc;
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (kc0 + j < spt) ldmatrix_x4(a[j], a_tap + j * 32);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (kc0 + j < spt)
              Wgmma<float, NT, 0>::run(acc, a[j], d_tap + (uint64_t)j * kStepDesc);
          wgmma_commit();
        };
#pragma unroll
        for (int t = 0; t < class_taps(c); ++t) {
          // the set this tap reloads was last read by the newest group (t = 0: or by
          // none), else by the group before the newest
          if (t == 0)
            wgmma_wait<0>();
          else
            wgmma_wait<1>();
          if (t & 1)
            tap_group(a1, class_start(c) + t);
          else
            tap_group(a0, class_start(c) + t);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) fence_operand(acc[i]);

      // Stage this warp's 16 rows as bf16 (rows lane / 4 and + 8, columns 8 j + 2 (lane %
      // 4)), then store 16-byte chunks of dx at the class's pixels.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
          *reinterpret_cast<uint32_t*>(stage + ((lane >> 2) + 8 * i) * SR +
                                       (8 * j + (lane & 3) * 2) * 2) =
              pack_bf16x2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      __syncwarp();
      const int row0 = wg * 64 + warp * 16;
      for (int q = lane; q < 16 * NQ; q += 32) {
        const int rl = q / NQ, n = n0 + (q - rl * NQ) * 8, m = row0 + rl;
        const int ti = m / p.tw, tj = m - ti * p.tw;
        const int oy = 2 * (i0 + ti) + py, ox = 2 * (j0 + tj) + px;
        if (m < npix && oy < p.H && ox < p.W && n < p.Cin) {
          const unsigned char* src = stage + rl * SR + (n - n0) * 2;
          bf16* dst = dx + (((int64_t)b * p.H + oy) * p.W + ox) * p.Cin + n;
          if (p.Cin % 8 == 0) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            const bf16* s = reinterpret_cast<const bf16*>(src);
            for (int e = 0; e < 8 && n + e < p.Cin; ++e) dst[e] = s[e];
          }
        }
      }
      __syncwarp();  // the staging rows are free for the next class
    }
    __syncthreads();  // the buffer is free for the load after next
  }
  cp_async_wait<0>();
}

// f32: one thread per dx element (b, iy, ix, ci), its class's taps in table order, each
// over co in order.
__global__ void dgrad_s2_f32_simt(const float* __restrict__ dy, const float* __restrict__ w,
                                  float* __restrict__ dx, int B, int H, int W, int Cin, int Cout,
                                  int Ho, int Wo) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * H * W * Cin) return;
  const int ci = (int)(i % Cin);
  const int64_t pix = i / Cin;
  const int ix = (int)(pix % W), iy = (int)(pix / W % H), b = (int)(pix / W / H);
  const int c = (iy & 1) * 2 + (ix & 1), oi = iy >> 1, oj = ix >> 1;
  float s = 0.f;
  for (int t = 0; t < class_taps(c); ++t) {
    const int e = class_start(c) + t;
    const int oy = oi + s2_tap(e, 0), ox = oj + s2_tap(e, 1);
    if (oy >= Ho || ox >= Wo) continue;
    const float* d = dy + (((int64_t)b * Ho + oy) * Wo + ox) * Cout;
    const float* k = w + ((int64_t)(s2_tap(e, 2) * 3 + s2_tap(e, 3)) * Cin + ci) * Cout;
    for (int co = 0; co < Cout; ++co) s = fmaf(d[co], k[co], s);
  }
  dx[i] = s;
}

template <int NT>
int launch_s2(const bf16* dy, const bf16* w, bf16* dx, const S2Plan& p, cudaStream_t st) {
  auto kernel = conv3x3_dgrad_s2_wgmma<NT>;
  static int smem_set = 0;
  if (p.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  kernel<<<p.grid, kS2Threads, p.smem, st>>>(dy, w, dx, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: dy (B, Ho, Wo, Cout), w (3, 3, Cin, Cout), dx (B, H, W, Cin); plan: ops/conv_plan.py
// dgrad_s2_plan's ints and tap table.
extern "C" int conv3x3_dgrad_s2_bf16(const void* dy, const void* w, void* dx, const int* plan,
                                     void* stream) {
  const S2Plan p = read_s2_plan(plan);
  if (!s2_plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* d = static_cast<const bf16*>(dy);
  const bf16* k = static_cast<const bf16*>(w);
  bf16* o = static_cast<bf16*>(dx);
  switch (p.nt) {
    case 8: return launch_s2<8>(d, k, o, p, st);
    case 16: return launch_s2<16>(d, k, o, p, st);
    case 32: return launch_s2<32>(d, k, o, p, st);
    case 64: return launch_s2<64>(d, k, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32: the same operands in float32, dx (B, H, W, Cin) with Ho = (H - 1) / 2 + 1.
extern "C" int conv3x3_dgrad_s2_f32(const void* dy, const void* w, void* dx, int B, int H, int W,
                                    int Cin, int Cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * H * W * Cin;
  dgrad_s2_f32_simt<<<(unsigned)((total + 255) / 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w), static_cast<float*>(dx), B, H,
      W, Cin, Cout, (H - 1) / 2 + 1, (W - 1) / 2 + 1);
  return (int)cudaGetLastError();
}
