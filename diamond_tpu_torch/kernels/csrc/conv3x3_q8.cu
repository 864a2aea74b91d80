// Int8 3x3 convolution over NHWC activations as an implicit GEMM, for Hopper (sm_90a): K5.
//
// Replaces diamond_tpu/ops/quant.py::conv3x3_q8_static (and the conv of
// ops/fused_q8.py::conv3x3_qtensor), which XLA computes on the TPU's int8 MXU:
//   xq = clip(round(x / s_c), +-127) with the calibrated per-input-channel scale
//   s_c = max(act_max_c, 1e-8) * 1.05 / 127 (or x already int8),
//   acc = conv(xq, w_q) in int32,   y = f32(acc) * w_scale[n] [* sample_scale[b]].
//
// Epilogue, in the JAX package's order (quant.py:187, then .astype(dtype) at
// blocks.py:202, then + b.astype(dtype) at :210): f32(acc) with round-to-nearest-even
// (acc reaches 9 * 128 * 127^2 ~ 1.9e7 > 2^24 at Cin = 128, so the conversion rounds)
// times the f32 factor w_scale[n], or (sample_scale[b] * w_scale[n]) for a QTensor
// (fused_q8.py:104); in bf16 that product is rounded to bf16, the bias rounded to bf16
// is added and the sum rounded again; in f32 the bias is added to it. Every rounding is
// pinned by intrinsics, so no multiply-add is contracted.
//
// What bounds it: like K3 (conv3x3.cu) the bytes of x and y on the large levels and
// latency on the small ones; an int8 x is half the bytes of a bf16 one, and the int8
// tensor-core rate is twice the bf16 rate.
//
// Two routes, one epilogue (RescaleQ8), chosen per call from its shape on the host
// (ops/conv_plan.py k5_route); both give the same bits.
// * The pipeline (conv_pipe.cuh, entry conv3x3_q8_pipe_fwd), for the calls with at least
//   PIPE_MIN_M output pixels whose channels come in 16-byte chunks: TMA copies of each
//   tile's halo into a ring, a producer warpgroup that lays them out for wgmma (and
//   quantizes a float x), consumer warpgroups on wgmma with A and B in shared memory.
// * The halo kernel (conv_halo.cuh, entry conv3x3_q8_fwd), for every other call:
//   conv_halo.cuh's kernel with int8 halo tiles and weights, wgmma m64nNk32 s8 -> s32
//   (which takes only K-major B: the block transposes its w_q slice into K-major core
//   matrices once, as it loads it). x as int8 codes (K4's output) arrives by 16-byte
//   cp.async into a ring of halo buffers; bf16 or f32 x is quantized once per element as
//   it fills the int8 halo tile, to the code a true IEEE division by s_c gives (a
//   multiply by 1/s_c, and the division where the product lies near a rounding tie:
//   q8_common.cuh quantize_q8_rcp), with s_c and 1/s_c computed once per channel per
//   block. Cin that is not a multiple of 32 is zero-padded (code 0) in the halo tile and
//   the weights. The epilogue reads the per-sample scale once per tile (a tile lies in
//   one image) and rescales the int32 sums in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_halo.cuh"
#include "conv_pipe.cuh"
#include "q8_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The epilogue in Out (bf16 or f32): f32(acc) * factor, then the bias in Out.
template <typename O>
struct RescaleQ8 {
  using Acc = int;
  using Out = O;
  const float* w_scale;       // (Cout,)
  const float* sample_scale;  // (B,) or null
  const float* bias;          // (Cout,) or null
  Out* y;                     // (M, Cout)
  float ss;                   // this tile's sample scale

  __device__ __forceinline__ void begin(int b) {
    ss = sample_scale != nullptr ? sample_scale[b] : 1.f;
  }
  // convert in two halves, for a kernel that keeps its columns' factors in registers:
  // column n's w_scale and its bias as the sum takes it (f32, or rounded to bf16), once;
  // then a value from those.
  __device__ __forceinline__ float column_scale(int n) const { return w_scale[n]; }
  __device__ __forceinline__ float column_bias(int n) const {
    if (bias == nullptr) return 0.f;
    if constexpr (std::is_same<Out, float>::value) return bias[n];
    return __bfloat162float(__float2bfloat16_rn(bias[n]));
  }
  __device__ __forceinline__ Out apply(int acc, float scale, float b) const {
    const float factor = sample_scale != nullptr ? __fmul_rn(ss, scale) : scale;
    const float o = __fmul_rn(__int2float_rn(acc), factor);
    if constexpr (std::is_same<Out, float>::value) {
      return bias != nullptr ? __fadd_rn(o, b) : o;
    } else {
      const bf16 h = __float2bfloat16_rn(o);
      if (bias == nullptr) return h;
      return __float2bfloat16_rn(__fadd_rn(__bfloat162float(h), b));
    }
  }
  __device__ __forceinline__ Out convert(int n, int acc) const {
    return apply(acc, column_scale(n), column_bias(n));
  }
  // apply on two neighbouring columns, stored as one pair at dst (bf16: both rounded by
  // one conversion instruction, the same round-to-nearest-even as apply's).
  __device__ __forceinline__ void apply2(Out* dst, int a0, int a1, float s0, float s1,
                                         float b0, float b1) const {
    if (sample_scale != nullptr) s0 = __fmul_rn(ss, s0), s1 = __fmul_rn(ss, s1);
    const float o0 = __fmul_rn(__int2float_rn(a0), s0), o1 = __fmul_rn(__int2float_rn(a1), s1);
    if constexpr (std::is_same<Out, float>::value) {
      *reinterpret_cast<float2*>(dst) =
          bias != nullptr ? make_float2(__fadd_rn(o0, b0), __fadd_rn(o1, b1)) : make_float2(o0, o1);
    } else {
      __nv_bfloat162 h = __floats2bfloat162_rn(o0, o1);
      if (bias != nullptr) {
        const float2 f = __bfloat1622float2(h);
        h = __floats2bfloat162_rn(__fadd_rn(f.x, b0), __fadd_rn(f.y, b1));
      }
      *reinterpret_cast<__nv_bfloat162*>(dst) = h;
    }
  }
};

template <typename Out, typename X>
int launch_q8(const X* x, const void* act_max, const void* w_k, const void* w_scale,
              const void* sample_scale, const void* bias, void* y, const HaloPlan& p,
              cudaStream_t st) {
  const RescaleQ8<Out> ep{static_cast<const float*>(w_scale),
                          static_cast<const float*>(sample_scale),
                          static_cast<const float*>(bias), static_cast<Out*>(y), 1.f};
  return launch_halo(x, static_cast<const signed char*>(w_k), static_cast<const float*>(act_max),
                     ep, p, st);
}

template <typename Out, typename X>
int launch_pipe_q8(const X* x, const void* act_max, const void* w_k, const void* w_scale,
                   const void* sample_scale, const void* bias, void* y, const pipe::PipePlan& p,
                   cudaStream_t st) {
  const RescaleQ8<Out> ep{static_cast<const float*>(w_scale),
                          static_cast<const float*>(sample_scale),
                          static_cast<const float*>(bias), static_cast<Out*>(y), 1.f};
  return pipe::launch_pipe(x, static_cast<const signed char*>(w_k),
                           static_cast<const float*>(act_max), ep, p, st);
}

template <typename X>
int launch_q8_out(const X* x, int out_dtype, const void* act_max, const void* w_k,
                  const void* w_scale, const void* sample_scale, const void* bias, void* y,
                  const HaloPlan& p, cudaStream_t st) {
  if (out_dtype == 0)
    return launch_q8<float>(x, act_max, w_k, w_scale, sample_scale, bias, y, p, st);
  if (out_dtype == 1)
    return launch_q8<bf16>(x, act_max, w_k, w_scale, sample_scale, bias, y, p, st);
  return (int)cudaErrorInvalidValue;
}

template <typename X>
int launch_pipe_out(const X* x, int out_dtype, const void* act_max, const void* w_k,
                    const void* w_scale, const void* sample_scale, const void* bias, void* y,
                    const pipe::PipePlan& p, cudaStream_t st) {
  if (out_dtype == 0)
    return launch_pipe_q8<float>(x, act_max, w_k, w_scale, sample_scale, bias, y, p, st);
  if (out_dtype == 1)
    return launch_pipe_q8<bf16>(x, act_max, w_k, w_scale, sample_scale, bias, y, p, st);
  return (int)cudaErrorInvalidValue;
}


}  // namespace

// x: (B, H, W, Cin), x_dtype 0 float32, 1 bfloat16, 2 int8 (codes, act_max unused);
// act_max: (Cin,) f32; w_k: the K-major copy (round8(Cout), 9 * cpad) of w_q, int8
// (ops/conv3x3_q8.py kmajor_weights); w_scale: (Cout,) f32; sample_scale: (B,) f32 or
// null; bias: (Cout,) f32 or null; y: (B, Ho, Wo, Cout), out_dtype 0 float32, 1 bfloat16;
// plan: the launch plan's ints (ops/conv_plan.py PLAN_FIELDS).
extern "C" int conv3x3_q8_fwd(const void* x, int x_dtype, const void* act_max, const void* w_k,
                              const void* w_scale, const void* sample_scale, const void* bias,
                              void* y, int out_dtype, const int* plan, void* stream) {
  const HaloPlan p = read_plan(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_q8_out(static_cast<const float*>(x), out_dtype, act_max, w_k, w_scale,
                         sample_scale, bias, y, p, st);
  if (x_dtype == 1)
    return launch_q8_out(static_cast<const bf16*>(x), out_dtype, act_max, w_k, w_scale,
                         sample_scale, bias, y, p, st);
  if (x_dtype == 2)
    return launch_q8_out(static_cast<const signed char*>(x), out_dtype, act_max, w_k, w_scale,
                         sample_scale, bias, y, p, st);
  return (int)cudaErrorInvalidValue;
}

// The pipeline route (conv_pipe.cuh): the same arguments, plan ops/conv_plan.py PIPE_FIELDS.
extern "C" int conv3x3_q8_pipe_fwd(const void* x, int x_dtype, const void* act_max,
                                   const void* w_k, const void* w_scale, const void* sample_scale,
                                   const void* bias, void* y, int out_dtype, const int* plan,
                                   void* stream) {
  const pipe::PipePlan p = pipe::read_pipe_plan(plan);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_pipe_out(static_cast<const float*>(x), out_dtype, act_max, w_k, w_scale,
                           sample_scale, bias, y, p, st);
  if (x_dtype == 1)
    return launch_pipe_out(static_cast<const bf16*>(x), out_dtype, act_max, w_k, w_scale,
                           sample_scale, bias, y, p, st);
  if (x_dtype == 2)
    return launch_pipe_out(static_cast<const signed char*>(x), out_dtype, act_max, w_k, w_scale,
                           sample_scale, bias, y, p, st);
  return (int)cudaErrorInvalidValue;
}
