// Fused GroupNorm(+FiLM)+SiLU over NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernels of diamond_tpu/ops/fused_norms.py:
//   * fused_adagn_silu     (_adagn_silu_kernel): SiLU(GN(x) * (1 + scale_b) + shift_b)
//   * fused_groupnorm_silu (_gn_silu_kernel):    [SiLU](GN(x) * scale + bias)
// Groups hold C/G adjacent channels; statistics are the single-pass f32 moments
// mean = E[x], var = E[x^2] - E[x]^2 of diamond_tpu's _gn_stats_channels, eps 1e-5.
//
// What bounds it: bytes, and close behind them the element work. The Pallas kernel keeps
// one whole image in VMEM, so x leaves HBM once; a 64x64x128 bf16 image is 1 MB, more
// than one Hopper block's 227 KB of shared memory, so here a thread-block cluster of up
// to 16 blocks holds it, one launch per call, and the blocks exchange their partial
// moments through distributed shared memory. The kernel and its design are
// gn_common.cuh's gn_cluster_kernel; the launch plan is ops/norm_plan.py's. The wrapper
// (ops/fused_norms.py) checks C % V == 0, (C / G) % V == 0, G <= 64 and 16-byte
// aligned pointers.

#include "gn_common.cuh"

// scale_shift: (B, 2C), FiLM scale then shift; aff_dtype 0 float32, 1 bfloat16. x's dtype
// is the plan's (elem_bytes). moments: null, or (B, G, 2) f32 for each group's mean and
// 1/std (what the backward reads).
extern "C" int adagn_silu_fwd(const void* x, const void* scale_shift, int aff_dtype, void* y,
                              void* moments, int silu, const int* plan, void* stream) {
  const int C = plan[2];
  const size_t es = aff_dtype ? 2 : 4;
  const GnArgs a{x, y, scale_shift, static_cast<const char*>(scale_shift) + C * es, 2 * (int64_t)C,
                 aff_dtype, 1, silu, nullptr, static_cast<float*>(moments)};
  return dispatch_gn<false>(a, plan, stream);
}

// scale, bias: (C,), shared by every sample, both of aff_dtype; moments as above.
extern "C" int groupnorm_silu_fwd(const void* x, const void* scale, const void* bias,
                                  int aff_dtype, void* y, void* moments, int silu,
                                  const int* plan, void* stream) {
  const GnArgs a{x, y, scale, bias, 0, aff_dtype, 0, silu, nullptr,
                 static_cast<float*>(moments)};
  return dispatch_gn<false>(a, plan, stream);
}

// The clusters of the plan the current card can run at once (0: it cannot place one),
// or a negative CUDA error code.
extern "C" int gn_max_clusters(const int* plan) { return dispatch_max_clusters<false>(plan); }
