"""The port's kernel-backed ops: a CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors (the counterparts of diamond_tpu/ops)."""

from .conv3x3 import (conv3x3, conv3x3_dgrad, conv3x3_dgrad_plain, conv3x3_dgrad_s2,
                      conv3x3_dgrad_s2_plain, conv3x3_plain, conv3x3_wgrad, conv3x3_wgrad_plain)
from .conv3x3_q8 import conv3x3_int8, conv3x3_int8_plain, kmajor_weights, quantize_static
from .fused_norms import (adagn_silu, adagn_silu_bwd, adagn_silu_bwd_plain, adagn_silu_plain,
                          adagn_silu_with_moments, group_moments, groupnorm_silu,
                          groupnorm_silu_bwd, groupnorm_silu_bwd_plain, groupnorm_silu_plain,
                          groupnorm_silu_with_moments)
from .fused_q8 import (QTensor, adagn_silu_q8, adagn_silu_q8_plain, code_flips,
                       conv3x3_qtensor, group_stats_channels, groupnorm_silu_q8,
                       groupnorm_silu_q8_plain, norm_affine_silu_q8, norm_affine_silu_q8_plain,
                       per_sample_code_flips, static_code_flips, ulp)
from .matmul_q8 import kmajor_2d, matmul_int8, matmul_int8_plain
from .quantize_q8 import absmax_quantize_q8, absmax_quantize_q8_plain
