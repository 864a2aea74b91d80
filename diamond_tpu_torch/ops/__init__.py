"""The port's kernel-backed ops: a CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors (the counterparts of diamond_tpu/ops)."""

from .conv3x3 import conv3x3, conv3x3_plain
from .conv3x3_q8 import conv3x3_int8, conv3x3_int8_plain, quantize_static
from .fused_norms import adagn_silu, adagn_silu_plain, groupnorm_silu, groupnorm_silu_plain
from .fused_q8 import (QTensor, adagn_silu_q8, adagn_silu_q8_plain, conv3x3_qtensor,
                       group_stats_channels, groupnorm_silu_q8, groupnorm_silu_q8_plain,
                       norm_affine_silu_q8, norm_affine_silu_q8_plain)
