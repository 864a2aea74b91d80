"""The port's kernel-backed ops: a CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors (the counterparts of diamond_tpu/ops)."""

from .conv3x3 import conv3x3, conv3x3_plain
from .fused_norms import adagn_silu, adagn_silu_plain, groupnorm_silu, groupnorm_silu_plain
