"""3x3 convolution, NHWC activations and HWIO kernels, stride 1 or 2.

Counterpart of diamond_tpu/ops/conv3x3.py::conv3x3_im2col (Pallas TPU kernel, stride 1,
no bias) and of the ``lax.conv_general_dilated`` calls the JAX package makes for every
3x3 conv (stride 2 included, padding ((1, 1), (1, 1))). On a CUDA tensor ``conv3x3``
launches the hand-written implicit-GEMM kernels in ``kernels/csrc/conv3x3.cu`` (f32
accumulation, the bias added to the f32 sum, one rounding to x's dtype); on a CPU tensor
it runs ``conv3x3_plain``, the same contract through ``F.conv2d`` in float32.

bf16 runs the halo-tile wgmma kernel (``kernels/csrc/conv_halo.cuh``) on the launch plan
of ``conv_plan.k3_plan`` for every shape, Cin = 3, 6 and 12 included (zero-padded to 16
channels in the kernel); f32 (the parity runs) runs the CUDA-core kernel.

``conv3x3.launches`` counts kernel launches and ``conv3x3.shapes`` the call signatures.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .conv_plan import k3_plan


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin), kernel (3, 3, Cin, Cout) -> (B, Ho, Wo, Cout) in x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1),
                 None if bias is None else bias.float(), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
            stride: int = 1) -> torch.Tensor:
    """3x3 SAME conv: x (B, H, W, Cin), kernel (3, 3, Cin, Cout) in x's dtype, bias
    (Cout,) or None. Output (B, (H-1)//stride+1, (W-1)//stride+1, Cout) in x's dtype."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous() or not kernel.is_contiguous():
        raise ValueError("conv3x3: x (B, H, W, Cin) and kernel must be contiguous")
    b, h, w, cin = x.shape
    if kernel.shape[:3] != (3, 3, cin) or kernel.dim() != 4:
        raise ValueError(f"conv3x3: kernel must be (3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise ValueError("conv3x3: kernel must have x's dtype and device")
    if stride not in (1, 2):
        raise ValueError(f"conv3x3: stride must be 1 or 2, got {stride}")
    code = kernels.dtype_code(x.dtype)
    cout = kernel.shape[-1]
    if code == 1 and (x.data_ptr() % 16 or kernel.data_ptr() % 16):
        raise ValueError("conv3x3: bf16 operands must be 16-byte aligned")
    if bias is not None:
        if bias.shape != (cout,) or bias.device != x.device:
            raise ValueError(f"conv3x3: bias must be ({cout},) on {x.device}")
        bias = bias.float().contiguous()
    y = torch.empty((b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout),
                    device=x.device, dtype=x.dtype)
    if code == 1 and cout % 8:  # the kernel copies weight rows in 16-byte pieces
        kernel = F.pad(kernel, (0, -cout % 8))
    ptrs = (x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if code == 1:
        code = kernels.lib().conv3x3_bf16_fwd(
            *ptrs, k3_plan(b, h, w, cin, cout, stride).c_ints, stream)
    else:
        code = kernels.lib().conv3x3_f32_fwd(*ptrs, b, h, w, cin, cout, stride, stream)
    kernels.check(code, "conv3x3")
    conv3x3.launches += 1
    conv3x3.shapes[(tuple(x.shape), cout, stride, bias is not None, str(x.dtype))] += 1
    return y


conv3x3.launches = 0
conv3x3.shapes = Counter()
