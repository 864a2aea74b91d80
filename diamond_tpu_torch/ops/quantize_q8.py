"""Per-tensor absmax int8 quantize of an activation (the activation side of K7).

Counterpart of the activation half of diamond_tpu/ops/quant.py::conv3x3_q8 (:212), the
dynamic-scale int8 3x3 conv, which XLA computes on the TPU: sx = max(max |x|, 1e-12) /
127 over the whole tensor, and q = clip(round(x / sx), +-127), rounded half to even
after a true division. ``quant.conv3x3_q8`` convolves the result through K5
(``fused_q8.conv3x3_qtensor``), which multiplies each int32 sum by (sx * sw[n]).

On a CUDA tensor ``absmax_quantize_q8`` launches the hand-written kernel in
``kernels/csrc/quantize_q8.cu`` (a max pass and a quantize pass; sx stays on the card);
on a CPU tensor it runs ``absmax_quantize_q8_plain``. Both return a ``QTensor`` whose
scale (B, 1) holds sx in every row, the per-sample scale K5's epilogue reads.

``absmax_quantize_q8.launches`` counts calls on the card, each of which launches the
kernel's two grids, and ``absmax_quantize_q8.shapes`` the call signatures.
"""

from __future__ import annotations

from collections import Counter

import torch

from .. import kernels
from .conv3x3_q8 import true_div
from .fused_q8 import QTensor

_MAX_PARTIALS = 1024  # kernels/csrc/quantize_q8.cu kMaxPartials


def absmax_quantize_q8_plain(x: torch.Tensor) -> QTensor:
    """x (B, ...) float -> QTensor(q int8 like x, scale (B, 1) f32, each row sx)."""
    xf = x.float()
    sx = true_div(torch.clamp_min(xf.abs().amax(), 1e-12), 127.0)
    q = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return QTensor(q, sx.expand(x.shape[0], 1).contiguous())


def absmax_quantize_q8(x: torch.Tensor) -> QTensor:
    """The per-tensor quantize of ``absmax_quantize_q8_plain``'s contract."""
    if x.device.type == "cpu":
        return absmax_quantize_q8_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"absmax_quantize_q8: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"absmax_quantize_q8: x must be a non-empty (B, ...) tensor, got "
                         f"{tuple(x.shape)}")
    code = kernels.dtype_code(x.dtype)
    x = x.contiguous()
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    scale = torch.empty((x.shape[0], 1), device=x.device, dtype=torch.float32)
    partial = torch.empty((_MAX_PARTIALS,), device=x.device, dtype=torch.float32)
    kernels.check(kernels.lib().absmax_quantize_q8_fwd(
        x.data_ptr(), code, x.numel(), partial.data_ptr(), q.data_ptr(), scale.data_ptr(),
        x.shape[0], kernels.stream(x.device)), "absmax_quantize_q8")
    absmax_quantize_q8.launches += 1
    absmax_quantize_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return QTensor(q, scale)


absmax_quantize_q8.launches = 0
absmax_quantize_q8.shapes = Counter()
