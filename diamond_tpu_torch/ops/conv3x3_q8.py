"""Int8 3x3 convolution, NHWC activations, stride 1 or 2 (K5).

Counterpart of the conv in diamond_tpu/ops/quant.py::conv3x3_q8_static and
ops/fused_q8.py::conv3x3_qtensor, which XLA computes on the TPU's int8 MXU. On a CUDA
tensor ``conv3x3_int8`` launches the hand-written kernel in ``kernels/csrc/
conv3x3_q8.cu``; on a CPU tensor it runs ``conv3x3_int8_plain``, the same contract
with the int8 sums taken exactly in float64.

The A operand is int8 codes, or bf16/f32 values quantized as they are loaded with the
static scale s_c = max(act_max, 1e-8) * 1.05 / 127 of their channel (``quantize_static``).
A call takes one of two routes, chosen from its shape by ``conv_plan.k5_route``: the
pipeline (``kernels/csrc/conv_pipe.cuh``: TMA copies into a ring, a producer warpgroup, up
to four consumer warpgroups) where it has at least ``conv_plan.PIPE_MIN_M`` output pixels
and its shape allows it, else the halo-tile wgmma kernel (``kernels/csrc/conv_halo.cuh``)
on the plan of ``conv_plan.k5_plan``. The two give the same bits. Cin that is not a
multiple of 32 is zero-padded in both. The kernels read the weights as
``kmajor_weights(w_q)``, which the int8 sites make once when their collection is
installed (``quant.install``, the ``w_k`` buffer) and the wrapper otherwise makes per
call. The epilogue is f32(acc) * w_scale[n] (times sample_scale[b] for a QTensor), then
in ``out_dtype`` plus the bias rounded to ``out_dtype``.

``conv3x3_int8.launches`` counts kernel launches, ``conv3x3_int8.routes`` the launches
of each route ("halo", "pipe") and ``conv3x3_int8.shapes`` the call signatures.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .conv_plan import channels_padded, k5_route

# Calibration records the exact observed max; the run-time distribution gets a little
# room (diamond_tpu/ops/quant.py; kernels/csrc/q8_common.cuh static_scale).
ACT_SCALE_HEADROOM = 1.05
_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def true_div(t: torch.Tensor, d: float) -> torch.Tensor:
    """t / d by IEEE division on every device: on the card PyTorch divides by a Python
    scalar as a multiply by its reciprocal, which moves round-half cases of the int8
    codes; a 0-dim tensor on t's device takes the true division."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a forward-only int8 wrapper would cut the autograd graph: under grad
    mode, an input of its CUDA call needs a gradient. The int8 path serves inference
    only (the rollout runs it under no grad); training runs the bf16 kernels."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: int8 inference only, it has no gradient; an input "
                           "needs one under grad mode (call it under torch.no_grad())")


def static_scale(act_max: torch.Tensor) -> torch.Tensor:
    """s_c = max(act_max, 1e-8) * ACT_SCALE_HEADROOM / 127 in f32, in that order."""
    return true_div(torch.clamp_min(act_max.float(), 1e-8) * ACT_SCALE_HEADROOM, 127.0)


def quantize_static(x: torch.Tensor, act_max: torch.Tensor) -> torch.Tensor:
    """int8 codes clip(round(x / s_c), +-127) of x (..., C) with the static scales of
    act_max (C,); round half to even, a true division."""
    return torch.clamp(torch.round(x.float() / static_scale(act_max)), -127, 127).to(torch.int8)


def kmajor_weights(w_q: torch.Tensor) -> torch.Tensor:
    """The K-major copy of w_q (3, 3, Cin, Cout) the int8 wgmma reads: row n holds
    w_q[ky, kx, ci, n] at column (3 ky + kx) * cpad + ci, with Cin zero-padded to cpad
    (one s8 wgmma K step, 32) and the rows to a multiple of 8; (round8(Cout), 9 * cpad)
    int8, contiguous."""
    cin, cout = w_q.shape[2], w_q.shape[3]
    wk = F.pad(w_q.permute(3, 0, 1, 2), (0, channels_padded(cin, 1) - cin))
    wk = wk.reshape(cout, -1)
    return F.pad(wk, (0, 0, 0, -cout % 8)).contiguous()


def conv3x3_int8_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       act_max: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None, stride: int = 1,
                       out_dtype: torch.dtype = torch.float32,
                       sample_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, Cin) int8 codes, or float quantized with ``act_max`` (Cin,); w_q
    (3, 3, Cin, Cout) int8; w_scale (Cout,) f32; sample_scale (B, 1) or None; bias
    (Cout,) or None. -> (B, Ho, Wo, Cout) in ``out_dtype``."""
    xq = x if x.dtype == torch.int8 else quantize_static(x, act_max)
    acc = F.conv2d(xq.double().permute(0, 3, 1, 2), w_q.double().permute(3, 2, 0, 1),
                   stride=stride, padding=1).permute(0, 2, 3, 1).float()
    factor = w_scale.float()
    if sample_scale is not None:
        factor = sample_scale.float().reshape(-1, 1, 1, 1) * factor
    y = (acc * factor).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.contiguous()


def conv3x3_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 act_max: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                 stride: int = 1, out_dtype: torch.dtype = torch.float32,
                 sample_scale: Optional[torch.Tensor] = None,
                 w_k: Optional[torch.Tensor] = None, plan=None) -> torch.Tensor:
    """The int8 3x3 SAME conv of ``conv3x3_int8_plain``'s contract; ``w_k``:
    ``kmajor_weights(w_q)`` where the caller keeps it (else made here); ``plan``: a plan
    of this call's shape on either route (``conv_plan.k5_plan``, ``pipe_plan``) in place
    of ``k5_route``'s (tests and timings)."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, w_q, w_scale, act_max, bias, stride, out_dtype,
                                  sample_scale)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_int8: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _X_CODES or out_dtype not in _OUT_CODES:
        raise ValueError(f"conv3x3_int8: x (B, H, W, Cin) f32/bf16/int8 and out f32/bf16, "
                         f"got {tuple(x.shape)} {x.dtype} -> {out_dtype}")
    b, h, w, cin = x.shape
    if w_q.shape[:3] != (3, 3, cin) or w_q.dim() != 4 or w_q.dtype != torch.int8:
        raise ValueError(f"conv3x3_int8: w_q must be int8 (3, 3, {cin}, Cout), "
                         f"got {w_q.dtype} {tuple(w_q.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"conv3x3_int8: stride must be 1 or 2, got {stride}")
    cout = w_q.shape[-1]
    x = x.contiguous()
    if w_k is None:
        w_k = kmajor_weights(w_q)
    k_shape = (-(-cout // 8) * 8, 9 * channels_padded(cin, 1))
    if (tuple(w_k.shape) != k_shape or w_k.dtype != torch.int8 or w_k.device != x.device
            or not w_k.is_contiguous()):
        raise ValueError(f"conv3x3_int8: w_k must be int8 {k_shape} on {x.device}")
    if x.data_ptr() % 16 or w_k.data_ptr() % 16:
        raise ValueError("conv3x3_int8: x and w_k must be 16-byte aligned")
    if x.dtype != torch.int8:
        if act_max is None or act_max.shape != (cin,):
            raise ValueError(f"conv3x3_int8: a float x needs act_max ({cin},)")
        act_max = act_max.to(device=x.device, dtype=torch.float32).contiguous()

    def f32(t, shape, what):
        if t is None:
            return None
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"conv3x3_int8: {what} must be {shape} on {x.device}")
        return t.float().contiguous()

    w_scale = f32(w_scale, (cout,), "w_scale")
    bias = f32(bias, (cout,), "bias")
    if sample_scale is not None:
        sample_scale = f32(sample_scale.reshape(-1), (b,), "sample_scale")
    y = torch.empty((b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout), device=x.device,
                    dtype=out_dtype)
    if plan is None:
        plan = k5_route(b, h, w, cin, cout, stride, x.element_size(), y.element_size())
    lib = kernels.lib()
    launch = lib.conv3x3_q8_pipe_fwd if plan.route == "pipe" else lib.conv3x3_q8_fwd
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.check(launch(
        x.data_ptr(), _X_CODES[x.dtype], ptr(act_max), w_k.data_ptr(), w_scale.data_ptr(),
        ptr(sample_scale), ptr(bias), y.data_ptr(), _OUT_CODES[out_dtype], plan.c_ints,
        kernels.stream(x.device)), "conv3x3_int8")
    conv3x3_int8.launches += 1
    conv3x3_int8.routes[plan.route] += 1
    conv3x3_int8.shapes[(tuple(x.shape), str(x.dtype), cout, stride, bias is not None,
                         sample_scale is not None, str(out_dtype))] += 1
    return y


conv3x3_int8.launches = 0
conv3x3_int8.routes = Counter()
conv3x3_int8.shapes = Counter()
