"""Fused normalize + affine + SiLU + int8 quantize over NHWC activations (K4).

Counterpart of diamond_tpu/ops/fused_q8.py. On a CUDA tensor each wrapper launches the
hand-written Hopper kernel in ``kernels/csrc/fused_q8.cu``; on a CPU tensor it runs the
plain PyTorch version beside it. Two epilogues:

* ``norm_affine_silu_q8`` (per-sample scale, the Pallas kernel's contract):
  y = SiLU((x - mean_c) * inv_c * gamma + beta) in f32, s_b = max(max |y|, 1e-8) / 127
  per sample, q = clip(round(y / s_b), +-127) -> ``QTensor(q, scale (B, 1))``.
* ``adagn_silu_q8`` / ``groupnorm_silu_q8`` (static scale, the int8 rollout's fusion):
  the output of ``adagn_silu`` / ``groupnorm_silu`` with SiLU, rounded to x's dtype,
  quantized with the consuming conv's calibrated s_c (ops/quant.py): the int8 codes a
  quantized 3x3 conv reads, written by the norm instead of a bf16 tensor.

``group_stats_channels`` gives the per-channel GroupNorm statistics the per-sample
kernel takes, and ``conv3x3_qtensor`` convolves a QTensor through K5 (ops/conv3x3_q8.py)
with the per-sample scale in its epilogue.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and the call
signatures it launched with in ``<wrapper>.shapes``.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from .. import kernels
from .conv3x3_q8 import conv3x3_int8, quantize_static, true_div
from .fused_norms import (GN_EPS, _group_moments, _launch_shape, _on, adagn_silu_plain,
                          groupnorm_silu_plain)


class QTensor(NamedTuple):
    """Symmetric-quantized activation: int8 values, one scale per batch element."""

    q: torch.Tensor      # (B, H, W, C) int8
    scale: torch.Tensor  # (B, 1) float32; x ~ q * scale


# ---------------------------------------------------------------------------
# per-sample scale


def norm_affine_silu_q8_plain(x: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
                              gamma: torch.Tensor, beta: torch.Tensor) -> QTensor:
    row = lambda t: t.float()[:, None, None, :]  # noqa: E731
    y = (x.float() - row(mean_c)) * row(inv_c) * row(gamma) + row(beta)
    y = y * torch.sigmoid(y)
    s = true_div(torch.clamp_min(y.abs().amax(dim=(1, 2, 3)), 1e-8)[:, None], 127.0)
    q = torch.clamp(torch.round(y / s[:, :, None, None]), -127, 127).to(torch.int8)
    return QTensor(q, s)


def norm_affine_silu_q8(x: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor) -> QTensor:
    """QTensor of SiLU((x - mean_c) * inv_c * gamma + beta); x (B, H, W, C), the four
    others (B, C): the group statistics broadcast to channels, and the FiLM affine
    (1 + scale, shift) or GroupNorm's (scale, bias) repeated over B."""
    if x.device.type == "cpu":
        return norm_affine_silu_q8_plain(x, mean_c, inv_c, gamma, beta)
    threads, s, span = _launch_shape(x, 1, "norm_affine_silu_q8")
    b, h, w, c = x.shape
    rows = [_on(t, x) for t in (mean_c, inv_c, gamma, beta)]
    if any(tuple(t.shape) != (b, c) for t in rows):
        raise ValueError(f"norm_affine_silu_q8: mean_c, inv_c, gamma, beta must be ({b}, {c})")
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    scale = torch.empty((b, 1), device=x.device, dtype=torch.float32)
    amax = torch.empty((b,), device=x.device, dtype=torch.int32)
    kernels.check(kernels.lib().norm_affine_silu_q8_fwd(
        x.data_ptr(), *(t.data_ptr() for t in rows), q.data_ptr(), scale.data_ptr(),
        amax.data_ptr(), b, h * w, c, s, span, threads, kernels.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "norm_affine_silu_q8")
    norm_affine_silu_q8.launches += 1
    norm_affine_silu_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return QTensor(q, scale)


def group_stats_channels(x: torch.Tensor, num_groups: int, eps: float = GN_EPS):
    """(mean_c, inv_c), each (B, C): affine-free GroupNorm statistics (the norms' own,
    single-pass f32 moments per channel, then per group), broadcast to channels."""
    n, _, _, c = x.shape
    _, mean_c, inv_c = _group_moments(x, num_groups, eps)
    return mean_c.reshape(n, c), inv_c.reshape(n, c)


def conv3x3_qtensor(xq: QTensor, w: torch.Tensor, strides: int = 1) -> torch.Tensor:
    """3x3 SAME conv of a QTensor on int8 values, f32 out (caller adds bias): the weight
    is quantized per output channel here, and K5 rescales y = conv(q, w_q) *
    (scale_b * w_scale_c) in its epilogue."""
    w = w.float()
    sw = true_div(torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-8), 127.0)
    wq = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
    return conv3x3_int8(xq.q, wq, sw, stride=strides, sample_scale=xq.scale)


# ---------------------------------------------------------------------------
# static per-channel scale


def adagn_silu_q8_plain(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
                        act_max: torch.Tensor) -> torch.Tensor:
    return quantize_static(adagn_silu_plain(x, scale_shift, num_groups, True), act_max)


def groupnorm_silu_q8_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            num_groups: int, act_max: torch.Tensor) -> torch.Tensor:
    return quantize_static(groupnorm_silu_plain(x, scale, bias, num_groups, True), act_max)


def _act_max_on(act_max: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
    if act_max.shape != (x.shape[-1],):
        raise ValueError(f"{name}: act_max must be ({x.shape[-1]},)")
    return _on(act_max, x)


def adagn_silu_q8(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
                  act_max: torch.Tensor) -> torch.Tensor:
    """int8 codes of SiLU(GN(x) * (1 + scale) + shift) rounded to x's dtype, quantized
    with the static scales of act_max (C,): equal to
    ``quantize_static(adagn_silu(x, scale_shift, num_groups), act_max)``."""
    if x.device.type == "cpu":
        return adagn_silu_q8_plain(x, scale_shift, num_groups, act_max)
    threads, s, span = _launch_shape(x, num_groups, "adagn_silu_q8")
    b, h, w, c = x.shape
    if tuple(scale_shift.shape) != (b, 2 * c):
        raise ValueError(f"adagn_silu_q8: scale_shift must be ({b}, {2 * c})")
    ss, am = _on(scale_shift, x), _act_max_on(act_max, x, "adagn_silu_q8")
    partials = torch.empty((b, s, num_groups, 2), device=x.device, dtype=torch.float32)
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    kernels.check(kernels.lib().adagn_silu_q8_fwd(
        x.data_ptr(), ss.data_ptr(), am.data_ptr(), q.data_ptr(), b, h * w, c, num_groups,
        partials.data_ptr(), s, span, threads, kernels.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "adagn_silu_q8")
    adagn_silu_q8.launches += 1
    adagn_silu_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return q


def groupnorm_silu_q8(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      num_groups: int, act_max: torch.Tensor) -> torch.Tensor:
    """int8 codes of SiLU(GN(x) * scale + bias) rounded to x's dtype, quantized with the
    static scales of act_max (C,): equal to
    ``quantize_static(groupnorm_silu(x, scale, bias, num_groups), act_max)``."""
    if x.device.type == "cpu":
        return groupnorm_silu_q8_plain(x, scale, bias, num_groups, act_max)
    threads, s, span = _launch_shape(x, num_groups, "groupnorm_silu_q8")
    b, h, w, c = x.shape
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu_q8: scale and bias must be ({c},)")
    sc, bi = _on(scale, x), _on(bias, x)
    am = _act_max_on(act_max, x, "groupnorm_silu_q8")
    partials = torch.empty((b, s, num_groups, 2), device=x.device, dtype=torch.float32)
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    kernels.check(kernels.lib().groupnorm_silu_q8_fwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), am.data_ptr(), q.data_ptr(), b, h * w, c,
        num_groups, partials.data_ptr(), s, span, threads, kernels.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "groupnorm_silu_q8")
    groupnorm_silu_q8.launches += 1
    groupnorm_silu_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return q


for _fn in (norm_affine_silu_q8, adagn_silu_q8, groupnorm_silu_q8):
    _fn.launches = 0
    _fn.shapes = Counter()
