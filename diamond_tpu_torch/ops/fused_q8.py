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
  quantized 3x3 conv reads, written by the norm instead of a bf16 tensor. K1/K2's
  kernel and launch plan (ops/norm_plan.py) with an int8 epilogue: one launch per call.

``group_stats_channels`` gives the per-channel GroupNorm statistics the per-sample
kernel takes, and ``conv3x3_qtensor`` convolves a QTensor through K5 (ops/conv3x3_q8.py)
with the per-sample scale in its epilogue.

The wrappers are forward-only: on CUDA tensors, under grad mode, they refuse an input
that needs a gradient (``conv3x3_q8.refuse_grad``) instead of cutting the graph.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and the call
signatures it launched with in ``<wrapper>.shapes``.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from .. import kernels
from .conv3x3_q8 import conv3x3_int8, quantize_static, refuse_grad, static_scale, true_div
from .fused_norms import (GN_EPS, _per_channel, adagn_silu_plain, affine_rows, group_moments,
                          groupnorm_silu_plain, launch_plan)

_MAX_THREADS = 256   # kernels/csrc/fused_q8.cu kSpanThreads
_MAX_SPANS = 64
_ITERS_PER_SPAN = 4  # steps of threads * V elements per block and pass


class QTensor(NamedTuple):
    """Symmetric-quantized activation: int8 values, one scale per batch element."""

    q: torch.Tensor      # (B, H, W, C) int8
    scale: torch.Tensor  # (B, 1) float32; x ~ q * scale


# ---------------------------------------------------------------------------
# per-sample scale


def _span_launch(x: torch.Tensor, name: str):
    """(threads, S, span) of the per-sample kernels' grid (S, B) over x, raising on what
    they do not take. A block has ``threads`` threads, the largest multiple of C/V up to
    256 (V = 16-byte vector width), so each thread keeps the same channels; each sample
    is cut into S contiguous spans of a whole number of threads*V-element steps."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, H, W, C) tensor")
    kernels.dtype_code(x.dtype)
    vec = 16 // x.element_size()
    _, h, w, c = x.shape
    threads = _MAX_THREADS // (c // vec) * (c // vec) if c % vec == 0 else 0
    if not threads or x.data_ptr() % 16:
        raise ValueError(f"{name}: unsupported C={c} for {x.dtype}")
    step = threads * vec
    iters = -(-(h * w * c) // step)
    s = max(1, min(_MAX_SPANS, -(-iters // _ITERS_PER_SPAN)))
    return threads, s, -(-iters // s) * step


def _on(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.to(device=x.device, dtype=torch.float32).contiguous()


def _norm_affine_silu_f32(x, mean_c, inv_c, gamma, beta) -> torch.Tensor:
    row = lambda t: t.float()[:, None, None, :]  # noqa: E731
    y = (x.float() - row(mean_c)) * row(inv_c) * row(gamma) + row(beta)
    return y * torch.sigmoid(y)


def norm_affine_silu_q8_plain(x: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
                              gamma: torch.Tensor, beta: torch.Tensor) -> QTensor:
    y = _norm_affine_silu_f32(x, mean_c, inv_c, gamma, beta)
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
    refuse_grad("norm_affine_silu_q8", x, mean_c, inv_c, gamma, beta)
    threads, s, span = _span_launch(x, "norm_affine_silu_q8")
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
        kernels.stream(x.device)), "norm_affine_silu_q8")
    norm_affine_silu_q8.launches += 1
    norm_affine_silu_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return QTensor(q, scale)


def group_stats_channels(x: torch.Tensor, num_groups: int, eps: float = GN_EPS):
    """(mean_c, inv_c), each (B, C): affine-free GroupNorm statistics (the norms' own,
    single-pass f32 moments per channel, then per group), broadcast to channels."""
    n, _, _, c = x.shape
    mean_c, inv_c = _per_channel(group_moments(x, num_groups, eps), c)
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
    refuse_grad("adagn_silu_q8", x, scale_shift)
    plan = launch_plan(x, num_groups, "adagn_silu_q8", q8=True)
    b, h, w, c = x.shape
    if tuple(scale_shift.shape) != (b, 2 * c):
        raise ValueError(f"adagn_silu_q8: scale_shift must be ({b}, {2 * c})")
    (ss,), code = affine_rows(x, "adagn_silu_q8", scale_shift)
    am = _act_max_on(act_max, x, "adagn_silu_q8")
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    kernels.check(kernels.lib().adagn_silu_q8_fwd(
        x.data_ptr(), ss.data_ptr(), code, am.data_ptr(), q.data_ptr(), plan.c_ints,
        kernels.stream(x.device)), "adagn_silu_q8")
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
    refuse_grad("groupnorm_silu_q8", x, scale, bias)
    plan = launch_plan(x, num_groups, "groupnorm_silu_q8", q8=True)
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu_q8: scale and bias must be ({c},)")
    (sc, bi), code = affine_rows(x, "groupnorm_silu_q8", scale, bias)
    am = _act_max_on(act_max, x, "groupnorm_silu_q8")
    q = torch.empty(x.shape, device=x.device, dtype=torch.int8)
    kernels.check(kernels.lib().groupnorm_silu_q8_fwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), code, am.data_ptr(), q.data_ptr(),
        plan.c_ints, kernels.stream(x.device)), "groupnorm_silu_q8")
    groupnorm_silu_q8.launches += 1
    groupnorm_silu_q8.shapes[(tuple(x.shape), str(x.dtype))] += 1
    return q


for _fn in (norm_affine_silu_q8, adagn_silu_q8, groupnorm_silu_q8):
    _fn.launches = 0
    _fn.shapes = Counter()


# -- holding codes to their plain version -------------------------------------------------


def ulp(y: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """One unit in the last place of each value of y in a float format with
    ``mantissa_bits`` stored mantissa bits (bf16 7, f32 23), as f32."""
    _, e = torch.frexp(y.float())
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 1 - mantissa_bits)


def code_flips(q: torch.Tensor, ref: torch.Tensor, y32: torch.Tensor, scale: torch.Tensor,
               unit: torch.Tensor) -> tuple:
    """Where a kernel's int8 codes q differ from its plain version's ref: (the largest
    difference, the number of elements that differ, their largest margin). An element's
    margin is the distance of the plain version's f32 value before quantization, y32,
    from the code boundary (k + 1/2) * scale between its two codes, in units of ``unit``
    (how far the kernel's own arithmetic may move that value: one ulp of the dtype it is
    rounded to). A margin of at most 1 means the codes differ only because the value lies
    at a rounding boundary. ``scale`` and ``unit`` broadcast to y32."""
    d = (q.int() - ref.int()).abs()
    flips = d > 0
    n = int(flips.sum())
    if n == 0:
        return 0, 0, 0.0
    k = torch.minimum(q.int(), ref.int())[flips].float()
    boundary = (k + 0.5) * scale.float().expand_as(y32)[flips]
    margin = (y32[flips] - boundary).abs() / unit.expand_as(y32)[flips]
    return int(d.max()), n, margin.max().item()


def static_code_flips(q: torch.Tensor, ref: torch.Tensor, plain, x: torch.Tensor, *rows,
                      act_max: torch.Tensor) -> tuple:
    """``code_flips`` of the static epilogue: ``plain`` (``adagn_silu_plain`` or
    ``groupnorm_silu_plain`` on x and ``rows``) gives the f32 value before it is rounded
    to x's dtype. The unit is one ulp of x's dtype at that value for bf16 x (K1/K2 round
    their f32 result once: one value at a bf16 rounding boundary goes the other way), and
    32 f32 ulps of the tensor's largest |value| for f32 x (the moments are summed in
    another order)."""
    y32 = plain(x.float(), *rows)
    unit = ulp(y32, 7) if x.dtype == torch.bfloat16 else 32 * ulp(y32.abs().amax(), 23)
    return code_flips(q, ref, y32, static_scale(act_max), unit)


def per_sample_code_flips(qt: QTensor, ref: QTensor, x: torch.Tensor, *rows) -> tuple:
    """``code_flips`` of the per-sample epilogue on x and its four ``rows``: the unit is
    32 f32 ulps of each sample's largest |value| (sums in another order) and the
    value's share of the scale's relative error (the kernel's own scale)."""
    y32 = _norm_affine_silu_f32(x, *rows)
    rel = ((qt.scale - ref.scale).abs() / ref.scale)[:, :, None, None]
    unit = 32 * ulp(y32.abs().amax(dim=(1, 2, 3), keepdim=True), 23) + y32.abs() * rel
    return code_flips(qt.q, ref.q, y32, ref.scale[:, :, None, None], unit)
