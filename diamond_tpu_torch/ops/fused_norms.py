"""Fused GroupNorm(+FiLM)+SiLU over NHWC activations.

Counterpart of diamond_tpu/ops/fused_norms.py (``fused_adagn_silu`` and
``fused_groupnorm_silu``, Pallas TPU kernels). On a CUDA tensor each wrapper launches
the hand-written Hopper kernel in ``kernels/csrc/fused_norms.cu`` (a statistics pass
split over spatial spans, then one apply pass; the source's note says what bounds it);
on a CPU tensor it runs the plain PyTorch version beside it, written to the JAX
package's formulas: f32 single-pass moments E[x^2] - E[x]^2 per group, eps 1e-5, one
rounding to x's dtype at the end.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and the call
signatures it launched with in ``<wrapper>.shapes``.
"""

from __future__ import annotations

from collections import Counter

import torch

from .. import kernels

GN_EPS = 1e-5
_MAX_THREADS = 256   # kernels/csrc/fused_norms.cu kMaxThreads
_MAX_GROUPS = 64     # kernels/csrc/fused_norms.cu kMaxGroups
_MAX_SPANS = 64
_ITERS_PER_SPAN = 4  # steps of threads * V elements per block and pass


def _group_moments(x: torch.Tensor, num_groups: int):
    """Per-channel broadcastable (mean, 1/std) of each group: diamond_tpu's
    ``_group_norm`` statistics (per-channel sums first, then groups)."""
    n, h, w, c = x.shape
    gs = c // num_groups
    x32 = x.float()
    s = x32.sum(dim=(1, 2))
    sq = (x32 * x32).sum(dim=(1, 2))
    cnt = float(h * w * gs)
    mean_g = s.reshape(n, num_groups, gs).sum(-1) / cnt
    var_g = sq.reshape(n, num_groups, gs).sum(-1) / cnt - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + GN_EPS)
    mean_c = mean_g[:, :, None].expand(n, num_groups, gs).reshape(n, 1, 1, c)
    inv_c = inv_g[:, :, None].expand(n, num_groups, gs).reshape(n, 1, 1, c)
    return x32, mean_c, inv_c


def groupnorm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, silu: bool = True) -> torch.Tensor:
    x32, mean_c, inv_c = _group_moments(x, num_groups)
    y = (x32 - mean_c) * inv_c
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def adagn_silu_plain(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
                     silu: bool = True) -> torch.Tensor:
    c = x.shape[-1]
    x32, mean_c, inv_c = _group_moments(x, num_groups)
    ss = scale_shift.float()[:, None, None, :]
    y = (x32 - mean_c) * inv_c
    y = y * (1.0 + ss[..., :c]) + ss[..., c:]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _launch_shape(x: torch.Tensor, num_groups: int, name: str):
    """(threads, S, span) of a launch over x, raising on what the kernel does not take.
    A block has ``threads`` threads, the largest multiple of C/V up to 256 (V = 16-byte
    vector width), so each thread keeps the same channels; each sample is cut into S
    contiguous spans of a whole number of threads*V-element steps."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, H, W, C) tensor")
    kernels.dtype_code(x.dtype)
    vec = 16 // x.element_size()
    _, h, w, c = x.shape
    threads = _MAX_THREADS // (c // vec) * (c // vec) if c % vec == 0 else 0
    if (not threads or c % num_groups or (c // num_groups) % vec
            or num_groups > _MAX_GROUPS or x.data_ptr() % 16):
        raise ValueError(f"{name}: unsupported C={c}, groups={num_groups} for {x.dtype}")
    step = threads * vec
    iters = -(-(h * w * c) // step)
    s = max(1, min(_MAX_SPANS, -(-iters // _ITERS_PER_SPAN)))
    return threads, s, -(-iters // s) * step


def _on(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.to(device=x.device, dtype=torch.float32).contiguous()


def adagn_silu(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
               silu: bool = True) -> torch.Tensor:
    """[SiLU](GN(x) * (1 + scale) + shift); x (B, H, W, C), scale_shift (B, 2C) is the
    FiLM projection of the conditioning vector, split at C."""
    if x.device.type == "cpu":
        return adagn_silu_plain(x, scale_shift, num_groups, silu)
    threads, s, span = _launch_shape(x, num_groups, "adagn_silu")
    b, h, w, c = x.shape
    if tuple(scale_shift.shape) != (b, 2 * c):
        raise ValueError(f"adagn_silu: scale_shift must be ({b}, {2 * c})")
    ss = _on(scale_shift, x)
    partials = torch.empty((b, s, num_groups, 2), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    kernels.check(kernels.lib().adagn_silu_fwd(
        x.data_ptr(), ss.data_ptr(), y.data_ptr(), b, h * w, c, num_groups, int(silu),
        partials.data_ptr(), s, span, threads, kernels.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "adagn_silu")
    adagn_silu.launches += 1
    adagn_silu.shapes[(tuple(x.shape), str(x.dtype), bool(silu))] += 1
    return y


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, silu: bool = True) -> torch.Tensor:
    """[SiLU](GN(x) * scale + bias); x (B, H, W, C), scale and bias (C,)."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, silu)
    threads, s, span = _launch_shape(x, num_groups, "groupnorm_silu")
    b, h, w, c = x.shape
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu: scale and bias must be ({c},)")
    sc, bi = _on(scale, x), _on(bias, x)
    partials = torch.empty((b, s, num_groups, 2), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    kernels.check(kernels.lib().groupnorm_silu_fwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), y.data_ptr(), b, h * w, c, num_groups,
        int(silu), partials.data_ptr(), s, span, threads, kernels.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream), "groupnorm_silu")
    groupnorm_silu.launches += 1
    groupnorm_silu.shapes[(tuple(x.shape), str(x.dtype), bool(silu))] += 1
    return y


adagn_silu.launches = 0
adagn_silu.shapes = Counter()
groupnorm_silu.launches = 0
groupnorm_silu.shapes = Counter()
