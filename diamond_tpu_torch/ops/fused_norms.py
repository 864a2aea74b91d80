"""Fused GroupNorm(+FiLM)+SiLU over NHWC activations.

Counterpart of diamond_tpu/ops/fused_norms.py (``fused_adagn_silu`` and
``fused_groupnorm_silu``, Pallas TPU kernels). On a CUDA tensor each wrapper launches
the hand-written Hopper kernel in ``kernels/csrc/fused_norms.cu`` (one launch per call:
one thread-block cluster per sample holds the image in shared memory, on the launch
plan of ``ops/norm_plan.py``; the source's note says what bounds it); on a CPU tensor it
runs the plain PyTorch version beside it, written to the JAX package's formulas: f32
single-pass moments E[x^2] - E[x]^2 per group, eps 1e-5, one rounding to x's dtype at
the end. The FiLM rows and the affine are read as they come, f32 or bf16.

Both are differentiable: where an input needs a gradient the forward also writes each
group's mean and 1/std (``*_with_moments``), and the backward is a kernel too,
``groupnorm_silu_bwd`` and ``adagn_silu_bwd`` (one template in ``kernels/csrc/gn_bwd.cu``,
on a launch plan of its own, ``norm_plan.bwd_plan``), which reads those moments: the VJPs
of the JAX package's ``_gn_silu_ref`` and ``_adagn_silu_ref`` (its custom_vjp backwards),
each beside its plain version (``groupnorm_silu_bwd_plain``, ``adagn_silu_bwd_plain``).
The gradients of the affine and of the FiLM rows come in their own dtype, as JAX's VJPs
give them.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and the call
signatures it launched with in ``<wrapper>.shapes``.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Optional

import torch

from .. import kernels
from .norm_plan import PORTABLE_CLUSTER, NormPlan, bwd_plan, norm_plan, plan_for

GN_EPS = 1e-5


def group_moments(x: torch.Tensor, num_groups: int, eps: float = GN_EPS) -> torch.Tensor:
    """(B, G, 2) f32: each sample's and group's mean and 1/std, diamond_tpu's
    ``_group_norm`` statistics (per-channel sums first, then groups; single-pass
    E[x^2] - E[x]^2): what the forward kernels write for the backward."""
    n, h, w, c = x.shape
    gs = c // num_groups
    x32 = x.float()
    s = x32.sum(dim=(1, 2))
    sq = (x32 * x32).sum(dim=(1, 2))
    cnt = float(h * w * gs)
    mean_g = s.reshape(n, num_groups, gs).sum(-1) / cnt
    var_g = sq.reshape(n, num_groups, gs).sum(-1) / cnt - mean_g * mean_g
    return torch.stack([mean_g, torch.rsqrt(var_g + eps)], dim=-1)


def _per_channel(moments: torch.Tensor, c: int):
    """(mean, 1/std) of (B, G, 2) moments, broadcast to (B, 1, 1, C)."""
    n, g, _ = moments.shape
    m = moments.float()[:, :, None, :].expand(n, g, c // g, 2).reshape(n, 1, 1, c, 2)
    return m[..., 0], m[..., 1]


def groupnorm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         num_groups: int, silu: bool = True, return_moments: bool = False):
    """[SiLU](GN(x) * scale + bias) in x's dtype; with ``return_moments`` also the
    (B, G, 2) f32 moments it normalized with."""
    moments = group_moments(x, num_groups)
    mean_c, inv_c = _per_channel(moments, x.shape[-1])
    y = (x.float() - mean_c) * inv_c
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return (y.to(x.dtype), moments) if return_moments else y.to(x.dtype)


def groupnorm_silu_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, num_groups: int, silu: bool = True,
                             moments: Optional[torch.Tensor] = None):
    """The VJP of ``groupnorm_silu_plain`` (the JAX package's ``_gn_silu_ref``) at x for
    the cotangent dy, written out in f32: (dx in x's dtype, dscale, dbias (C,) in the
    affine's dtype). ``moments``: the forward's (B, G, 2) mean and 1/std, else
    recomputed from x."""
    dx, xh, d = _norm_silu_grads(x, dy, scale.float(), bias.float(), num_groups, silu, moments)
    return (dx.to(x.dtype), (d * xh).sum(dim=(0, 1, 2)).to(scale.dtype),
            d.sum(dim=(0, 1, 2)).to(bias.dtype))


def _group_mean(v: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Per sample and group mean of v (B, H, W, C), broadcast back to (B, 1, 1, C)."""
    n, h, w, c = v.shape
    m = v.reshape(n, h * w, num_groups, c // num_groups).mean(dim=(1, 3))
    return m.repeat_interleave(c // num_groups, dim=1).reshape(n, 1, 1, c)


def _norm_silu_grads(x, dy, mul, add, num_groups, silu, moments=None):
    """(dx f32, x̂, dO) of [SiLU](x̂ * mul + add) for the cotangent dy, with x̂ the group
    norm of x (by ``moments``, else x's own): dO = dy * SiLU'(o) and dx = inv * (dO*mul -
    mean_G(dO*mul) - x̂ * mean_G(dO*mul*x̂))."""
    if moments is None:
        moments = group_moments(x, num_groups)
    mean_c, inv_c = _per_channel(moments, x.shape[-1])
    xh = (x.float() - mean_c) * inv_c
    d = dy.float()
    if silu:
        o = xh * mul + add
        s = torch.sigmoid(o)
        d = d * (s * (1 + o * (1 - s)))
    g = d * mul
    dx = inv_c * (g - _group_mean(g, num_groups) - xh * _group_mean(g * xh, num_groups))
    return dx, xh, d


def adagn_silu_plain(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
                     silu: bool = True, return_moments: bool = False):
    """[SiLU](GN(x) * (1 + scale) + shift) in x's dtype; with ``return_moments`` also the
    (B, G, 2) f32 moments it normalized with."""
    c = x.shape[-1]
    moments = group_moments(x, num_groups)
    mean_c, inv_c = _per_channel(moments, c)
    ss = scale_shift.float()[:, None, None, :]
    y = (x.float() - mean_c) * inv_c
    y = y * (1.0 + ss[..., :c]) + ss[..., c:]
    if silu:
        y = y * torch.sigmoid(y)
    return (y.to(x.dtype), moments) if return_moments else y.to(x.dtype)


def adagn_silu_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale_shift: torch.Tensor,
                         num_groups: int, silu: bool = True,
                         moments: Optional[torch.Tensor] = None):
    """The VJP of ``adagn_silu_plain`` (the JAX package's ``_adagn_silu_ref``) at x for
    the cotangent dy, written out in f32: (dx in x's dtype, d_scale_shift (B, 2C) in the
    rows' dtype: per sample the sums over H, W of dO * x̂, then of dO). ``moments``: the
    forward's (B, G, 2) mean and 1/std, else recomputed from x."""
    c = x.shape[-1]
    ss = scale_shift.float()[:, None, None, :]
    dx, xh, d = _norm_silu_grads(x, dy, 1.0 + ss[..., :c], ss[..., c:], num_groups, silu,
                                 moments)
    dss = torch.cat([(d * xh).sum(dim=(1, 2)), d.sum(dim=(1, 2))], dim=1)
    return dx.to(x.dtype), dss.to(scale_shift.dtype)


@functools.lru_cache(maxsize=None)
def placed_plan(plan: NormPlan, q8: bool, device: int) -> NormPlan:
    """``plan``, or its 8-block form where the card cannot place a cluster of plan.n > 8
    blocks (a GPC that holds fewer of them); asked once per plan, kernel and card."""
    with torch.cuda.device(device):
        lib = kernels.lib()
        clusters = (lib.gn_q8_max_clusters if q8 else lib.gn_max_clusters)(plan.c_ints)
    kernels.check(max(0, -clusters), "gn_max_clusters")
    if clusters > 0:
        return plan
    return plan_for(plan.B, plan.HW, plan.C, plan.G, plan.elem_bytes, PORTABLE_CLUSTER)


def _planned(x: torch.Tensor, num_groups: int, name: str, plan_fn) -> NormPlan:
    """``plan_fn(B, H * W, C, G, elem_bytes)`` for a call on x, raising on what the
    kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, H, W, C) tensor")
    kernels.dtype_code(x.dtype)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    b, h, w, c = x.shape
    try:
        return plan_fn(b, h * w, c, num_groups, x.element_size())
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def launch_plan(x: torch.Tensor, num_groups: int, name: str, q8: bool = False) -> NormPlan:
    """The launch plan of a call on x (``q8``: K4's int8 epilogue), raising on what the
    kernel does not take."""
    plan = _planned(x, num_groups, name, norm_plan)
    return plan if plan.n <= PORTABLE_CLUSTER else placed_plan(plan, q8, x.device.index)


def affine_rows(x: torch.Tensor, name: str, *rows: torch.Tensor):
    """(rows, dtype code) of FiLM rows or affine vectors as the kernel reads them: on x's
    device, contiguous, all f32 or all bf16 (no copy where they already are)."""
    if any(r.device != x.device for r in rows):
        raise ValueError(f"{name}: scale and shift must be on {x.device}")
    dtypes = {r.dtype for r in rows}
    if len(dtypes) != 1:
        raise ValueError(f"{name}: scale and shift must have one dtype, got {dtypes}")
    return [r.contiguous() for r in rows], kernels.dtype_code(rows[0].dtype)


def _film_rows(x: torch.Tensor, scale_shift: torch.Tensor, name: str):
    """(rows, dtype code) of K1's FiLM rows (B, 2C) as the kernels read them."""
    b, c = x.shape[0], x.shape[-1]
    if tuple(scale_shift.shape) != (b, 2 * c):
        raise ValueError(f"{name}: scale_shift must be ({b}, {2 * c})")
    (ss,), code = affine_rows(x, name, scale_shift)
    return ss, code


def _moments_out(x: torch.Tensor, num_groups: int, moments: bool):
    """(tensor, pointer) of the (B, G, 2) f32 moments a forward kernel writes, or
    (None, None) where it writes none."""
    if not moments:
        return None, None
    out = torch.empty((x.shape[0], num_groups, 2), device=x.device, dtype=torch.float32)
    return out, out.data_ptr()


def _adagn_silu_fwd(x, scale_shift, num_groups, silu, moments=False):
    """One K1 launch (or its plain version on a CPU tensor), outside autograd: y, and
    with ``moments`` (y, the (B, G, 2) f32 mean and 1/std it normalized with)."""
    if x.device.type == "cpu":
        return adagn_silu_plain(x, scale_shift, num_groups, silu, moments)
    plan = launch_plan(x, num_groups, "adagn_silu")
    ss, code = _film_rows(x, scale_shift, "adagn_silu")
    y = torch.empty_like(x)
    mom, mom_ptr = _moments_out(x, num_groups, moments)
    kernels.check(kernels.lib().adagn_silu_fwd(
        x.data_ptr(), ss.data_ptr(), code, y.data_ptr(), mom_ptr, int(silu), plan.c_ints,
        kernels.stream(x.device)), "adagn_silu")
    adagn_silu.launches += 1
    adagn_silu.shapes[(tuple(x.shape), str(x.dtype), bool(silu))] += 1
    return (y, mom) if moments else y


def adagn_silu_with_moments(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
                            silu: bool = True):
    """``adagn_silu`` outside autograd, also returning the (B, G, 2) f32 mean and 1/std
    of each group that K1 wrote (what ``adagn_silu_bwd`` reads)."""
    return _adagn_silu_fwd(x, scale_shift, num_groups, silu, True)


class AdaGroupNormSiLU(torch.autograd.Function):
    """K1 with its gradient: the forward is the K1 launch, which also writes the moments,
    the backward the K1 backward kernel (``adagn_silu_bwd``) on them; on CPU tensors both
    are the plain versions."""

    @staticmethod
    def forward(ctx, x, scale_shift, num_groups, silu):
        y, moments = adagn_silu_with_moments(x, scale_shift, num_groups, silu)
        ctx.save_for_backward(x, scale_shift, moments)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale_shift, moments = ctx.saved_tensors
        dx, dss = adagn_silu_bwd(x, dy.contiguous(), scale_shift, ctx.num_groups, ctx.silu,
                                 moments)
        return dx, dss, None, None


def adagn_silu(x: torch.Tensor, scale_shift: torch.Tensor, num_groups: int,
               silu: bool = True) -> torch.Tensor:
    """[SiLU](GN(x) * (1 + scale) + shift); x (B, H, W, C), scale_shift (B, 2C) is the
    FiLM projection of the conditioning vector, split at C. Differentiable: on a CUDA
    tensor that needs a gradient through ``AdaGroupNormSiLU``; under no grad, or where
    no input needs one, one K1 launch (writing no moments) and nothing else."""
    if x.device.type == "cpu":
        return adagn_silu_plain(x, scale_shift, num_groups, silu)
    if torch.is_grad_enabled() and (x.requires_grad or scale_shift.requires_grad):
        return AdaGroupNormSiLU.apply(x, scale_shift, num_groups, silu)
    return _adagn_silu_fwd(x, scale_shift, num_groups, silu)


def _bwd_operands(x, dy, moments, num_groups, name):
    """The backward plan of a call on x (``norm_plan.bwd_plan``), with dy and the
    forward's moments checked against x."""
    plan = _planned(x, num_groups, name, bwd_plan)
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"{name}: dy must be a contiguous, 16-byte aligned tensor of x's "
                         "shape, dtype and device")
    b = x.shape[0]
    if (moments is None or tuple(moments.shape) != (b, num_groups, 2)
            or moments.dtype != torch.float32 or moments.device != x.device
            or not moments.is_contiguous()):
        raise ValueError(f"{name}: moments must be the forward's contiguous ({b}, {num_groups}, "
                         f"2) f32 tensor on {x.device}")
    return plan


def adagn_silu_bwd(x: torch.Tensor, dy: torch.Tensor, scale_shift: torch.Tensor,
                   num_groups: int, silu: bool = True, moments: Optional[torch.Tensor] = None):
    """(dx, d_scale_shift) of [SiLU](GN(x) * (1 + scale) + shift) for the cotangent dy
    (x's shape and dtype), with ``moments`` the forward's (B, G, 2) mean and 1/std
    (``adagn_silu_with_moments``; a CPU tensor may leave them out): dx in x's dtype,
    d_scale_shift (B, 2C) in the rows' dtype. One launch of the K1 backward kernel
    (kernels/csrc/gn_bwd.cu: one cluster per sample sums its own FiLM gradient)."""
    if x.device.type == "cpu":
        return adagn_silu_bwd_plain(x, dy, scale_shift, num_groups, silu, moments)
    plan = _bwd_operands(x, dy, moments, num_groups, "adagn_silu_bwd")
    ss, code = _film_rows(x, scale_shift, "adagn_silu_bwd")
    dx = torch.empty_like(x)
    dss = torch.empty_like(ss)
    kernels.check(kernels.lib().adagn_silu_bwd(
        x.data_ptr(), dy.data_ptr(), moments.data_ptr(), ss.data_ptr(), code, dx.data_ptr(),
        dss.data_ptr(), int(silu), plan.c_ints, kernels.stream(x.device)),
        "adagn_silu_bwd")
    adagn_silu_bwd.launches += 1
    adagn_silu_bwd.shapes[(tuple(x.shape), str(x.dtype), bool(silu), str(ss.dtype))] += 1
    return dx, dss


def _groupnorm_silu_fwd(x, scale, bias, num_groups, silu, moments=False):
    """One K2 launch (or its plain version on a CPU tensor), outside autograd: y, and
    with ``moments`` (y, the (B, G, 2) f32 mean and 1/std it normalized with)."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, silu, moments)
    plan = launch_plan(x, num_groups, "groupnorm_silu")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu: scale and bias must be ({c},)")
    (sc, bi), code = affine_rows(x, "groupnorm_silu", scale, bias)
    y = torch.empty_like(x)
    mom, mom_ptr = _moments_out(x, num_groups, moments)
    kernels.check(kernels.lib().groupnorm_silu_fwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), code, y.data_ptr(), mom_ptr, int(silu),
        plan.c_ints, kernels.stream(x.device)), "groupnorm_silu")
    groupnorm_silu.launches += 1
    groupnorm_silu.shapes[(tuple(x.shape), str(x.dtype), bool(silu))] += 1
    return (y, mom) if moments else y


def groupnorm_silu_with_moments(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                                num_groups: int, silu: bool = True):
    """``groupnorm_silu`` outside autograd, also returning the (B, G, 2) f32 mean and
    1/std of each group that K2 wrote (what ``groupnorm_silu_bwd`` reads)."""
    return _groupnorm_silu_fwd(x, scale, bias, num_groups, silu, True)


class GroupNormSiLU(torch.autograd.Function):
    """K2 with its gradient: the forward is the K2 launch, which also writes the moments,
    the backward the K2 backward kernel (``groupnorm_silu_bwd``) on them; on CPU tensors
    both are the plain versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, silu):
        y, moments = groupnorm_silu_with_moments(x, scale, bias, num_groups, silu)
        ctx.save_for_backward(x, scale, bias, moments)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, moments = ctx.saved_tensors
        dx, dscale, dbias = groupnorm_silu_bwd(x, dy.contiguous(), scale, bias, ctx.num_groups,
                                               ctx.silu, moments)
        return dx, dscale, dbias, None, None


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, silu: bool = True) -> torch.Tensor:
    """[SiLU](GN(x) * scale + bias); x (B, H, W, C), scale and bias (C,). Differentiable:
    on a CUDA tensor that needs a gradient through ``GroupNormSiLU``; under no grad, or
    where no input needs one, one K2 launch (writing no moments) and nothing else."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, silu)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return GroupNormSiLU.apply(x, scale, bias, num_groups, silu)
    return _groupnorm_silu_fwd(x, scale, bias, num_groups, silu)


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
    """The K2 backward's ticket counter on ``device``: one int, 0 between launches (the
    last block of each launch resets it). Calls on one card run in stream order."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def groupnorm_silu_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int, silu: bool = True,
                       moments: Optional[torch.Tensor] = None):
    """(dx, dscale, dbias) of [SiLU](GN(x) * scale + bias) for the cotangent dy (x's
    shape and dtype), with ``moments`` the forward's (B, G, 2) mean and 1/std
    (``groupnorm_silu_with_moments``; a CPU tensor may leave them out): dx in x's dtype,
    dscale and dbias (C,) in the affine's dtype. One launch of the K2 backward kernel
    (kernels/csrc/gn_bwd.cu: its last block sums the samples' partials)."""
    if x.device.type == "cpu":
        return groupnorm_silu_bwd_plain(x, dy, scale, bias, num_groups, silu, moments)
    plan = _bwd_operands(x, dy, moments, num_groups, "groupnorm_silu_bwd")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"groupnorm_silu_bwd: scale and bias must be ({c},)")
    (sc, bi), code = affine_rows(x, "groupnorm_silu_bwd", scale, bias)
    dx = torch.empty_like(x)
    dsb = torch.empty((2, c), device=x.device, dtype=sc.dtype)
    rows = torch.empty((x.shape[0], 2 * c), device=x.device, dtype=torch.float32)
    kernels.check(kernels.lib().groupnorm_silu_bwd(
        x.data_ptr(), dy.data_ptr(), moments.data_ptr(), sc.data_ptr(), bi.data_ptr(), code,
        dx.data_ptr(), dsb.data_ptr(), rows.data_ptr(), _ticket(x.device).data_ptr(), int(silu),
        plan.c_ints, kernels.stream(x.device)), "groupnorm_silu_bwd")
    groupnorm_silu_bwd.launches += 1
    groupnorm_silu_bwd.shapes[(tuple(x.shape), str(x.dtype), bool(silu), str(sc.dtype))] += 1
    return dx, dsb[0], dsb[1]


adagn_silu.launches = 0
adagn_silu.shapes = Counter()
adagn_silu_bwd.launches = 0
adagn_silu_bwd.shapes = Counter()
groupnorm_silu.launches = 0
groupnorm_silu.shapes = Counter()
groupnorm_silu_bwd.launches = 0
groupnorm_silu_bwd.shapes = Counter()
