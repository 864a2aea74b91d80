"""Int8 product over the last axis with static per-input-channel activation scales (K6).

Counterpart of diamond_tpu/ops/quant.py::matmul_q8_static, which XLA computes on the
TPU's int8 MXU; its sites are the 1x1 convs, the dense layers and the LSTM gates
(ops/quant.py). On a CUDA tensor ``matmul_int8`` launches the hand-written kernel in
``kernels/csrc/matmul_q8.cu`` on the launch plan of ``ops/matmul_plan.py`` (a
persistent bulk-copy pipeline for large M, one tile a block, K split over a cluster
where it is long, for the rest); on a CPU tensor it runs ``matmul_int8_plain``, the
same contract with the int8 sums taken exactly in float64.

x is (..., K) in f32 or bf16, quantized as it is loaded with the static scale
s_c = max(act_max, 1e-8) * 1.05 / 127 of its channel (``quantize_static``). The kernel
reads the weights as ``kmajor_2d(w_q)``, which the int8 sites make once when their
collection is installed (``quant.install``, the ``w_k`` buffer) and the wrapper
otherwise makes per call. The epilogue is f32(acc) * w_scale[n], then in ``out_dtype``
plus the bias rounded to ``out_dtype``: the JAX package's order,
``matmul_q8_static(...).astype(dtype)`` and then ``+ b.astype(dtype)``
(diamond_tpu/models/blocks.py:98-110, :143-150).

``matmul_int8.launches`` counts kernel launches and ``matmul_int8.shapes`` the call
signatures.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .conv3x3_q8 import quantize_static
from .matmul_plan import K_STEP, matmul_plan

_DTYPES = (torch.float32, torch.bfloat16)


def kmajor_2d(w_q: torch.Tensor) -> torch.Tensor:
    """The K-major copy of w_q (K, N) the kernel reads: row n holds w_q[:, n], zero-padded
    to a multiple of K_STEP; (N, round32(K)) int8, contiguous."""
    k = w_q.shape[0]
    return F.pad(w_q.t(), (0, -k % K_STEP)).contiguous()


def matmul_int8_plain(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                      act_max: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., K) f32 or bf16, quantized with ``act_max`` (K,); w_q (K, N) int8; w_scale
    (N,) f32; bias (N,) or None. -> (..., N) in ``out_dtype``."""
    xq = quantize_static(x, act_max)
    n = w_q.shape[-1]
    acc = xq.reshape(-1, x.shape[-1]).double() @ w_q.double()
    y = (acc.float() * w_scale.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.reshape(*x.shape[:-1], n)


def _rows(x: torch.Tensor):
    """x as rows of K with a uniform row stride: (x, M, row stride), copying only where
    no such view exists."""
    k = x.shape[-1]
    if x.is_contiguous():  # the sites' case: x as it is, no view to make
        return x, math.prod(x.shape[:-1]), k
    x = x.reshape(-1, k)  # a view wherever one exists (a time step of the LSTM's input)
    m = x.shape[0]
    if x.stride(-1) != 1 or (m > 1 and x.stride(0) < k):
        x = x.contiguous()
    return x, m, x.stride(0) if m > 1 else k


def matmul_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                act_max: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32,
                w_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 product of ``matmul_int8_plain``'s contract; ``w_k``: ``kmajor_2d(w_q)``
    where the caller keeps it (else made here)."""
    if x.dim() < 1 or x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"matmul_int8: x (..., K) f32/bf16 and out f32/bf16, got "
                         f"{tuple(x.shape)} {x.dtype} -> {out_dtype}")
    k = x.shape[-1]
    if act_max is None or tuple(act_max.shape) != (k,):
        raise ValueError(f"matmul_int8: x needs act_max ({k},)")
    if x.device.type == "cpu":
        return matmul_int8_plain(x, w_q, w_scale, act_max, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_int8: x must be a CPU or CUDA tensor, got {x.device}")
    if w_q.dim() != 2 or w_q.shape[0] != k or w_q.dtype != torch.int8:
        raise ValueError(f"matmul_int8: w_q must be int8 ({k}, N), got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    n = w_q.shape[1]
    if w_k is None:
        w_k = kmajor_2d(w_q)
    k_shape = (n, k + -k % K_STEP)
    if (tuple(w_k.shape) != k_shape or w_k.dtype != torch.int8 or w_k.device != x.device
            or not w_k.is_contiguous() or w_k.data_ptr() % 16):
        raise ValueError(f"matmul_int8: w_k must be int8 {k_shape}, contiguous and 16-byte "
                         f"aligned on {x.device}")
    act_max = act_max.to(device=x.device, dtype=torch.float32).contiguous()

    def f32(t, what):
        if t is None:
            return None
        if tuple(t.shape) != (n,) or t.device != x.device:
            raise ValueError(f"matmul_int8: {what} must be ({n},) on {x.device}")
        return t.float().contiguous()

    w_scale = f32(w_scale, "w_scale")
    bias = f32(bias, "bias")
    lead = x.shape[:-1]
    x2, m, ldx = _rows(x)
    y = torch.empty((*lead, n), device=x.device, dtype=out_dtype)
    if m and n:
        plan = matmul_plan(m, k, n, ldx, x.element_size(), y.element_size(),
                           x2.data_ptr() % 16 == 0)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        kernels.check(kernels.lib().matmul_q8_fwd(
            x2.data_ptr(), act_max.data_ptr(), w_k.data_ptr(), w_scale.data_ptr(), ptr(bias),
            y.data_ptr(), plan.c_ints, kernels.stream(x.device)), "matmul_int8")
        matmul_int8.launches += 1
        matmul_int8.shapes[(tuple(x.shape), str(x.dtype), n, bias is not None,
                            str(out_dtype))] += 1
    return y


matmul_int8.launches = 0
matmul_int8.shapes = Counter()
