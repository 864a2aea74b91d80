"""A step's work counted from the configuration's and the traffic's shapes, and the least
time the chip could take for it (the arithmetic of ``chip_smoke.py``'s ``bound``): each
input read once and each output written once over HBM's 3.35 TB/s, the operations (2
per multiply-add) over the peak of their type, 989 TFLOP/s in bf16 and 1,979 TOP/s in
int8 (NVIDIA's H100 SXM data sheet, dense).

A cell counts its step by running the plain reference's forward on "meta" tensors with
``Ctx(ops=[...])``: every product appends its kind, flops, bytes, whether it runs in
int8, whether its input needs a gradient and whether its weights are trained. The
backward of a trained product computes its weight gradient (the forward's operations)
and, where its input needs one, its data gradient (again as many).
"""

from __future__ import annotations

from typing import Iterable, List

HBM_BYTES_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12}


def passes(op: dict) -> int:
    """The forward and the backward's products of one op: 1, 2 or 3 times its flops."""
    if op["kind"] == "attention":
        return 1 + 2 * op["needs_dx"]
    return 1 + op["trained"] + op["needs_dx"]


def least_s(op: dict) -> float:
    """The op's forward and backward at the roofline: per pass the larger of its bytes
    and its operations time."""
    peak = PEAK["int8" if op["int8"] else "bf16"]
    return passes(op) * max(op["bytes"] / HBM_BYTES_S, op["flops"] / peak)


def flops_s(ops: Iterable[dict]) -> float:
    """The operations alone over their peak, forward and backward."""
    return sum(passes(o) * o["flops"] / PEAK["int8" if o["int8"] else "bf16"] for o in ops)


def conv_least_s(ops: List[dict]) -> float:
    return sum(least_s(o) for o in ops if o["kind"] == "conv3x3")
