"""The per-layer readers' shared arithmetic (benchmarks/metrics/<name>.py pick one and
give their own kernel name patterns). A reader returns None where its source holds
nothing to read in the run, and the harness then leaves the metric out."""

from __future__ import annotations

from typing import Optional

from .work import conv_least_s, flops_s


def per_step_ms(seconds: Optional[float], steps: int) -> Optional[float]:
    return None if seconds is None or steps == 0 else seconds / steps * 1e3


def launch_calls_per_step(r) -> float:
    return r.trace.launch_calls / r.steps


def device_ms_under(r, annotation: str) -> Optional[float]:
    return per_step_ms(r.trace.device_s_under(annotation), r.steps)


def device_ms_matching(r, pattern: str) -> Optional[float]:
    s = r.trace.device_s(pattern)
    return per_step_ms(s, r.steps) if s > 0 else None


def conv_roofline_pct(r, pattern: str) -> Optional[float]:
    """The least time of the step's 3x3 convolutions, forward and backward, over the
    device time of the kernels matching ``pattern``."""
    dev = r.trace.device_s(pattern)
    least = conv_least_s(r.cell.work()) * r.steps
    return 100.0 * least / dev if dev > 0 and least > 0 else None


def device_idle_pct(r) -> float:
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def mfu_pct(r) -> Optional[float]:
    """The operations the steps need, at the chip's peak, over the window's wall time."""
    least = flops_s(r.cell.work()) * r.steps
    return 100.0 * least / r.window_s if least > 0 else None
