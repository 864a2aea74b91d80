"""The traced run's reading of the profiler: kernels, their host operations, launch
calls and the device's busy time, from ``torch.profiler``'s raw events (the kineto
results, without building the per-op tables, which are slow for tens of thousands of
launches).

``Trace`` holds, for the traced window (the CPU annotation ``bench::window``):
- ``kernels``: (name, start_ns, end_ns, host op name, host op start_ns) of every device
  operation, in start order;
- ``launch_calls``: the ``cudaLaunchKernel`` and ``cudaLaunchKernelExC`` calls;
- ``annotations``: {name: [(start_ns, end_ns), ...]} of the CPU annotations;
- ``window_ns``: (start, end) of the window;
and computes the busy time (the union of the kernels' intervals), the device time of
kernels by name pattern or under an annotation, and the ``breakdown``.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench::window"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC")


class Trace:
    def __init__(self, events) -> None:
        """``events``: ``prof.profiler.kineto_results.events()``."""
        cpu_ops: Dict[int, Tuple[str, int]] = {}
        spans: List[Tuple[int, int, str]] = []
        devs, ann = [], defaultdict(list)
        self.launch_calls = 0
        launches = []
        for e in events:
            dt = str(e.device_type())
            name = e.name()
            if dt.endswith("CPU"):
                s = e.start_ns()
                cpu_ops[e.correlation_id()] = (name, s)
                if name in LAUNCHES:
                    launches.append(s)
                    continue
                spans.append((s, s + e.duration_ns(), name))
                if e.is_user_annotation() or name.startswith("bench::") or \
                        name.startswith("Optimizer.step"):
                    ann[name].append((s, s + e.duration_ns()))
            elif not e.is_user_annotation():
                s = e.start_ns()
                devs.append((name, s, s + e.duration_ns(), e.linked_correlation_id()))
        wins = ann.get(WINDOW)
        if not wins:
            raise RuntimeError("the trace holds no bench::window annotation")
        self.window_ns = (min(a for a, _ in wins), max(b for _, b in wins))
        w0, w1 = self.window_ns
        self.annotations = dict(ann)
        self.launch_calls = sum(w0 <= s <= w1 for s in launches)
        spans.sort()
        self._starts = [a for a, _, _ in spans]
        self._spans = spans
        kernels = []
        for name, s, t, corr in devs:
            # an annotation also shows on the device as a span over its kernels
            if t <= w0 or s >= w1 or t <= s or name in ann or name.startswith("bench::"):
                continue
            host, hs = cpu_ops.get(corr, ("", s))
            if host in LAUNCHES or not host:  # no operator around the launch, or no link:
                host = self.host_op_at(hs)    # what the host was running then
            kernels.append((name, max(s, w0), min(t, w1), host, hs))
        kernels.sort(key=lambda k: k[1])
        self.kernels = kernels

    def host_op_at(self, t: int) -> str:
        """The innermost CPU operation running at host time t (the latest-starting one
        among the last few that cover it)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(-1, i - 64), -1):
            a, b, name = self._spans[j]
            if a <= t <= b and name != WINDOW:
                return name
        return "(no host operation)"

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def merged(self) -> List[Tuple[int, int, int]]:
        """The union of the kernels' intervals: (start, end, index of the kernel that
        opens the interval)."""
        out: List[List[int]] = []
        for i, (_, s, t, _, _) in enumerate(self.kernels):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t, i])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t, _ in self.merged()) / 1e9

    def device_s(self, pattern: str) -> float:
        """Summed device time of the kernels whose name matches ``pattern`` (a regular
        expression searched in the name)."""
        rx = re.compile(pattern)
        return sum(t - s for n, s, t, _, _ in self.kernels if rx.search(n)) / 1e9

    def device_s_under(self, annotation: str) -> Optional[float]:
        """Summed device time of the kernels whose launching host operation began inside
        a CPU annotation of that name (None where the trace has no such annotation)."""
        spans = sorted(self.annotations.get(annotation, []))
        if not spans:
            return None
        starts = [a for a, _ in spans]
        total = 0
        for _, s, t, _, hs in self.kernels:
            i = bisect.bisect_right(starts, hs) - 1
            if i >= 0 and hs <= spans[i][1]:
                total += t - s
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle gaps named
        by the host operation that launched the kernel ending each gap."""
        by_name: Dict[str, int] = defaultdict(int)
        for n, s, t, _, _ in self.kernels:
            by_name[n] += t - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        merged = self.merged()
        w0, w1 = self.window_ns
        prev_end = w0
        for s, t, i in merged:
            if s > prev_end:
                gaps.append((self.kernels[i][3] or self.kernels[i][0], s - prev_end))
            prev_end = t
        if w1 > prev_end:
            gaps.append(("(window end: host after the last kernel)", w1 - prev_end))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[_short(n), v / 1e9] for n, v in ops],
                "idle_gaps": [[_short(n), v / 1e9] for n, v in gaps[:top]]}


def _short(name: str) -> str:
    return re.sub(r"\s+", " ", name)[:120]
