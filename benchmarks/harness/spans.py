"""The program's spans in a traced window (``harness.trace.Trace``): the device time
and the idle time that each span accounts for, and the window's split by span.

The program (``diamond_tpu_torch/tracing.py``) names its layer boundaries with profiler
ranges, which the trace keeps among its ``annotations``. A kernel belongs to the span
the host was in when it launched the kernel; an idle gap of the device belongs to the
span in which the host launched the kernel that closed it (the gaps that
``Trace.breakdown`` names by host operation). Where the program has no such span (an
older program), each function returns None.

The launch times (``launch_ns``). ``Trace.kernels`` gives each kernel the start of the
host operation the profiler linked it to. A kernel that the port's own library launches
from Python (through ctypes, outside any PyTorch operation: the int8 sites, the 3x3
convs, the norms) is linked to none, and ``Trace`` gives it its device start instead,
which lies in a later span wherever the device runs behind the host; and an operation's
link id can equal an unrelated runtime call's, whose time ``Trace`` may take. So the
times are rebuilt from the device order: on one stream (the window's) kernels run in the
order the host launched them, so their launch times never decrease along it. Of the
linked times, the longest non-decreasing sequence is kept; every other kernel takes the
time of the last kept kernel before it on the device. (A linked time is not held to
precede its kernel's start: the device's clock, as the trace gives it, can run a few
hundred microseconds early against the host's.)
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple


def _longest_non_decreasing(xs: List[int]) -> List[int]:
    """Indices of a longest non-decreasing subsequence of ``xs``, in order."""
    tails: List[int] = []   # the least last value of a sequence of each length
    ends: List[int] = []    # its index
    prev = [-1] * len(xs)
    for j, x in enumerate(xs):
        p = bisect.bisect_right(tails, x)
        if p:
            prev[j] = ends[p - 1]
        if p == len(tails):
            tails.append(x)
            ends.append(j)
        else:
            tails[p], ends[p] = x, j
    out, j = [], ends[-1] if ends else -1
    while j >= 0:
        out.append(j)
        j = prev[j]
    return out[::-1]


def launch_ns(trace) -> List[int]:
    """For each of ``trace.kernels`` (in device order), the host time at which it was
    launched, rebuilt as the module's docstring says."""
    ks = trace.kernels
    cand = [i for i, k in enumerate(ks) if k[4] != k[1]]
    kept = {cand[j] for j in _longest_non_decreasing([ks[i][4] for i in cand])}
    out, last = [], trace.window_ns[0]
    for i, k in enumerate(ks):
        if i in kept:
            last = k[4]
        out.append(last)
    return out


def _ranges(trace, span: str):
    spans = sorted(trace.annotations.get(span, []))
    return (spans, [a for a, _ in spans]) if spans else None


def _inside(ranges, t: int) -> bool:
    spans, starts = ranges
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def device_s_under(trace, span: str, pattern: Optional[str] = None,
                   launches: Optional[List[int]] = None) -> Optional[float]:
    """Device seconds of the kernels launched inside a ``span`` range (whose name matches
    ``pattern``, where given); None where the trace has no such range."""
    ranges = _ranges(trace, span)
    if ranges is None:
        return None
    launches = launch_ns(trace) if launches is None else launches
    rx = re.compile(pattern) if pattern is not None else None
    return sum(t - s for (n, s, t, _, _), hs in zip(trace.kernels, launches)
               if (rx is None or rx.search(n)) and _inside(ranges, hs)) / 1e9


def idle_s_under(trace, span: str, launches: Optional[List[int]] = None
                 ) -> Optional[float]:
    """Seconds of the window's idle gaps whose closing kernel the host launched inside
    a ``span`` range (None where the trace has no such range)."""
    ranges = _ranges(trace, span)
    if ranges is None:
        return None
    launches = launch_ns(trace) if launches is None else launches
    total = 0
    prev_end = trace.window_ns[0]
    for s, t, i in trace.merged():
        if s > prev_end and _inside(ranges, launches[i]):
            total += s - prev_end
        prev_end = t
    return total / 1e9


def split(trace, names: Iterable[str], patterns: Dict[str, str]) -> Dict[str, dict]:
    """For each span present: its device and idle seconds and, for each named pattern,
    the device seconds of the kernels matching it."""
    launches = launch_ns(trace)
    out: Dict[str, dict] = {}
    for name in names:
        dev = device_s_under(trace, name, launches=launches)
        if dev is None:
            continue
        row = {"device_s": dev, "idle_s": idle_s_under(trace, name, launches)}
        for key, pat in patterns.items():
            row[key] = device_s_under(trace, name, pat, launches)
        out[name] = row
    return out


def coverage(trace, names: Iterable[str]) -> Optional[float]:
    """The device time under the given spans, which must not nest in one another, over
    the window's busy time (None where none of them is in the trace or nothing ran)."""
    launches = launch_ns(trace)
    found = [d for d in (device_s_under(trace, n, launches=launches) for n in names)
             if d is not None]
    busy = trace.busy_s()
    return sum(found) / busy if found and busy > 0 else None
