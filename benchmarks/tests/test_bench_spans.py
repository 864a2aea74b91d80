"""The readers of the program's spans (``harness/spans.py`` and the four
``metrics/*`` files that read a span): ``idle_s_under``, the split and the coverage on
hand-made ``Trace``s whose gaps and launches are known (the launch times rebuilt where
the profiler linked a kernel to no operation or to the wrong one), and a small traced
run of the AC cell on the CPU that reads the four metrics, with the program's spans
among the trace's annotations and never among its kernels.

    python -m pytest benchmarks/tests/test_bench_spans.py -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT), str(BENCH / "tests")]

from harness import bench  # noqa: E402
from harness.spans import (coverage, device_s_under, idle_s_under, launch_ns,  # noqa: E402
                           split)
from harness.trace import Trace  # noqa: E402

SPAN_METRICS = ("wm_device_ms_per_step.ac_train", "policy_device_ms_per_step.ac_train",
                "backward_device_ms_per_step.ac_train", "rollout_idle_ms_per_step.ac_train")
PROGRAM_SPANS = ("pool::ensure", "ac::rollout", "wm::transition", "ac::policy", "ac::reset",
                 "ac::loss", "train::backward", "train::update")


class Ev:
    """A profiler event as ``Trace`` reads it."""

    def __init__(self, name, start, dur, device="CPU", corr=0, linked=0, ann=False):
        self._v = (name, start, dur, device, corr, linked, ann)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def hand_made() -> Trace:
    """A 1,000 ns window: span ``a`` on the host over [100, 400], span ``b`` over
    [500, 700]. Kernels (device interval, launched at): k1 [150, 300] at 110 (in a),
    k2 [350, 380] at 310 (in a), k3 [380, 450] at 320 (in a, touching k2: no gap),
    k4 [600, 650] at 520 (in b), k5 [850, 900] at 800 (outside both).
    Gaps: [0, 150] closed by k1 (a), [300, 350] by k2 (a), [450, 600] by k4 (b),
    [650, 850] by k5 (none), [900, 1000] the window's end."""
    ev = [Ev("bench::window", 0, 1000, ann=True), Ev("a", 100, 300, ann=True),
          Ev("b", 500, 200, ann=True)]
    kernels = [("k1", 150, 300, 110), ("k2", 350, 380, 310), ("k3", 380, 450, 320),
               ("k4", 600, 650, 520), ("k5", 850, 900, 800)]
    for i, (name, s, t, launch) in enumerate(kernels, start=1):
        ev.append(Ev("cudaLaunchKernel", launch, 5, corr=i))
        ev.append(Ev(name, s, t - s, device="CUDA", linked=i))
    ev.append(Ev("a", 500, 200, device="CUDA", ann=True))  # the range's device copy
    return Trace(ev)


def test_idle_s_under_sums_the_gaps_each_span_closed():
    tr = hand_made()
    assert idle_s_under(tr, "a") * 1e9 == pytest.approx(150 + 50)
    assert idle_s_under(tr, "b") * 1e9 == pytest.approx(150)
    assert idle_s_under(tr, "missing") is None
    # the same gaps as the breakdown's (the window's end aside)
    gaps = sorted(g for _, g in tr.breakdown()["idle_gaps"])
    assert [round(g * 1e9) for g in gaps] == [50, 100, 150, 150, 200]


def device_paced() -> Trace:
    """The device runs behind the host. Spans ``a`` [100, 500] and ``b`` [600, 900];
    operations (link ids 1-5) start at 110 and 300 (in a), 620, 700 and 800 (in b); two
    unrelated ones, 98 at 50 and 99 at 1500. Kernels in device order (interval, link):
    k1 [550, 600] op 1; k2 [600, 640] op 2; k3 [640, 700] unlinked (launched in a after
    k2); k4 [700, 720] op 3; k5 [720, 760] linked to 99 by a collision (launched in b);
    k6 [950, 990] unlinked (in b); k7 [1000, 1050] op 4; k8 [1050, 1100] linked to 98 by
    a collision (in b); k9 [1100, 1150] op 5."""
    ev = [Ev("bench::window", 0, 2000, corr=1001, ann=True),
          Ev("a", 100, 400, corr=1002, ann=True), Ev("b", 600, 300, corr=1003, ann=True)]
    ops = {1: 110, 2: 300, 3: 620, 4: 700, 5: 800, 98: 50, 99: 1500}
    ev += [Ev(f"aten::op{c}", t, 5, corr=c) for c, t in ops.items()]
    kernels = [("k1", 550, 600, 1), ("k2", 600, 640, 2), ("k3", 640, 700, 0),
               ("k4", 700, 720, 3), ("k5", 720, 760, 99), ("k6", 950, 990, 0),
               ("k7", 1000, 1050, 4), ("k8", 1050, 1100, 98), ("k9", 1100, 1150, 5)]
    ev += [Ev(n, s, t - s, device="CUDA", linked=c) for n, s, t, c in kernels]
    return Trace(ev)


def test_launch_times_are_rebuilt_from_the_device_order():
    tr = device_paced()
    assert [k[4] for k in tr.kernels] == [110, 300, 640, 620, 1500, 950, 700, 50, 800]
    assert launch_ns(tr) == [110, 300, 300, 620, 620, 620, 700, 700, 800]
    assert device_s_under(tr, "a") * 1e9 == pytest.approx(50 + 40 + 60)
    assert device_s_under(tr, "b") * 1e9 == pytest.approx(20 + 40 + 40 + 50 + 50 + 50)
    assert device_s_under(tr, "b", "k5|k6") * 1e9 == pytest.approx(80)
    assert idle_s_under(tr, "a") * 1e9 == pytest.approx(550)
    assert idle_s_under(tr, "b") * 1e9 == pytest.approx(190 + 10)
    assert coverage(tr, ["a", "b"]) == pytest.approx(1.0)


def test_the_split_gives_each_span_its_device_time_idle_and_coverage():
    tr = hand_made()
    assert [k[0] for k in tr.kernels] == ["k1", "k2", "k3", "k4", "k5"]
    out = split(tr, ["a", "b", "missing"], {"k2_or_k4": "k2|k4"})
    assert set(out) == {"a", "b"}
    assert out["a"]["device_s"] * 1e9 == pytest.approx(150 + 30 + 70)
    assert out["a"]["k2_or_k4"] * 1e9 == pytest.approx(30)
    assert out["b"]["device_s"] * 1e9 == pytest.approx(50)
    assert out["b"]["idle_s"] * 1e9 == pytest.approx(150)
    assert tr.busy_s() * 1e9 == pytest.approx(350)
    assert coverage(tr, ["a", "b", "missing"]) == pytest.approx(300 / 350)
    assert coverage(tr, ["missing"]) is None
    assert device_s_under(tr, "missing", ".") is None


def test_a_trace_without_the_programs_spans_reads_nothing():
    """An older program has no spans: each span reader returns None and raises not."""
    tr = hand_made()

    class R:
        trace, steps = tr, 1

    for name in SPAN_METRICS:
        reader = bench.load_file(bench.reader_file(name), "t_" + name.replace(".", "_"))
        assert reader.read(R()) is None, name


def test_a_traced_ac_run_on_the_cpu_reads_the_span_metrics(monkeypatch):
    """A tiny traced run: the four metrics read (0 device ms on the CPU, where no kernel
    runs), and the program's spans land among the annotations, never among the kernels."""
    import test_bench_cells as cells

    seen = {}
    orig = Trace.__init__

    def keep(self, events):
        orig(self, events)
        seen["trace"] = self

    monkeypatch.setattr(Trace, "__init__", keep)
    out = cells.run_tiny("atari-ac-step-b512", trace=True)
    assert set(SPAN_METRICS) <= set(out["metrics"]), sorted(out["metrics"])
    assert all(out["metrics"][m]["value"] >= 0 for m in SPAN_METRICS)
    tr = seen["trace"]
    assert set(PROGRAM_SPANS) <= set(tr.annotations)
    traffic = cells.tiny("atari-ac-step-b512")[1]
    steps, t = traffic["trace_steps"], traffic["actor_critic_loss"]["backup_every"]
    assert len(tr.annotations["ac::rollout"]) == steps
    assert len(tr.annotations["wm::transition"]) == steps * t
    assert not {k[0] for k in tr.kernels} & set(PROGRAM_SPANS)
