"""Run one cell of the benchmark once (``benchmarks/run.py``).

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration file
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``). The mix
names its step driver (``drivers/<driver>.py``), which builds the program's objects
from the seed, warms them up with the steps that the check compares, and runs one timed
step at a time. The harness times the window, reads the trace, runs the per-layer
readers (``metrics/<name>.py``, or ``metrics/<base>.py`` for every metric whose name
is ``<base>.<suffix>``) and the driver's comparison with the plain reference, and
prints one JSON line. Nothing here imports the program: the drivers do.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diamond_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of the loaded modules that the benchmark must never load,
    compared whole (``diamond_tpu_torch`` is not ``diamond_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout; keep libraries
    from loading JAX by themselves."""
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_file(path: Path, name: str):
    """A plug-in module (a driver or a metric reader) by its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_file(name: str) -> Path:
    """A per-layer metric's reader: its own file, else the one of its base name (the
    part before the first dot), which serves the metric under every suffix."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(workload: str, man: Optional[dict] = None):
    """(workload entry, config dict, traffic dict) of a cell, by name."""
    man = manifest() if man is None else man
    wl = {w["name"]: w for w in man["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = {c["name"]: c for c in man["configs"]}[wl["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, config, traffic


class Parts:
    """The seconds of each part of the set-up, in order."""

    def __init__(self, sync: Callable[[], None]) -> None:
        self.sync, self.seconds = sync, {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


class Reading:
    """What a per-layer reader may read: the traced window (``trace``, a
    harness.trace.Trace), the steps in it, the harness's own spans and the program's
    counters (seconds or counts summed over the window), and the driver's cell (its
    ``work()``: the step's products counted from the configuration's shapes)."""

    def __init__(self, cell, steps: int, window_s: float, trace, spans: Dict[str, float],
                 counters: Dict[str, float]) -> None:
        self.cell, self.steps, self.window_s = cell, steps, window_s
        self.trace, self.spans, self.counters = trace, spans, counters


class Env:
    """What a driver gets: the cell's files, the seed, the device and the set-up
    timer."""

    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int, device,
                 parts: Parts) -> None:
        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.device, self.parts = seed, device, parts


def device_info(torch, device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        man: Optional[dict] = None, config: Optional[dict] = None,
        process_start: Optional[float] = None, fault: Optional[str] = None,
        traffic: Optional[dict] = None) -> dict:
    """One run of one cell; returns the result line as a dict. ``config`` and
    ``traffic`` replace the cell's files (the tests' small sizes); ``fault`` plants one
    of the driver's faults (tests only)."""
    t_start = process_start if process_start is not None else time.perf_counter()
    wl, cfg_file, traffic_file = resolve(workload, man)
    config = cfg_file if config is None else config
    traffic = traffic_file if traffic is None else traffic
    import torch

    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    parts = Parts(sync)
    parts.seconds["import"] = time.perf_counter() - t_start
    driver = load_file(BENCH / "drivers" / f"{traffic['driver']}.py",
                       f"bench_driver_{traffic['driver']}")
    env = Env(wl, config, traffic, seed, dev, parts)
    cell = driver.build(env)
    if fault is not None:
        cell.plant(fault)
    cell.warm_up()
    sync()
    setup_s = time.perf_counter() - t_start

    spans: Dict[str, float] = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import Trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        steps = int(traffic["trace_steps"])
        with profile(activities=acts) as prof:
            with record_function("bench::window"):
                t0 = time.perf_counter()
                for _ in range(steps):
                    cell.step(spans)
                sync()
                t1 = time.perf_counter()
        tr = Trace(prof.profiler.kineto_results.events())
        del prof
    else:
        tr = None
        steps = 0
        t0 = time.perf_counter()
        while True:
            cell.step(spans)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
    window_s = t1 - t0
    counters = cell.counters()
    failed = cell.failed_steps()
    dinfo = device_info(torch, dev, int(wl["chips"]))
    e2e = traffic["metric"]

    man = manifest() if man is None else man
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        reading = Reading(cell, steps, window_s, tr, spans, counters)
        for m in man["per_layer"]:
            if m["moves"] != e2e or ("workloads" in m and workload not in m["workloads"]):
                continue
            reader = load_file(reader_file(m["name"]),
                               "bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dinfo["busy_s"] = tr.busy_s()
        dinfo["window_s"] = tr.window_s
        breakdown = tr.breakdown()
        del tr, reading
    else:
        metrics[e2e] = {"value": steps * cell.units_per_step / window_s,
                        "unit": next(m["unit"] for m in man["end_to_end"] if m["name"] == e2e)}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    print(f"window: {steps} steps in {window_s:.3f} s; {json.dumps(metrics)}; counters "
          f"{json.dumps(counters)}", file=sys.stderr, flush=True)
    cell.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    correct = failed == 0 and all(c[1] <= c[2] for c in checks)
    out = {"correct": bool(correct), "attempted": steps, "failed": failed, "metrics": metrics,
           "device": dinfo}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup_parts_s"] = parts.seconds
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    # last: whatever the window, the readers and the reference loaded
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs()
    wl, _, _ = resolve(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", process_start=t_start)
    sys.stdout.flush()
    print(f"setup parts (s): {json.dumps(out['setup_parts_s'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0
