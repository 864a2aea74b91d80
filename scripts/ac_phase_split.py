#!/usr/bin/env python3
"""The AC cell's traced window split by the program's spans: one traced run of the
benchmark cell (``benchmarks/run.py --trace 1``, the same harness, readers and check),
whose trace is kept and read by span (``benchmarks/harness/spans.py``):

    python3 scripts/ac_phase_split.py --seed 2147491001 --out split.json

For each top-level span of the AC step (``pool::ensure``, ``ac::rollout``, ``ac::loss``,
``train::backward``, ``train::update``) and each span inside the rollout
(``wm::transition``, ``ac::policy``, ``ac::reset``): the device ms a step of the kernels
launched inside it, of those the int8 sites' (the ``int8_device_ms_per_step`` reader's
patterns) and the elementwise adds and ``cat`` copies, and the idle ms a step whose
closing kernel it launched; then the top-level spans' share of the window's busy time
(``coverage``) and what lies outside them, and the IC-pool manager's counters over the
run (its set-up builds). Prints the result line's metrics and the
split; writes both to ``--out``. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmarks"), str(ROOT)]

TOP = ("pool::ensure", "ac::rollout", "ac::loss", "train::backward", "train::update")
IN_ROLLOUT = ("wm::transition", "ac::policy", "ac::reset")
PATTERNS = {"int8": r"matmul_q8|conv3x3_halo_wgmma<signed char|gn_cluster_kernel<[^,>]*, true>",
            "adds_copies": r"elementwise|CatArrayBatchedCopy"}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="atari-ac-step-b512")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", type=Path, required=True)
    a = p.parse_args()

    import torch
    from diamond_tpu_torch.envs import world_model_env as wme
    from harness import bench
    from harness import trace as trace_mod
    from harness.spans import coverage, split

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    bench.set_cache_dirs()
    kept = {}
    orig = trace_mod.Trace.__init__

    def keep(self, events):
        orig(self, events)
        kept["trace"] = self

    trace_mod.Trace.__init__ = keep
    pool = {}  # the pool manager's counters at its last wait (the cell's release)
    orig_wait = wme.PoolManager.wait_pending

    def wait_pending(self):
        orig_wait(self)
        pool.update(builds=self.builds, build_s=self.build_s, build_cpu_s=self.build_cpu_s,
                    gather_bytes=self.gather_bytes, wait_s=self.wait_s)

    wme.PoolManager.wait_pending = wait_pending
    out = bench.run(a.workload, a.seed, 0.0, True, "cuda")
    tr = kept["trace"]
    steps = int(out["attempted"])
    ms = lambda s: None if s is None else s / steps * 1e3  # noqa: E731
    parts = split(tr, TOP + IN_ROLLOUT, PATTERNS)
    table = {name: {k: ms(v) for k, v in row.items()} for name, row in parts.items()}
    top = [table[n] for n in TOP if n in table]
    busy_ms = ms(tr.busy_s())
    summary = dict(
        steps=steps, window_ms=ms(tr.window_s), busy_ms=busy_ms,
        idle_ms=ms(tr.window_s) - busy_ms, coverage=coverage(tr, TOP),
        outside_top_device_ms=busy_ms - sum(r["device_s"] for r in top),
        outside_top_idle_ms=ms(tr.window_s) - busy_ms - sum(r["idle_s"] for r in top),
        pool=pool, device=torch.cuda.get_device_name(0))
    result = dict(metrics={k: v["value"] for k, v in out["metrics"].items()},
                  correct=out["correct"], checks=out["checks"], split_ms=table,
                  summary=summary, breakdown=out.get("breakdown"))
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result["metrics"]))
    print(f"{'span':18s} {'device':>9s} {'int8':>9s} {'adds/cat':>9s} {'idle':>9s}  (ms a step)")
    for name, row in table.items():
        print(f"{name:18s} {row['device_s']:9.2f} {row['int8'] or 0:9.2f} "
              f"{row['adds_copies'] or 0:9.2f} {row['idle_s']:9.2f}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
