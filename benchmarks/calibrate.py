"""The readings that a cell's limits are set from (PERF.md gives them beside each limit).

    python3 benchmarks/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out chiprun_out/<file>.jsonl]

For each seed, in one process: the cell's set-up and its check steps through the timed
call (no window), then the program's numbers against the plain reference; on the
control seeds also the control (the reference in the next lower precision put in the
program's place) and the driver's planted faults against the reference. One JSON line
a seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from harness import bench  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="", help="a configuration file in the cell's place")
    p.add_argument("--fault", default="", help="plant one of the driver's faults")
    a = p.parse_args()
    bench.set_cache_dirs()
    import torch

    wl, config, traffic = bench.resolve(a.workload)
    if a.config:
        config = json.loads(Path(a.config).read_text())
    driver = bench.load_file(bench.BENCH / "drivers" / f"{traffic['driver']}.py",
                             "bench_driver")
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    out = open(a.out, "a") if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        dev = torch.device(a.device)
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        env = bench.Env(wl, config, traffic, seed, dev, bench.Parts(sync))
        cell = driver.build(env)
        if a.fault:
            cell.plant(a.fault)
        cell.warm_up()
        sync()
        cell.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        line = {"workload": a.workload, "seed": seed, "fault": a.fault or None}
        if seed in controls:
            line.update(cell.readings())
        else:
            line["program"] = cell.program_readings()
        line["worst_leaves"] = getattr(cell, "leaves", {})
        line["setup_s"], line["reference_s"] = t1 - t0, time.perf_counter() - t1
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        s = json.dumps(line)
        print(s, flush=True)
        if out:
            out.write(s + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
