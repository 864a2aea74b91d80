"""The benchmark of diamond_tpu_torch: run one cell once and print its result line.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in BENCHMARK.json at the
root of the checkout; see benchmarks/harness/bench.py. Exits 2 without printing a
result where the cell's CUDA devices are missing.
"""

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(None, T_START))
