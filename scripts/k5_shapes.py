#!/usr/bin/env python3
"""Time K5 (ops/conv3x3_q8.py ``conv3x3_int8``) at every call shape of the int8 rollout,
on each of its routes, against the call's bound.

One imagined transition of the Atari agent (configs/agent/default.yaml widths, int8 at
``conv3x3,conv1x1``) makes 177 K5 calls: three denoiser forwards and one rew/end forward,
at the 64², 32², 16² and 8² levels, on K4's int8 codes or on bf16 inputs (the Upsample
and Downsample convs, the rew/end model's first conv and its stride-2 convs), all with a
bias and a bf16 output. ``SIGNATURES`` lists them with their count a transition; an AC
step rolls 15 transitions.

For each batch and shape the script times the halo route (``conv_plan.k5_plan``) and the
pipeline route (``conv_plan.pipe_plan``, where the shape allows it) with
``chip_smoke.cuda_time_ms`` (warm, inputs in L2 where they fit), in turns (halo, pipe,
pipe, halo), checks that the routes' outputs are equal bit for bit, and gives the
bound: the larger of the bytes (x, weights, scales, bias and y once) at 3.35 TB/s and
the operations at 1,979 TOP/s (``chip_smoke.bound``). Per-step sums weigh each shape by
its calls a step.

    python3 scripts/k5_shapes.py [--batch 512,32] [--routes halo,pipe]   # on an H100

Prints one row a shape and the sums, and writes them to
chiprun_out/k5_shapes_b<batch>.json.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

HORIZON = 15
# (calls a transition, H = W, Cin, Cout, stride, x): x "int8" (K4's codes) or "bf16"
SIGNATURES = [
    (21, 64, 64, 64, 1, "int8"), (9, 64, 128, 64, 1, "int8"), (3, 64, 64, 3, 1, "int8"),
    (4, 64, 32, 32, 1, "int8"), (3, 64, 64, 64, 1, "bf16"), (3, 64, 64, 64, 2, "bf16"),
    (1, 64, 32, 32, 2, "bf16"), (1, 64, 6, 32, 1, "bf16"),
    (21, 32, 64, 64, 1, "int8"), (9, 32, 128, 64, 1, "int8"), (4, 32, 32, 32, 1, "int8"),
    (3, 32, 64, 64, 1, "bf16"), (3, 32, 64, 64, 2, "bf16"), (1, 32, 32, 32, 2, "bf16"),
    (21, 16, 64, 64, 1, "int8"), (9, 16, 128, 64, 1, "int8"), (4, 16, 32, 32, 1, "int8"),
    (3, 16, 64, 64, 1, "bf16"), (3, 16, 64, 64, 2, "bf16"), (1, 16, 32, 32, 2, "bf16"),
    (33, 8, 64, 64, 1, "int8"), (9, 8, 128, 64, 1, "int8"), (8, 8, 32, 32, 1, "int8"),
]


def plans(b, h, cin, cout, stride, x_bytes):
    """The routes' plans of one call: {route: plan} for the routes that take it."""
    from diamond_tpu_torch.ops import conv_plan

    out = {"halo": conv_plan.k5_plan(b, h, h, cin, cout, stride, x_bytes == 1)}
    pipe = getattr(conv_plan, "pipe_plan", None)
    p = pipe(b, h, h, cin, cout, stride, x_bytes, 2) if pipe else None
    if p is not None:
        out["pipe"] = p
    return out


def main() -> int:
    import torch
    from diamond_tpu_torch.ops import conv3x3_int8

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", default="512,32")
    ap.add_argument("--routes", default="halo,pipe")
    args = ap.parse_args()
    routes = args.routes.split(",")
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for b in map(int, args.batch.split(",")):
        rows, sums = [], {"bound_ms": 0.0}
        for count, h, cin, cout, stride, xk in SIGNATURES:
            sig = ((b, h, h, cin), f"torch.{xk}", cout, stride, True, False, "torch.bfloat16")
            a = chip_smoke.make_inputs("conv3x3_int8", sig, torch.bfloat16, gen)
            byte_ms, op_ms = chip_smoke.bound("conv3x3_int8", a)
            row = {"b": b, "h": h, "cin": cin, "cout": cout, "stride": stride, "x": xk,
                   "calls_a_step": count * HORIZON, "bound_ms": max(byte_ms, op_ms),
                   "bytes_ms": byte_ms, "ops_ms": op_ms}
            ps = {r: p for r, p in plans(b, h, cin, cout, stride, a[0].element_size()).items()
                  if r in routes}
            ys = {r: conv3x3_int8(*a, plan=p) for r, p in ps.items()}
            torch.cuda.synchronize()
            if "halo" in ys and "pipe" in ys:
                row["equal"] = bool(torch.equal(ys["halo"], ys["pipe"]))
            del ys
            order = list(ps) + list(ps)[::-1]
            times = {r: [] for r in ps}
            for r in order:
                p = ps[r]
                times[r].append(chip_smoke.cuda_time_ms(lambda: conv3x3_int8(*a, plan=p)))
            for r, ts in times.items():
                row[f"{r}_ms"] = sum(ts) / len(ts)
                row[f"{r}_pct_of_bound"] = 100.0 * row["bound_ms"] / row[f"{r}_ms"]
                sums[f"{r}_ms"] = sums.get(f"{r}_ms", 0.0) + row[f"{r}_ms"] * count * HORIZON
            sums["bound_ms"] += row["bound_ms"] * count * HORIZON
            rows.append(row)
            print(json.dumps(row), flush=True)
            del a
            torch.cuda.empty_cache()
        sums = {f"{k}_a_step": v for k, v in sums.items()}
        print(json.dumps({"b": b, **sums}), flush=True)
        (out_dir / f"k5_shapes_b{b}.json").write_text(
            json.dumps({"card": smi, "rows": rows, "per_step": sums}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
