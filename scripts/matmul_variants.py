#!/usr/bin/env python3
"""Time the launch plans of K6 (``matmul_int8``, kernels/csrc/matmul_q8.cu) at the int8
paths' shapes, beside the plan ops/matmul_plan.py chooses:

  * the bulk variant at 32, 64 and 128 rows a tile, and at 2 and 4 ring stages, where
    it takes the call; the small variant at 16, 32 and 64 rows a tile and, where K is
    long enough, split over clusters of 1, 2, 4 and 8 blocks;
  * ``torch._int_mm`` on the same codes where it takes the shape (the product alone), and
    a device copy of x (x's bytes read and written once) as yardsticks;
  * with ``--parent DIR``: the K6 of another checkout (``DIR/diamond_tpu_torch/kernels/
    csrc/matmul_q8.cu``, built here on its own, with the C interface K6 had before its
    launch plans), in turns with the chosen plan (parent, plan, plan, parent).

Every variant's output is checked against the plain version first, bit for bit. Each
time is ``chip_smoke.cuda_time_ms`` (warm: inputs in L2 where they fit); the 64² row also
cold (``chip_smoke.cuda_time_cold_ms``: L2 flushed before each call). Per path, the times
are summed with each shape's calls per rollout or play frame.

    python3 scripts/matmul_variants.py [--parent DIR]   # on a CUDA GPU, from the repo root

Prints one line per shape and variant, then the per-path sums; writes
chiprun_out/matmul_variants.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = ROOT / "chiprun_out" / "matmul_variants.json"
# (M, K, N) -> calls per int8 rollout (and per AC step) of the default agent at B = 32,
# and per play frame of the csgo and default agents at batch 1 (chip_smoke.py's counts)
ROLLOUT = {(131072, 128, 64): 135, (32768, 128, 64): 135, (8192, 128, 64): 135,
           (2048, 128, 64): 135, (2048, 64, 64): 90, (2048, 64, 192): 90,
           (2048, 32, 32): 30, (2048, 32, 96): 30}
PLAY_CSGO = {(256, 128, 64): 18, (4, 128, 64): 9, (4, 32, 32): 2, (4, 32, 96): 2,
             (4, 64, 192): 6, (4, 64, 64): 6, (1024, 128, 64): 9, (16, 128, 64): 9,
             (4096, 128, 64): 9, (64, 128, 64): 18, (64, 64, 192): 6, (64, 64, 64): 6}
PLAY_DEFAULT = {(256, 128, 64): 9, (1024, 128, 64): 9, (4096, 128, 64): 9, (64, 128, 64): 9,
                (64, 32, 32): 2, (64, 32, 96): 2, (64, 64, 192): 6, (64, 64, 64): 6}
# int8_sites=all: the AdaGN and cond linears at M = B, the rew/end LSTM's gates, its heads
ALL_SITES = [(32, 256, 128), (32, 256, 256), (32, 2048, 2048), (32, 512, 2048),
             (32, 512, 512), (32, 512, 5)]
PATHS = {"int8 rollout": ROLLOUT, "csgo int8 play frame": PLAY_CSGO,
         "default int8 play frame": PLAY_DEFAULT}
COLD = (131072, 128, 64)
OLD_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def parent_library(parent: Path):
    """The parent checkout's K6 alone, built with its C interface (x, x_dtype, row stride,
    act_max, w_k, w_scale, bias, y, out_dtype, M, K, N, stream)."""
    from diamond_tpu_torch import kernels

    src = parent / "diamond_tpu_torch" / "kernels" / "csrc" / "matmul_q8.cu"
    out = kernels.BUILD_DIR / "parent_matmul_q8.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.matmul_q8_fwd.argtypes = OLD_ARGS
    lib.matmul_q8_fwd.restype = ctypes.c_int
    return lib


def inputs(m, k, n, gen):
    """bf16 x with channels spanning 1000x in range, its act_max (some values clip),
    int8 weights, scales and a bias, as chip_smoke.make_inputs makes them."""
    import torch
    from diamond_tpu_torch import ops

    x = (torch.randn(m, k, device="cuda", generator=gen)
         * torch.logspace(-2, 1, k, device="cuda")).to(torch.bfloat16)
    am = x.float().abs().amax(dim=0) * 0.95
    wq = torch.randint(-127, 128, (k, n), device="cuda", generator=gen, dtype=torch.int8)
    ws = torch.rand(n, device="cuda", generator=gen) * 1e-3 + 1e-4
    return x, wq, ws, am, 0.1 * torch.randn(n, device="cuda", generator=gen), ops.kmajor_2d(wq)


def candidates(m, k, n):
    """(label, plan) of every variant to time at (M, K, N) in bf16, the chosen one first."""
    from diamond_tpu_torch.ops import matmul_plan as mp

    chosen = mp.matmul_plan(m, k, n, k, 2, 2, True)
    out = [("chosen", chosen)]
    if mp.bulk_takes(m, k, n, k, 2, 2, True) and m >= 512:
        for stages in (2, 3, 4):
            p = mp.plan_for(m, k, n, k, 2, 2, True, mp.BULK, stages=stages)
            out.append((f"bulk stages={stages} per_sm={mp.bulk_blocks_per_sm(p.smem)}", p))
    for bm in (16, 32, 64):
        splits = (1, 2, 4, 8) if k >= 256 else (1,)
        for split in splits:
            out.append((f"small bm={bm} split={split}",
                        mp.plan_for(m, k, n, k, 2, 2, True, mp.SMALL, bm=bm, split=split)))
    seen, uniq = set(), []
    for label, p in out:
        if p not in seen and mp.plan_ok(p) and p.smem <= mp.SMEM_BLOCK:
            seen.add(p)
            uniq.append((label, p))
    return uniq


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matmul_variants: no CUDA device", file=sys.stderr)
        return 1
    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.ops import matmul_plan as mp

    lib = kernels.lib()
    old = parent_library(args.parent) if args.parent else None
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = sorted({s for d in PATHS.values() for s in d} | set(ALL_SITES),
                    key=lambda s: -s[0])
    rows, ok = [], True
    for m, k, n in shapes:
        x, wq, ws, am, b, wk = inputs(m, k, n, gen)
        ref = ops.matmul_int8_plain(x, wq, ws, am, b, torch.bfloat16)
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)

        def run(p, y=y):  # on the current stream, which a CUDA graph's capture replaces
            kernels.check(lib.matmul_q8_fwd(x.data_ptr(), am.data_ptr(), wk.data_ptr(),
                                            ws.data_ptr(), b.data_ptr(), y.data_ptr(),
                                            p.c_ints, torch.cuda.current_stream().cuda_stream),
                          "matmul_q8_fwd")

        base = dict(m=m, k=k, n=n, card=smi,
                    bytes_ms=chip_smoke.bound("matmul_int8",
                                              (x, wq, ws, am, b, torch.bfloat16))[0])
        xq = ops.quantize_static(x, am)
        if chip_smoke.int_mm_takes(m, k, n):
            base["int_mm_ms"] = chip_smoke.cuda_time_ms(lambda: torch._int_mm(xq, wq))
        xc = torch.empty_like(x)
        base["copy_ms"] = chip_smoke.cuda_time_ms(lambda: xc.copy_(x))
        for label, p in candidates(m, k, n):
            y.zero_()
            run(p)
            torch.cuda.synchronize()
            exact = torch.equal(y, ref)
            ok &= exact
            row = dict(base, variant=label, plan=mp.describe(p), exact=exact,
                       ms=chip_smoke.cuda_time_ms(lambda p=p: run(p)))
            if (m, k, n) == COLD:
                row["cold_ms"] = chip_smoke.cuda_time_cold_ms(lambda p=p: run(p))
            rows.append(row)
            print(" ".join(f"{kk}={v:.5f}" if isinstance(v, float) else f"{kk}={v}"
                           for kk, v in row.items() if kk != "card"), flush=True)
        if old is not None:  # in turns: parent, plan, plan, parent
            chosen = candidates(m, k, n)[0][1]

            def run_old():
                kernels.check(old.matmul_q8_fwd(x.data_ptr(), 1, k, am.data_ptr(),
                                                wk.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                                y.data_ptr(), 1, m, k, n,
                                                torch.cuda.current_stream().cuda_stream),
                              "parent K6")

            run_old()
            torch.cuda.synchronize()
            same = torch.equal(y, ref)
            ok &= same
            turns = [chip_smoke.cuda_time_ms(f) for f in (run_old, lambda: run(chosen),
                                                          lambda: run(chosen), run_old)]
            row = dict(base, variant="parent vs chosen in turns", exact=same,
                       parent_ms=[turns[0], turns[3]], chosen_ms=[turns[1], turns[2]])
            if (m, k, n) == COLD:
                row["parent_cold_ms"] = chip_smoke.cuda_time_cold_ms(run_old)
                row["chosen_cold_ms"] = chip_smoke.cuda_time_cold_ms(lambda: run(chosen))
            rows.append(row)
            print(" ".join(f"{kk}={v}" for kk, v in row.items() if kk != "card"), flush=True)
    for path, calls in PATHS.items():
        def total(key, variant="chosen"):
            return sum(c * next(r[key] for r in rows if (r["m"], r["k"], r["n"]) == s
                                and r["variant"] == variant) for s, c in calls.items())

        line = (f"[per {path}] chosen plans {total('ms'):.4f} ms, bound "
                f"{total('bytes_ms'):.4f} ms")
        if old is not None:
            par = sum(c * min(next(r["parent_ms"] for r in rows
                                   if (r["m"], r["k"], r["n"]) == s and "parent_ms" in r))
                      for s, c in calls.items())
            line += f", parent K6 {par:.4f} ms"
        print(line + f" on {smi}", flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
