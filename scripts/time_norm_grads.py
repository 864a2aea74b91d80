#!/usr/bin/env python3
"""Device time of the GroupNorm backward kernels of diamond_tpu_torch (K1's
``adagn_silu_bwd`` and K2's ``groupnorm_silu_bwd``) at every norm-backward signature of
the denoiser train step and the actor-critic train step (B = 32, bf16), from the
checkout given by ``--root``, so that two commits can be timed on one card in turns
(here a checkout of the parent commit unpacked into the git-ignored ``_scratch/parent``):

    python3 scripts/time_norm_grads.py --root _scratch/parent --out chiprun_out/ngrads_1.json
    python3 scripts/time_norm_grads.py --root . --out chiprun_out/ngrads_2.json
    python3 scripts/time_norm_grads.py --root . --out chiprun_out/ngrads_3.json
    python3 scripts/time_norm_grads.py --root _scratch/parent --out chiprun_out/ngrads_4.json
    python3 scripts/time_norm_grads.py --summarize chiprun_out/ngrads_*.json
    python3 scripts/time_norm_grads.py --explore      # this checkout's plan alternatives

Per signature: the kernel checked against its plain version (chip_smoke.py's
``compare_one``: bf16 within 1/64 of max(1, max |plain|), and a second call equal bit for
bit) and timed with chip_smoke.py's ``cuda_time_ms`` (CUDA-graph replays, inputs warm in
L2), with its bound (chip_smoke.py ``bound``) and the blocks of its launch plan. A
checkout whose backward reads the forward's moments is given those the forward kernel
wrote; an older one recomputes them. Per-step totals weight each signature by its calls
in one step. ``--explore`` times the backward plan's alternatives at the 64x64, 32x32,
16x16 and 8x8 shapes (blocks per sample, and the shared memory of 1 to 8 blocks per SM:
``norm_plan.bwd_plan_for``), each checked against the plain version. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import inspect
import itertools
import json
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports nothing of the package until called)

B = 32
# (kernel, step, H, C, silu, calls per step): the norm backwards of one denoiser step (two
# windows: per U-Net forward 7 + 3 K1 at each of 64, 32 and 16 with C = 64 + 128, 11 + 3
# at 8; K2 at norm_out and the two attention pre-norms) and one AC step (T = 15: the
# trunk's four GroupNorm+SiLU), as the module trees make them
SIGS = ([("adagn_silu_bwd", "denoiser", h, c, True, n)
         for h, n64 in ((64, 14), (32, 14), (16, 14), (8, 22)) for c, n in ((64, n64), (128, 6))]
        + [("groupnorm_silu_bwd", "denoiser", 64, 64, True, 2),
           ("groupnorm_silu_bwd", "denoiser", 8, 64, False, 4)]
        + [("groupnorm_silu_bwd", "ac", h, c, True, 15)
           for h, c in ((64, 32), (32, 32), (16, 32), (8, 64))])


def _inputs(ops, name, h, c, silu, gen):
    """chip_smoke.py's inputs of one signature (bf16 x and dy, the FiLM rows in bf16 as the
    model makes them, K2's affine f32), without the moments where the checkout's backward
    takes none."""
    import torch

    bf = torch.bfloat16
    if hasattr(ops, name.replace("_bwd", "_with_moments")):
        sig = ((B, h, h, c), str(bf), silu, "torch.bfloat16" if name == "adagn_silu_bwd"
               else "torch.float32")
        return chip_smoke.make_inputs(name, sig, bf, gen)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    x, dy = (2 * rnd(B, h, h, c) + 0.5).to(bf), rnd(B, h, h, c).to(bf)
    g = max(1, c // 32)
    if name == "adagn_silu_bwd":
        return (x, dy, (0.5 * rnd(B, 2 * c)).to(bf), g, silu)
    return (x, dy, 1 + 0.1 * rnd(c), 0.1 * rnd(c), g, silu)


def run(root: Path, out: Path) -> int:
    sys.path.insert(0, str(root.resolve()))
    import torch

    from diamond_tpu_torch import kernels, ops

    kernels.lib()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failures = [], []
    for name, step, h, c, silu, calls in SIGS:
        args = _inputs(ops, name, h, c, silu, gen)
        kernel, plain = getattr(ops, name), getattr(ops, name + "_plain")
        sig = f"{step} {h}x{h}x{c} silu={silu}"
        try:
            err = chip_smoke.compare_one(name, kernel, plain, args, "bfloat16")
        except chip_smoke.SmokeFailure as e:
            failures.append(f"{name} {sig}: {e}")
            print("[fail]", failures[-1], flush=True)
            err = None
        ms = chip_smoke.cuda_time_ms(lambda: kernel(*args))
        with_moments = "moments" in inspect.signature(kernel).parameters
        bound_ms = max(chip_smoke.bound(name, args if with_moments else args + (
            torch.empty((B, max(1, c // 32), 2), device="cuda"),)))
        rows.append(dict(kernel=name, sig=sig, calls=(step, calls), ms=ms, bound_ms=bound_ms,
                         err=err))
        print(f"[time] {name} {sig}: {ms * 1e3:.1f} µs (bound {bound_ms * 1e3:.1f} µs, "
              f"{100 * bound_ms / ms:.0f} %), err {err}", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(root=str(root), card=smi, rows=rows, failures=failures),
                              indent=1))
    print(f"[done] {len(rows)} timings, {len(failures)} failed checks -> {out}", flush=True)
    return 1 if failures else 0


# (kernel, H, C) of the plan alternatives --explore times: K1's at the denoiser step's
# shapes, K2's at the AC step's
EXPLORE = ([("adagn_silu_bwd", h, c) for h in (64, 32, 16, 8) for c in (64, 128)]
           + [("groupnorm_silu_bwd", h, c) for h, c in ((64, 32), (32, 32), (16, 32), (8, 64))])


def explore(out: Path) -> int:
    """K1's and K2's backward at EXPLORE's shapes, bf16, on the default plan and on the
    alternatives n = 1, 2, 4, 8 blocks per sample with the shared memory of 1, 2, 3, 4, 6
    or 8 blocks per SM (less keeps less of x and dy on chip), each checked against the
    plain version and timed."""
    import torch

    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.ops.norm_plan import bwd_plan, bwd_plan_for

    kernels.lib()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = chip_smoke.TOL["bfloat16"]["adagn_silu_bwd"][0]
    rows = []
    for name, h, c in EXPLORE:
        args = _inputs(ops, name, h, c, True, gen)
        x, dy, mom, g = args[0], args[1], args[-1], args[-3]
        ref = getattr(ops, name + "_plain")(*args)
        default = bwd_plan(B, h * h, c, g, 2)
        dx = torch.empty_like(x)
        if name == "adagn_silu_bwd":
            ss = args[2]
            out_g = torch.empty_like(ss)

            def call(p, silu=1):
                kernels.check(kernels.lib().adagn_silu_bwd(
                    x.data_ptr(), dy.data_ptr(), mom.data_ptr(), ss.data_ptr(), 1, dx.data_ptr(),
                    out_g.data_ptr(), silu, p.c_ints, torch.cuda.current_stream().cuda_stream),
                    "explore")
        else:
            sc, bi = args[2], args[3]
            out_g = torch.empty((2, c), device="cuda")
            scratch = torch.empty((B, 2 * c), device="cuda")
            ticket = torch.zeros(1, dtype=torch.int32, device="cuda")

            def call(p, silu=1):
                kernels.check(kernels.lib().groupnorm_silu_bwd(
                    x.data_ptr(), dy.data_ptr(), mom.data_ptr(), sc.data_ptr(), bi.data_ptr(), 0,
                    dx.data_ptr(), out_g.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                    silu, p.c_ints, torch.cuda.current_stream().cuda_stream), "explore")
        plans = []
        for n, per_sm in itertools.product((1, 2, 4, 8), (1, 2, 3, 4, 6, 8)):
            try:
                plans.append((per_sm, bwd_plan_for(B, h * h, c, g, 2, n, per_sm)))
            except ValueError:
                continue
        step_px = default.step_px  # the default plan with other bulk-copy chunks
        for k in (1, 2, 4, 8):
            cpx = k * step_px
            if cpx != default.cpx and -(-default.rpx // cpx) <= 8:
                plans.append(("chunks", replace(default, cpx=cpx,
                                                chunks=-(-default.rpx // cpx))))
        seen = set()
        for per_sm, p in plans:
            if p in seen:
                continue
            seen.add(p)
            call(p)
            torch.cuda.synchronize()
            scale = max(1.0, ref[0].float().abs().max().item())
            err = (dx.float() - ref[0].float()).abs().max().item()
            ok = err <= tol * scale
            ms = chip_smoke.cuda_time_ms(lambda: call(p))
            rows.append(dict(kernel=name, h=h, c=c, n=p.n, blocks_per_sm=per_sm,
                             threads=p.threads, rpx=p.rpx, ppb=p.ppb, smem=p.smem, ms=ms,
                             ok=ok, default=p == default))
            print(f"[plan] {name} {h}x{h}x{c} n {p.n} per_sm {per_sm} threads {p.threads} "
                  f"rpx {p.rpx}/{p.ppb} cpx {p.cpx} smem {p.smem}: {ms * 1e3:.1f} µs"
                  + ("" if ok else f" WRONG ({err})") + (" (default)" if p == default
                                                         else ""), flush=True)
        # yardsticks of the default plan: without the SiLU (no sigmoid), and an add that
        # moves the same bytes (x and dy read, dx written)
        no_silu = chip_smoke.cuda_time_ms(lambda: call(default, 0))
        add = chip_smoke.cuda_time_ms(lambda: torch.add(x, dy, out=dx))
        rows.append(dict(kernel=name, h=h, c=c, no_silu_ms=no_silu, add_ms=add))
        print(f"[yardstick] {name} {h}x{h}x{c}: default plan without SiLU {no_silu * 1e3:.1f} "
              f"µs, x + dy -> dx {add * 1e3:.1f} µs", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0 if all(r.get("ok", True) for r in rows) else 1


def summarize(paths) -> int:
    """Median time per signature of each root (µs; roots in the order their files are
    given), each one's share of the bound, the ratio of each root to the first, and
    per-step totals of each kernel (ms): of the medians, and of every run."""
    runs, bounds, per_file = {}, {}, []
    for p in paths:
        d = json.loads(Path(p).read_text())
        tot = {}
        for r in d["rows"]:
            key = (r["kernel"], r["sig"], tuple(r["calls"]))
            runs.setdefault(d["root"], {}).setdefault(key, []).append(r["ms"])
            bounds[key] = r["bound_ms"]
            k = (r["kernel"], r["calls"][0])
            tot[k] = tot.get(k, 0.0) + r["calls"][1] * r["ms"]
        per_file.append((d["root"], tot))
    roots = list(runs)
    med = {root: {k: sorted(v)[len(v) // 2] for k, v in runs[root].items()} for root in roots}
    print("kernel | signature | calls | bound | " + " | ".join(
        f"{r} µs (share)" for r in roots) + " | " + " | ".join(f"{r} / {roots[0]}"
                                                              for r in roots[1:]))
    totals = {}
    for key in med[roots[0]]:
        vals = [med[r][key] for r in roots]
        print(key[0], "|", key[1], "|", key[2][1], "|", f"{bounds[key] * 1e3:.1f}", "|",
              " | ".join(f"{v * 1e3:.1f} ({100 * bounds[key] / v:.0f} %)" for v in vals), "|",
              " | ".join(f"{v / vals[0]:.3f}" for v in vals[1:]))
        step, calls = key[2]
        for r, v in zip(roots + ["bound"], vals + [bounds[key]]):
            t = totals.setdefault((key[0], step), {})
            t[r] = t.get(r, 0.0) + calls * v
    for (kind, step), t in totals.items():
        runs_of = {r: sorted(f"{tot[(kind, step)]:.3f}" for root, tot in per_file if root == r)
                   for r in roots}
        print(f"per {step} step, {kind}: " + ", ".join(f"{r} {v:.3f} ms" for r, v in t.items())
              + "; runs: " + "; ".join(f"{r} {', '.join(v)}" for r, v in runs_of.items()))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path("."))
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/norm_grads.json"))
    ap.add_argument("--summarize", nargs="+")
    ap.add_argument("--explore", action="store_true",
                    help="time the backward plan's alternatives (this checkout)")
    a = ap.parse_args()
    if a.summarize:
        return summarize(a.summarize)
    import torch

    if not torch.cuda.is_available():
        print("time_norm_grads: no CUDA device", file=sys.stderr)
        return 1
    return explore(a.out) if a.explore else run(a.root, a.out)


if __name__ == "__main__":
    sys.exit(main())
