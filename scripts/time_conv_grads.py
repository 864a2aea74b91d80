#!/usr/bin/env python3
"""Device time of the 3x3 conv's gradient kernels of diamond_tpu_torch (K3's weight
gradient, with and without the bias gradient, and its stride-2 data gradient) at every
signature of the denoiser train step and the actor-critic train step (B = 32), from the
checkout given by ``--root``, so that two commits can be timed on one card in turns
(here a checkout of the parent commit unpacked into the git-ignored ``_scratch/parent``):

    python3 scripts/time_conv_grads.py --root _scratch/parent --out chiprun_out/grads_1.json
    python3 scripts/time_conv_grads.py --root . --out chiprun_out/grads_2.json
    python3 scripts/time_conv_grads.py --root . --out chiprun_out/grads_3.json
    python3 scripts/time_conv_grads.py --root _scratch/parent --out chiprun_out/grads_4.json
    python3 scripts/time_conv_grads.py --summarize chiprun_out/grads_*.json

Per signature: the weight gradient alone (``wgrad``), the weight and bias gradients as
the conv's backward computes them (``wgrad_db``: one call where the wrapper takes
``with_bias``, else the weight gradient and dy's f32 sum), the stride-2 data gradient
(``dgrad_s2``: ``conv3x3_dgrad`` at stride 2), and cuDNN's ``conv2d_weight`` /
``conv2d_input`` on the same inputs. Each is checked against the plain version (bf16,
1/64 of max(1, max |plain|)) and timed with chip_smoke.py's ``cuda_time_ms`` (CUDA-graph
replays, inputs warm in L2); per-step totals weight each signature by its calls in one
step. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports nothing of the package until called)

B = 32
# (step, H of x, Cin, Cout, stride, calls per step): the weight gradients of one
# denoiser step (two windows) and one AC step (T = 15), as the module trees make them
WGRAD = [("denoiser", 64, 128, 64, 1, 6), ("denoiser", 64, 64, 64, 1, 16),
         ("denoiser", 64, 64, 64, 2, 2), ("denoiser", 64, 15, 64, 1, 2),
         ("denoiser", 64, 64, 3, 1, 2), ("denoiser", 32, 128, 64, 1, 6),
         ("denoiser", 32, 64, 64, 1, 16), ("denoiser", 32, 64, 64, 2, 2),
         ("denoiser", 16, 128, 64, 1, 6), ("denoiser", 16, 64, 64, 1, 16),
         ("denoiser", 16, 64, 64, 2, 2), ("denoiser", 8, 128, 64, 1, 6),
         ("denoiser", 8, 64, 64, 1, 22), ("ac", 64, 3, 32, 1, 15), ("ac", 64, 32, 32, 1, 15),
         ("ac", 32, 32, 32, 1, 15), ("ac", 16, 32, 64, 1, 15), ("ac", 8, 64, 64, 1, 15)]
# (H of x, Cin, Cout, calls per denoiser step): the stride-2 data gradients
DGRAD_S2 = [(64, 64, 64, 2), (32, 64, 64, 2), (16, 64, 64, 2)]
TOL = 1 / 64


def run(root: Path, out: Path) -> int:
    sys.path.insert(0, str(root.resolve()))
    import torch

    from diamond_tpu_torch import kernels, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.lib()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    fused_db = "with_bias" in inspect.signature(ops.conv3x3_wgrad).parameters
    rows, failures = [], []

    def close(name, got, ref):
        torch.cuda.synchronize()
        scale = max(1.0, ref.float().abs().max().item())
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= TOL * scale:
            failures.append(f"{name}: max abs err {err} > {TOL} * {scale}")
            print("[fail]", failures[-1], flush=True)

    def time_row(kind, sig, calls, fn, lib):
        ms, lib_ms = chip_smoke.cuda_time_ms(fn), chip_smoke.cuda_time_ms(lib)
        rows.append(dict(kind=kind, sig=sig, calls=calls, ms=ms, library_ms=lib_ms))
        print(f"[time] {kind} {sig}: {ms:.4f} ms (cuDNN {lib_ms:.4f})", flush=True)

    for step, h, cin, cout, s, calls in WGRAD:
        ho = (h - 1) // s + 1
        x = torch.randn(B, h, h, cin, device="cuda", generator=gen).to(bf)
        dy = torch.randn(B, ho, ho, cout, device="cuda", generator=gen).to(bf)
        sig = f"{step} x {h}x{h}x{cin} -> {cout} s{s}"
        close(f"wgrad {sig}", ops.conv3x3_wgrad(x, dy, s), ops.conv3x3_wgrad_plain(x, dy, s))
        if fused_db:
            wdb = lambda: ops.conv3x3_wgrad(x, dy, s, with_bias=True)  # noqa: E731
        else:
            def wdb():
                return ops.conv3x3_wgrad(x, dy, s), dy.sum(dim=(0, 1, 2), dtype=torch.float32)
        lib = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
            x.permute(0, 3, 1, 2), (cout, cin, 3, 3), dy.permute(0, 3, 1, 2), stride=s,
            padding=1)
        time_row("wgrad", sig, (step, calls), lambda: ops.conv3x3_wgrad(x, dy, s), lib)
        time_row("wgrad_db", sig, (step, calls), wdb, lib)
    for h, cin, cout, calls in DGRAD_S2:
        ho = (h - 1) // 2 + 1
        dy = torch.randn(B, ho, ho, cout, device="cuda", generator=gen).to(bf)
        k = ((torch.rand((3, 3, cin, cout), generator=gen, device="cuda") * 2 - 1)
             / (9 * cin) ** 0.5).to(bf)
        sig = f"denoiser dy {ho}x{ho}x{cout} -> x {h}x{h}x{cin}"
        close(f"dgrad_s2 {sig}", ops.conv3x3_dgrad(dy, k, 2, (h, h)),
              ops.conv3x3_dgrad_plain(dy, k, 2, (h, h)))
        lib = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
            (B, cin, h, h), k.permute(3, 2, 0, 1), dy.permute(0, 3, 1, 2), stride=2, padding=1)
        time_row("dgrad_s2", sig, ("denoiser", calls), lambda: ops.conv3x3_dgrad(dy, k, 2, (h, h)),
                 lib)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(root=str(root), card=smi, fused_db=fused_db, rows=rows,
                                   failures=failures), indent=1))
    print(f"[done] {len(rows)} timings, {len(failures)} failed checks -> {out}", flush=True)
    return 1 if failures else 0


# (H of x, Cin, Cout, stride) of the plan alternatives timed by --explore
EXPLORE = [(64, 64, 64, 1), (64, 128, 64, 1), (64, 64, 64, 2), (32, 64, 64, 1), (16, 64, 64, 1),
           (8, 64, 64, 1), (64, 15, 64, 1), (64, 64, 3, 1), (64, 32, 32, 1), (64, 3, 32, 1),
           (32, 32, 32, 1)]


def alternative(base, tr: int, cluster: int):
    """``base`` (a wgrad_plan) with tiles of ``tr`` dy rows and clusters of ``cluster`` K
    splits, its M-tiles dealt as in ``base``: two stages where they fit, else one; None
    where the kernel's check refuses it."""
    from dataclasses import replace

    from diamond_tpu_torch.ops import conv_plan as cp

    for stages in (2, 1):
        hr, hc, halo, dyb, smem = cp._wgrad_smem(tr, base.stride, base.Wo, base.pxb, base.nt,
                                                 stages, base.mpw)
        if smem <= cp.SMEM_BLOCK:
            break
    tiles_y = -(-base.Ho // tr)
    tiles = base.B * tiles_y
    kblocks = min(tiles, cp.NUM_SMS // base.ngroups) // cluster * cluster
    p = replace(base, tr=tr, tiles_y=tiles_y, tiles=tiles, ksteps=-(-tr * base.Wo // 16), hr=hr,
                hc=hc, halo_bytes=halo, dy_bytes=dyb, stages=stages, cluster=cluster,
                kblocks=kblocks, smem=smem, grid=base.ngroups * kblocks * base.mgroups)
    return p if cp.wgrad_plan_ok(p) else None


def explore(out: Path) -> int:
    """The bf16 weight gradient (with the bias gradient) at EXPLORE's signatures on its own
    plan and on alternatives (tiles of tr rows, clusters of 1 or 2 K splits), each
    checked against the plain version and timed; and the default plan's device time split
    between the main kernel and the partials' sum (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.ops.conv_plan import wgrad_plan

    kernels.lib()
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def call(x, dy, p):
        f32 = dict(device="cuda", dtype=torch.float32)
        part = torch.empty((p.parts, p.rows, p.nt), **f32)
        pdb = torch.empty((p.kblocks, p.nt), **f32)
        dw = torch.empty((3, 3, p.Cin, p.Cout), device="cuda", dtype=x.dtype)
        db = torch.empty((p.Cout,), **f32)
        kernels.check(kernels.lib().conv3x3_wgrad_bf16(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), pdb.data_ptr(), dw.data_ptr(),
            db.data_ptr(), p.c_ints, torch.cuda.current_stream().cuda_stream), "explore")
        return dw

    for h, cin, cout, s in EXPLORE:
        ho = (h - 1) // s + 1
        x = torch.randn(B, h, h, cin, device="cuda", generator=gen).to(torch.bfloat16)
        dy = torch.randn(B, ho, ho, cout, device="cuda", generator=gen).to(torch.bfloat16)
        ref = ops.conv3x3_wgrad_plain(x, dy, s)
        base = wgrad_plan(B, h, h, cin, cout, s)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call(x, dy, base)
            torch.cuda.synchronize()
        split = {e.key[:40]: e.self_device_time_total / e.count
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count}
        print(f"[split] x {h}x{h}x{cin} -> {cout} s{s} (tr {base.tr}, kblocks {base.kblocks}): "
              + ", ".join(f"{k} {v:.1f} µs" for k, v in split.items()), flush=True)
        rows.append(dict(sig=[h, cin, cout, s], split=split))
        for tr in sorted(t for t in {2, 4, 8, 16, base.tr} if t <= ho):
            for cl in (1, 2):
                p = base if (tr, cl) == (base.tr, base.cluster) else alternative(base, tr, cl)
                if p is None:
                    continue
                got = call(x, dy, p)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                ok = err <= TOL * max(1.0, ref.float().abs().max().item())
                ms = chip_smoke.cuda_time_ms(lambda: call(x, dy, p))
                rows.append(dict(sig=[h, cin, cout, s], tr=p.tr, kblocks=p.kblocks,
                                 cluster=p.cluster, stages=p.stages, ms=ms, ok=ok))
                print(f"[plan] x {h}x{h}x{cin} -> {cout} s{s} tr {p.tr} kblocks {p.kblocks} "
                      f"cluster {p.cluster} mgroups {p.mgroups} stages {p.stages}: "
                      f"{ms * 1e3:.1f} µs{'' if ok else ' WRONG'}"
                      + (" (default)" if p == base else ""), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=smi, rows=rows), indent=1))
    return 0


def summarize(paths) -> int:
    """Median time per signature of each root, the ratio of the last root to the first,
    and per-step totals (each signature times its calls per step)."""
    runs, lib = {}, {}
    for p in paths:
        d = json.loads(Path(p).read_text())
        for r in d["rows"]:
            key = (r["kind"], r["sig"], tuple(r["calls"]))
            runs.setdefault(d["root"], {}).setdefault(key, []).append(r["ms"])
            lib.setdefault(key, []).append(r["library_ms"])
    roots = list(runs)
    med = {root: {k: sorted(v)[len(v) // 2] for k, v in runs[root].items()} for root in roots}
    lib = {k: sorted(v)[len(v) // 2] for k, v in lib.items()}
    print("kind | signature | " + " | ".join(roots) + " | cuDNN | last/first")
    totals = {}
    for key in med[roots[0]]:
        vals = [med[r].get(key) for r in roots]
        print(key[0], "|", key[1], "|", " | ".join(f"{v * 1e3:.1f} µs" for v in vals), "|",
              f"{lib[key] * 1e3:.1f} µs", "|", f"{vals[-1] / vals[0]:.3f}")
        step, calls = key[2]
        for r, v in zip(roots + ["cuDNN"], vals + [lib[key]]):
            t = totals.setdefault((key[0], step), {})
            t[r] = t.get(r, 0.0) + calls * v
    for (kind, step), t in totals.items():
        print(f"per {step} step, {kind}: " + ", ".join(f"{r} {v:.3f} ms" for r, v in t.items()))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path("."))
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/grads.json"))
    ap.add_argument("--summarize", nargs="+")
    ap.add_argument("--explore", action="store_true",
                    help="time the weight gradient's plan alternatives (this checkout)")
    a = ap.parse_args()
    if a.summarize:
        return summarize(a.summarize)
    import torch

    if not torch.cuda.is_available():
        print("time_conv_grads: no CUDA device", file=sys.stderr)
        return 1
    return explore(a.out) if a.explore else run(a.root, a.out)


if __name__ == "__main__":
    sys.exit(main())
