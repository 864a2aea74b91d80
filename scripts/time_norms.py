#!/usr/bin/env python3
"""Device time of the fused GroupNorm kernels of diamond_tpu_torch (K1 ``adagn_silu``,
K2 ``groupnorm_silu``, K4's static epilogue ``adagn_silu_q8``/``groupnorm_silu_q8``) at
every norm signature of the full-size imagination rollout (B = 32), from the checkout
given by ``--root``, so that two commits can be timed on one card in turns (here a
checkout of the parent commit unpacked into the git-ignored ``_scratch/parent``):

    python3 scripts/time_norms.py --root _scratch/parent --out chiprun_out/turn_1.json
    python3 scripts/time_norms.py --root . --out chiprun_out/turn_2.json
    python3 scripts/time_norms.py --root . --out chiprun_out/turn_3.json
    python3 scripts/time_norms.py --root _scratch/parent --out chiprun_out/turn_4.json
    python3 scripts/time_norms.py --summarize chiprun_out/turn_*.json \
        --calls chiprun_out/chip_smoke.json    # with each kernel's ms per rollout

The inputs, the checks against the plain versions and the timing are chip_smoke.py's
(``make_inputs``, ``compare_one``, ``cuda_time_ms``), taken from this script's checkout
whatever ``--root`` is. Each signature is checked in bf16 and f32 and timed in bf16 (the
rollout's dtype), and its bf16 output's digest recorded (``--summarize`` says whether
the checkouts wrote the same bits); f32 is also checked at 64x64x128. A failed check is
recorded and printed, and the run goes on. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ast
import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (imports nothing of the package until called)

B = 32
# (H, C) of x (B, H, H, C): the denoiser at 64/32/16/8 with C = 64 and 128, the rew/end
# model at C = 32 (one group)
ADAGN = [(h, c) for h in (64, 32, 16, 8) for c in (64, 128, 32)]
# (H, C, silu): the actor-critic's and rew/end's GroupNorm+SiLU, the denoiser's norm_out,
# the attention pre-norms (no SiLU)
GN = [(64, 32, True), (32, 32, True), (16, 32, True), (64, 64, True), (8, 64, True),
      (8, 64, False), (8, 32, False)]
GN_Q8 = [(64, 64)]
KERNELS = ("adagn_silu", "groupnorm_silu", "adagn_silu_q8", "groupnorm_silu_q8")


def cases():
    """(kernel, h, c, silu) of every timed signature."""
    for h, c in ADAGN:
        yield "adagn_silu", h, c, True
        yield "adagn_silu_q8", h, c, True
    for h, c, silu in GN:
        yield "groupnorm_silu", h, c, silu
    for h, c in GN_Q8:
        yield "groupnorm_silu_q8", h, c, True


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
    rows, failures = [], []

    def checked(name, h, c, silu, dt_name):
        dt = getattr(torch, dt_name)
        sig = ((B, h, h, c), str(dt)) + (() if name.endswith("_q8") else (silu,))
        args = chip_smoke.make_inputs(name, sig, dt, gen)
        try:
            chip_smoke.compare_one(name, getattr(ops, name), getattr(ops, name + "_plain"),
                                   args, dt_name)
        except chip_smoke.SmokeFailure as e:
            failures.append(f"{name} {h}x{h}x{c} silu={silu} {dt_name}: {e}")
            print("[fail]", failures[-1], flush=True)
        return args

    for name, h, c, silu in cases():
        checked(name, h, c, silu, "float32")
        args = checked(name, h, c, silu, "bfloat16")
        ms = chip_smoke.cuda_time_ms(lambda: getattr(ops, name)(*args))
        y = getattr(ops, name)(*args).contiguous()  # the output's bits, to compare checkouts
        digest = hashlib.sha256(y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
        rows.append(dict(kernel=name, h=h, c=c, silu=silu, ms=ms, digest=digest))
        print(f"[time] {name} {h}x{h}x{c} silu={silu}: {ms:.4f} ms", flush=True)
    for name in ("adagn_silu", "groupnorm_silu", "adagn_silu_q8", "groupnorm_silu_q8"):
        checked(name, 64, 128, True, "float32")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(root=str(root), card=smi, rows=rows, failures=failures),
                              indent=1))
    print(f"[done] {len(rows)} timings, {len(failures)} failed checks -> {out}", flush=True)
    return 1 if failures else 0


def summarize(paths, calls=None) -> int:
    """Median time per signature of each root, the ratio of the others to the first, and
    whether every root wrote the same output bits on the same inputs."""
    runs, digests = {}, {}
    for p in paths:
        d = json.loads(Path(p).read_text())
        for r in d["rows"]:
            key = (r["kernel"], r["h"], r["c"], r["silu"])
            runs.setdefault(d["root"], {}).setdefault(key, []).append(r["ms"])
            digests.setdefault(key, set()).add(r.get("digest"))
    roots = list(runs)
    med = {root: {k: sorted(v)[len(v) // 2] for k, v in runs[root].items()} for root in roots}
    print("kernel h c silu " + " ".join(roots) + " ratio")
    for key in med[roots[0]]:
        vals = [med[r].get(key) for r in roots]
        ratio = vals[-1] / vals[0] if None not in vals else None
        print(*key, *(f"{v:.4f}" for v in vals if v is not None),
              f"{ratio:.3f}" if ratio else "",
              "same bits" if len(digests[key]) == 1 else f"{len(digests[key])} outputs")
    if calls:
        per_rollout(med, json.loads(Path(calls).read_text())["details"])
    return 0


def per_rollout(med, details) -> None:
    """Each kernel's device ms per rollout of each path and root: every signature's
    median times its calls per rollout, as chip_smoke.py's details (chip_smoke.json)
    recorded them for the bf16 and int8 rollouts."""
    weights = {}  # (kernel, h, c, silu) -> {path: calls per rollout}
    for r in details:
        if r["kernel"] not in KERNELS or r["dtype"] != "bfloat16":
            continue
        shape, _, *silu = ast.literal_eval(r["signature"])
        key = (r["kernel"], shape[1], shape[-1], silu[0] if silu else True)
        for path, n in r["calls_per_run"].items():
            if path in ("bf16", "int8"):
                weights.setdefault(key, {})[path] = n
    for key in weights:
        if key not in med[next(iter(med))]:
            print("not timed:", key)
    for root, m in med.items():
        tot = {}
        for key, per_path in weights.items():
            for path, n in per_path.items():
                if key in m:
                    tot[(key[0], path)] = tot.get((key[0], path), 0.0) + n * m[key]
        print(f"per rollout, {root}: " + ", ".join(
            f"{k} ({path}) {v:.3f} ms" for (k, path), v in sorted(tot.items())))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path("."))
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/norms.json"))
    ap.add_argument("--summarize", nargs="+")
    ap.add_argument("--calls", help="chip_smoke.json of a run: --summarize also gives each "
                    "kernel's ms per rollout, every signature weighted by its calls")
    a = ap.parse_args()
    if a.summarize:
        return summarize(a.summarize, a.calls)
    import torch

    if not torch.cuda.is_available():
        print("time_norms: no CUDA device", file=sys.stderr)
        return 1
    return run(a.root, a.out)


if __name__ == "__main__":
    sys.exit(main())
