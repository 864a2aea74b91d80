#!/usr/bin/env python3
"""Time variants of the fused GroupNorm kernel (K1 ``adagn_silu`` and K4's
``adagn_silu_q8``, bf16) at the rollout's AdaGN signatures (B = 32), beside the launch
plan and build that ops/norm_plan.py and kernels/ use:

  * plans: n = 1, 2, 4, 8 or 16 blocks per sample (``norm_plan.plan_for``), with a copy
    of x (``y.copy_(x)``, the same bytes in and out) as a yardstick and K1 without SiLU
    (the element work without its two special-function operations);
  * the SiLU: the library as built, and the norm kernels built from a copy of the
    sources (under kernels/build/, git-ignored) whose SiLU takes the full-precision
    exponential and a true division, each on the default plan.

Every variant's output is checked against the plain version first (bf16 within
chip_smoke.py's tolerance of max |plain|; K4's codes equal quantize_static of the same
variant's K1 output). Inputs and timing are chip_smoke.py's.

    python3 scripts/norm_variants.py            # on a CUDA GPU, from the repo root

Prints one line per signature and variant, then per variant the time per rollout (each
signature weighted by its calls per rollout); writes chiprun_out/norm_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

OUT = ROOT / "chiprun_out" / "norm_variants.json"
# AdaGN calls per rollout of the full-size agent at B = 32, by (H, C) of x (B, H, H, C):
# the denoiser's (C = 64, 128) and the rew/end model's (C = 32), as chip_smoke.py counts
# them on either path
CALLS = {(h, c): n for h in (64, 32, 16) for c, n in ((32, 60), (64, 315), (128, 135))}
CALLS.update({(8, 32): 120, (8, 64): 495, (8, 128): 135})
FAST_SILU = "return silu ? __fdividef(o, __fadd_rn(1.f, __expf(-o))) : o;"
EXACT_SILU = "return silu ? __fdiv_rn(o, __fadd_rn(1.f, expf(-o))) : o;"


def exact_silu_library() -> ctypes.CDLL:
    """K1 and K4 built from a copy of fused_norms.cu, fused_q8.cu and their headers with
    the SiLU swapped for its full-precision form."""
    from diamond_tpu_torch import kernels

    src = kernels.BUILD_DIR / "exact_silu"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, src)
    f = src / "gn_common.cuh"
    text = f.read_text()
    if text.count(FAST_SILU) != 1:
        raise RuntimeError("gn_common.cuh's SiLU is not the form this script replaces")
    f.write_text(text.replace(FAST_SILU, EXACT_SILU))
    out = src / "libexact_silu.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(src / "fused_norms.cu"), str(src / "fused_q8.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("adagn_silu_fwd", "adagn_silu_q8_fwd"):
        getattr(lib, name).argtypes = list(kernels._SIGNATURES[name])
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("norm_variants: no CUDA device", file=sys.stderr)
        return 1
    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.ops.norm_plan import norm_plan, plan_for, plan_ok

    libs = {"fast": kernels.lib(), "exact": exact_silu_library()}
    tol = chip_smoke.TOL["bfloat16"]["adagn_silu"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (h, c), calls in CALLS.items():
        b = 32
        x, ss, g, _ = chip_smoke.make_inputs(
            "adagn_silu", ((b, h, h, c), "torch.bfloat16", True), torch.bfloat16, gen)
        ref = ops.adagn_silu_plain(x, ss, g)
        am = ref.float().abs().amax(dim=(0, 1, 2)) * 0.95
        y, q = torch.empty_like(x), torch.empty(x.shape, dtype=torch.int8, device="cuda")
        copy_ms = chip_smoke.cuda_time_ms(lambda: y.copy_(x))
        default = norm_plan(b, h * h, c, g, 2)
        variants = [(plan_for(b, h * h, c, g, 2, n), "fast") for n in (1, 2, 4, 8, 16)]
        variants.append((default, "exact"))
        for p, silu_form in variants:
            assert plan_ok(p)
            lib = libs[silu_form]

            def k1(silu=1, p=p, lib=lib):
                kernels.check(lib.adagn_silu_fwd(
                    x.data_ptr(), ss.data_ptr(), 1, y.data_ptr(), None, silu, p.c_ints,
                    torch.cuda.current_stream().cuda_stream), "adagn_silu")

            def k4(p=p, lib=lib):
                kernels.check(lib.adagn_silu_q8_fwd(
                    x.data_ptr(), ss.data_ptr(), 1, am.data_ptr(), q.data_ptr(), p.c_ints,
                    torch.cuda.current_stream().cuda_stream), "adagn_silu_q8")

            k1()
            k4()
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            ok = (err <= tol * max(1.0, ref.float().abs().max().item())
                  and torch.equal(q, ops.quantize_static(y, am)))
            row = dict(b=b, h=h, c=c, calls=calls, n=p.n, smem=p.smem, silu_form=silu_form,
                       default=p == default, ok=ok, k1_ms=chip_smoke.cuda_time_ms(k1),
                       k1_nosilu_ms=chip_smoke.cuda_time_ms(lambda: k1(0)),
                       k4_ms=chip_smoke.cuda_time_ms(k4), copy_ms=copy_ms)
            rows.append(row)
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)
    for silu_form in ("fast", "exact"):
        sel = [r for r in rows if r["default"] and r["silu_form"] == silu_form]
        k1, k4 = (sum(r["calls"] * r[k] for r in sel) for k in ("k1_ms", "k4_ms"))
        print(f"[per rollout] default plans, {silu_form} SiLU: K1 {k1:.2f} ms, "
              f"K4 adagn_silu_q8 {k4:.2f} ms", flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(dict(card=chip_smoke.nvidia_smi(), rows=rows), indent=1))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
