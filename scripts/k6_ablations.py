#!/usr/bin/env python3
"""What bounds K6's bulk variant (kernels/csrc/matmul_q8.cu ``matmul_q8_bulk``): its time
at the denoiser's 64² and 32² projections (bf16, the chosen plan) beside copies of the
kernel with one part of the consumers' work taken out, built from patched copies of the
source under kernels/build/ (git-ignored):

  * ``no quantize``: x's bits go to wgmma as they are, unquantized;
  * ``no wgmma``: the A fragments are folded into the accumulators by integer operations;
  * ``no stores``: the rescaled rows are staged but not stored;
  * ``copies only``: the consumers neither read x nor store y (the producer's bulk
    copies, the ring's barriers and the epilogue's arithmetic remain);

and a device copy of x (x's bytes read and written once) as a yardstick. The patched
kernels compute wrong results on purpose; only the unpatched one is checked against the
plain version. Times are ``chip_smoke.cuda_time_ms`` (warm), the variants in turns.

    python3 scripts/k6_ablations.py      # on a CUDA GPU, from the repo root
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
import chip_smoke  # noqa: E402
import matmul_variants  # noqa: E402

QUANTIZE = ("          quantize_words<8>(v0, sc + k, r8, w0);\n"
            "          quantize_words<8>(v1, sc + k, r8, w1);\n")
RAW = ("          w0[0] = __float_as_uint(v0[0] + r8[0]), w0[1] = __float_as_uint(v0[4]);\n"
       "          w1[0] = __float_as_uint(v1[0]), w1[1] = __float_as_uint(v1[4]);\n")
WGMMA = "        wgmma_s8(acc, af[u], desc0 + (uint64_t)((gi * 4 + u) * 2048 / 16));"
FOLD = "        acc[u] ^= af[u][0] ^ af[u][1] ^ af[u][2] ^ af[u][3];"
STORES = "    for (int v = lane; v < rows * vpr; v += 32) {"
NO_STORES = "    for (int v = lane; v < 0; v += 32) {"
READ = "        if (ks < ksteps) {\n          const int k = ks * 32 + 8 * t;"
NO_READ = "        if (ks < 0) {\n          const int k = ks * 32 + 8 * t;"
PATCHES = {"kernel": [], "no quantize": [(QUANTIZE, RAW)], "no wgmma": [(WGMMA, FOLD)],
           "no stores": [(STORES, NO_STORES)],
           "copies only": [(READ, NO_READ), (STORES, NO_STORES)]}
SHAPES = [(131072, 128, 64), (32768, 128, 64)]


def build() -> dict:
    """One library per variant, compiled in parallel from patched copies of the source."""
    from diamond_tpu_torch import kernels

    src = (kernels.CSRC_DIR / "matmul_q8.cu").read_text()
    out = kernels.BUILD_DIR / "k6_ablations"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(kernels.CSRC_DIR / "q8_common.cuh", out / "q8_common.cuh")
    procs = {}
    for i, (name, patches) in enumerate(PATCHES.items()):
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"matmul_q8.cu no longer has the code {name!r} patches")
            text = text.replace(old, new)
        (out / f"v{i}.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out / f"v{i}.so"),
               str(out / f"v{i}.cu")]
        procs[name] = (i, subprocess.Popen(cmd))
    libs = {}
    for name, (i, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.matmul_q8_fwd.argtypes = list(kernels._SIGNATURES["matmul_q8_fwd"])
        lib.matmul_q8_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k6_ablations: no CUDA device", file=sys.stderr)
        return 1
    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.ops.matmul_plan import describe, matmul_plan

    libs = build()
    smi = chip_smoke.nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for m, k, n in SHAPES:
        x, wq, ws, am, b, wk = matmul_variants.inputs(m, k, n, gen)
        y = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
        p = matmul_plan(m, k, n, k, 2, 2, True)

        def run(lib):
            kernels.check(lib.matmul_q8_fwd(x.data_ptr(), am.data_ptr(), wk.data_ptr(),
                                            ws.data_ptr(), b.data_ptr(), y.data_ptr(),
                                            p.c_ints, torch.cuda.current_stream().cuda_stream),
                          "matmul_q8_fwd")

        run(libs["kernel"])
        torch.cuda.synchronize()
        ok &= torch.equal(y, ops.matmul_int8_plain(x, wq, ws, am, b, torch.bfloat16))
        times = {name: [] for name in libs}
        for turn in range(2):  # in turns, forwards then backwards
            for name, lib in list(libs.items())[::1 if turn == 0 else -1]:
                times[name].append(chip_smoke.cuda_time_ms(lambda lib=lib: run(lib)))
        xc = torch.empty_like(x)
        copy_ms = chip_smoke.cuda_time_ms(lambda: xc.copy_(x))
        bound = chip_smoke.bound("matmul_int8", (x, wq, ws, am, b, torch.bfloat16))[0]
        print(f"[ablation] ({m}, {k}, {n}) bf16, {describe(p)}: "
              + ", ".join(f"{name} {min(t) * 1e3:.2f} µs" for name, t in times.items())
              + f"; copy of x {copy_ms * 1e3:.2f} µs; bound {bound * 1e3:.2f} µs; on {smi}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
