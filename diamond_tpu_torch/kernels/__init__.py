"""Build and bind the package's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``), all of them at once in
parallel processes, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use, never at import, into
``kernels/build/`` (git-ignored), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Every entry point returns ``cudaGetLastError()`` after its launches; ``check`` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    # x, scale_shift, aff_dtype, y, moments (or null), silu, plan (ops/norm_plan.py), stream
    "adagn_silu_fwd": (_P, _P, _I, _P, _P, _I, _P, _P),
    # x, scale, bias, aff_dtype, y, moments (or null), silu, plan, stream
    "groupnorm_silu_fwd": (_P, _P, _P, _I, _P, _P, _I, _P, _P),
    # x, w, bias, y, plan (ops/conv_plan.py), stream
    "conv3x3_bf16_fwd": (_P, _P, _P, _P, _P, _P),
    # x, w, bias, y, B, H, W, Cin, Cout, stride, stream
    "conv3x3_f32_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, mean, inv, gamma, beta, q, scale, amax, B, HW, C, S, span, threads, dtype, stream
    "norm_affine_silu_q8_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P),
    # x, scale_shift, aff_dtype, act_max, q, plan, stream
    "adagn_silu_q8_fwd": (_P, _P, _I, _P, _P, _P, _P),
    # x, scale, bias, aff_dtype, act_max, q, plan, stream
    "groupnorm_silu_q8_fwd": (_P, _P, _P, _I, _P, _P, _P, _P),
    # x, x_dtype, act_max, w_k, w_scale, sample_scale, bias, y, out_dtype, plan, stream
    "conv3x3_q8_fwd": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P),
    # the same, plan: ops/conv_plan.py PIPE_FIELDS (K5's pipeline route)
    "conv3x3_q8_pipe_fwd": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P),
    # x, act_max, w_k, w_scale, bias, y, plan (ops/matmul_plan.py), stream
    "matmul_q8_fwd": (_P, _P, _P, _P, _P, _P, _P, _P),
    # x, x_dtype, numel, partial maxima (scratch), q, scale, B, stream
    "absmax_quantize_q8_fwd": (_P, _I, _L, _P, _P, _P, _I, _P),
    # x, dy, moments, scale, bias, aff_dtype, dx, dsb, rows, ticket, silu,
    # plan (norm_plan.bwd_plan), stream
    "groupnorm_silu_bwd": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P),
    # x, dy, moments, scale_shift, aff_dtype, dx, dss, silu, plan (norm_plan.bwd_plan), stream
    "adagn_silu_bwd": (_P, _P, _P, _P, _I, _P, _P, _I, _P, _P),
    # x, dy, part, pdb, dw, db, plan (conv_plan.wgrad_plan), stream
    "conv3x3_wgrad_bf16": (_P, _P, _P, _P, _P, _P, _P, _P),
    # x, dy, part, pdb, dw, db, B, H, W, Cin, Cout, stride, splits, pixels per split, stream
    "conv3x3_wgrad_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _P),
    # dy, w, dx, plan (conv_plan.dgrad_s2_plan), stream
    "conv3x3_dgrad_s2_bf16": (_P, _P, _P, _P, _P),
    # dy, w, dx, B, H, W, Cin, Cout, stream
    "conv3x3_dgrad_s2_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # plan: the clusters of the norm kernels the card can run at once (K1/K2, K4 static)
    "gn_max_clusters": (_P,),
    "gn_q8_max_clusters": (_P,),
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdiamond_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _run(procs) -> None:
    """Wait for every (cmd, process); raise with the compiler's output if one failed."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile every source into one library unless a build of these exact sources
    exists: one nvcc per source, all started together, then one link. Returns the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(procs)
    tmp = out.with_name(f"{tag}.so.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream(device) -> int:
    """The handle of the current CUDA stream on ``device``, as the entry points take it:
    ``torch.cuda.current_stream(device).cuda_stream`` without making a Stream object,
    which costs a few µs of host time a launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[str(dtype)]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}") from None
