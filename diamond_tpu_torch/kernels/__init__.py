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
    # x, scale_shift, y, B, HW, C, G, silu, partials, S, span, threads, dtype, stream
    "adagn_silu_fwd": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _L, _I, _I, _P),
    # x, scale, bias, y, B, HW, C, G, silu, partials, S, span, threads, dtype, stream
    "groupnorm_silu_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _L, _I, _I, _P),
    # x, w, bias, y, B, H, W, Cin, Cout, stride, dtype, stream
    "conv3x3_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, mean, inv, gamma, beta, q, scale, amax, B, HW, C, S, span, threads, dtype, stream
    "norm_affine_silu_q8_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P),
    # x, scale_shift, act_max, q, B, HW, C, G, partials, S, span, threads, dtype, stream
    "adagn_silu_q8_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _L, _I, _I, _P),
    # x, scale, bias, act_max, q, B, HW, C, G, partials, S, span, threads, dtype, stream
    "groupnorm_silu_q8_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _L, _I, _I, _P),
    # x, x_dtype, act_max, w_q, w_scale, sample_scale, bias, y, out_dtype, B, H, W, Cin,
    # Cout, stride, stream
    "conv3x3_q8_fwd": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
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


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[str(dtype)]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}") from None
