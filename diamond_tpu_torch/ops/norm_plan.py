"""Launch plans of the fused GroupNorm kernels: K1/K2 (ops/fused_norms.py) and K4's
static epilogue (ops/fused_q8.py), one kernel template in kernels/csrc/gn_common.cuh.

A call is one launch of B thread-block clusters, one cluster of ``n`` blocks per sample:
n = 1, 2, 4 or 8, the smallest that leaves at most BLOCK_BYTES of x to a block, and 16
(a non-portable cluster size) where 8 blocks would hold more than WIDE_BYTES each (bf16
64x64x128: 64 KB blocks, three to an SM, instead of 128 KB blocks of which clusters of 8
fill only 120 SMs at once). The rules were chosen by timing n = 1 to 16 at the rollout's
shapes on one H100 SXM (scripts/norm_variants.py). A card that cannot place a cluster of
16 such blocks in one GPC (fewer SMs per GPC, a partition of a card) gets the 8-block
plan instead: the wrapper asks the card once per plan (ops/fused_norms.py
``placed_plan``), so the plans here stay functions of the shape alone.

Block r of a cluster owns the ``ppb`` whole pixels [r * ppb, (r + 1) * ppb) of its
sample (the last block what is left). It copies the first ``rpx`` of them into shared
memory with bulk copies in ``chunks`` pieces of ``cpx`` pixels, each on its own
barrier, so the statistics of one piece run
while the next lands; where all of its pixels fit (``resident``, every shape of the
rollout in bf16 and f32), x is read from device memory once. Where they do not (a
sample beyond 16 blocks' shared memory, f32 64x64x256 for one), the rest of the span is
read from device memory in the statistics pass and again in the apply pass. A block has
``threads`` threads, the largest multiple of C / V up to 256 (V = 16-byte vector width),
and a chunk is a whole number of steps of threads * V elements, so each thread keeps the
same V channels. Besides x, a block's dynamic shared memory holds C floats (K4's 1/s_c)
and the n ranks' G partial moments.

The backward kernels of K2 and K1 (one template, kernels/csrc/gn_bwd.cu) run on their
forward's plan with x and dy both in shared memory (``bwd_plan``): the same clusters and
pixel spans, so that they recompute the forward's moments bit for bit. K1's backward
sums each sample's FiLM gradient inside its cluster, in the per-thread sums' space, so
it needs no shared memory beyond K2's.

Plans are pure functions of the call's shape and dtype, cached, and computed on the
host, so the CPU tests hold them to the card's limits. The kernel checks the plan
against its own layout (``plan_ok``, gn_common.cuh ``norm_plan_ok``) and refuses one
that disagrees.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field, fields, replace

SMEM_BLOCK = 232_448     # bytes of shared memory one block may use (227 KB)
SMEM_STATIC = 4_096      # the kernel's static shared memory (sums, moments, barriers), at most
SMEM_DYNAMIC = SMEM_BLOCK - SMEM_STATIC  # gn_common.cuh kSmemDynamic
MAX_THREADS = 256        # gn_common.cuh kMaxThreads
MAX_GROUPS = 64          # gn_common.cuh kMaxGroups
MAX_CLUSTER = 16         # gn_common.cuh kMaxCluster (above 8: a non-portable cluster size)
PORTABLE_CLUSTER = 8
MAX_CHUNKS = 8           # gn_common.cuh kMaxChunks: barriers per block
BLOCK_BYTES = 16 * 1024  # a sample is split until a block holds at most this much x ...
WIDE_BYTES = 64 * 1024   # ... or, at 8 blocks, at most this much; beyond it, 16 blocks
CHUNK_BYTES = 16 * 1024  # the size of one bulk copy, in whole steps


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class NormPlan:
    """The ints gn_common.cuh's ``NormPlan`` reads, in this order."""
    B: int
    HW: int
    C: int
    G: int
    elem_bytes: int
    vec: int
    threads: int
    n: int
    ppb: int
    rpx: int
    cpx: int
    chunks: int
    smem: int
    resident: int
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in PLAN_FIELDS]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))

    @property
    def blocks(self) -> int:
        return self.B * self.n

    @property
    def step_px(self) -> int:
        """Pixels of one step of threads * V elements."""
        return self.threads * self.vec // self.C


PLAN_FIELDS = tuple(f.name for f in fields(NormPlan) if f.name != "c_ints")


def check_shape(c: int, g: int, elem_bytes: int) -> None:
    """Raise ValueError on what the kernel does not take: 16-byte vectors along C that
    stay inside one group, at most 64 groups, C / V at most 256."""
    vec = 16 // elem_bytes
    if (elem_bytes not in (2, 4) or g < 1 or g > MAX_GROUPS or c % vec or c % g
            or (c // g) % vec or c // vec > MAX_THREADS):
        raise ValueError(f"fused GroupNorm: unsupported C={c}, groups={g} for "
                         f"{elem_bytes}-byte elements")


@functools.lru_cache(maxsize=None)
def plan_for(b: int, hw: int, c: int, g: int, elem_bytes: int, n: int) -> NormPlan:
    """The plan of one call with ``n`` blocks per sample."""
    check_shape(c, g, elem_bytes)
    vec = 16 // elem_bytes
    cv = c // vec
    threads = MAX_THREADS // cv * cv
    step_px = threads // cv
    pix = c * elem_bytes
    n = max(1, min(n, hw))
    ppb = _cdiv(hw, n)
    n = _cdiv(hw, ppb)  # no block without pixels
    extra = 4 * c + 8 * n * g  # K4's 1/s_c per channel, every rank's partials
    fit = (SMEM_DYNAMIC - extra) // pix // step_px * step_px
    rpx = min(ppb, fit)
    cpx = max(1, _cdiv(CHUNK_BYTES, pix * step_px)) * step_px
    if _cdiv(rpx, cpx) > MAX_CHUNKS:
        cpx = _cdiv(_cdiv(rpx, MAX_CHUNKS), step_px) * step_px
    return NormPlan(B=b, HW=hw, C=c, G=g, elem_bytes=elem_bytes, vec=vec, threads=threads, n=n,
                    ppb=ppb, rpx=rpx, cpx=cpx, chunks=_cdiv(rpx, cpx), smem=rpx * pix + extra,
                    resident=int(rpx == ppb))


@functools.lru_cache(maxsize=None)
def norm_plan(b: int, hw: int, c: int, g: int, elem_bytes: int) -> NormPlan:
    """The plan of a call on x (b, H, W, c) with H * W = hw, ``g`` groups and
    ``elem_bytes``-byte elements (4 float32, 2 bfloat16)."""
    sample = hw * c * elem_bytes
    n = 1
    while n < PORTABLE_CLUSTER and sample > n * BLOCK_BYTES:
        n *= 2
    if sample > n * WIDE_BYTES:
        n = MAX_CLUSTER
    return plan_for(b, hw, c, g, elem_bytes, n)


def bwd_extra(p: NormPlan) -> int:
    """The backward's dynamic shared memory besides x and dy: both rounds' partials of
    every rank, and each thread's per-channel sums (gn_bwd.cu ``gn_bwd_smem``)."""
    return 16 * p.n * p.G + 8 * p.threads * p.vec


@functools.lru_cache(maxsize=None)
def bwd_plan(p: NormPlan) -> NormPlan:
    """The K2 and K1 backwards' plan (kernels/csrc/gn_bwd.cu) for the forward plan ``p``: the
    same clusters, blocks, threads and pixel spans, so that it recomputes the forward's
    moments bit for bit, with x and dy both in shared memory: ``rpx`` pixels of each
    (all of the span where they fit), in ``chunks`` copies of ``cpx`` pixels of both."""
    pix = p.C * p.elem_bytes
    step_px = p.step_px
    fit = (SMEM_DYNAMIC - bwd_extra(p)) // (2 * pix) // step_px * step_px
    if fit < step_px:
        raise ValueError(f"fused GroupNorm backward: C={p.C} does not fit shared memory")
    rpx = min(p.ppb, fit)
    cpx = max(1, _cdiv(CHUNK_BYTES, pix * step_px)) * step_px
    if _cdiv(rpx, cpx) > MAX_CHUNKS:
        cpx = _cdiv(_cdiv(rpx, MAX_CHUNKS), step_px) * step_px
    return replace(p, rpx=rpx, cpx=cpx, chunks=_cdiv(rpx, cpx),
                   smem=2 * rpx * pix + bwd_extra(p), resident=int(rpx == p.ppb))


def bwd_plan_ok(p: NormPlan) -> bool:
    """gn_bwd.cu ``norm_bwd_plan_ok``: the forward's layout, with x and dy on chip."""
    return (_layout_ok(p)
            and 2 * p.rpx * p.C * p.elem_bytes + bwd_extra(p) <= p.smem <= SMEM_DYNAMIC)


def _layout_ok(p: NormPlan) -> bool:
    """The layout rules of gn_common.cuh ``norm_plan_ok`` but its shared-memory bound."""
    vec = 16 // p.elem_bytes if p.elem_bytes in (2, 4) else 0
    if (not vec or p.vec != vec or p.B < 1 or p.HW < 1 or p.G < 1 or p.G > MAX_GROUPS
            or p.C % vec or p.C % p.G or (p.C // p.G) % vec):
        return False
    cv = p.C // vec
    if p.threads < 32 or p.threads > MAX_THREADS or p.threads % cv:
        return False
    step_px = p.threads // cv
    return (1 <= p.n <= MAX_CLUSTER and p.n * p.ppb >= p.HW > (p.n - 1) * p.ppb
            and 1 <= p.rpx <= p.ppb and p.resident == int(p.rpx == p.ppb)
            and p.cpx >= 1 and p.cpx % step_px == 0 and p.chunks == _cdiv(p.rpx, p.cpx)
            and p.chunks <= MAX_CHUNKS)


def plan_ok(p: NormPlan) -> bool:
    """gn_common.cuh ``norm_plan_ok``: a plan the kernel runs and its layout agrees with."""
    return (_layout_ok(p)
            and p.rpx * p.C * p.elem_bytes + 4 * p.C + 8 * p.n * p.G <= p.smem <= SMEM_DYNAMIC)
