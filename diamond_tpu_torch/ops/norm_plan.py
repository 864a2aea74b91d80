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

The backward kernels of K2 and K1 (one template, kernels/csrc/gn_bwd.cu) have a plan of
their own (``bwd_plan``): they read the moments the forward saved, so nothing ties them to
the forward's clusters. Its choices, each timed against its alternatives on one H100 SXM
(NVIDIA H100 80GB HBM3, 700 W; scripts/time_norm_grads.py --explore, bf16, B = 32, µs
per call; PERF.md has the tables):
  * n = 1, 2, 4 or 8 blocks per sample (portable clusters only), the smallest that
    leaves a block at most BWD_BLOCK_BYTES of x and dy. At 64x64 n = 8 (K1 64x64x64:
    28.0 against 37.7 at n = 4 and 59.8 at n = 2); at 8x8 and 16x16 the choice moves
    little (K1 8x8x64: 4.7-4.8 for n = 1 to 8; K2 16x16x32: 7.6-7.9), the cluster
    exchange costing what the smaller spans save.
  * A block's shared memory is that of BWD_BLOCKS_PER_SM = 4 blocks an SM (their
    registers fit three): x and dy of at most ``rpx`` pixels, the rest of the span read
    from device memory (kept in L2 by the kernel's cache policies). At 64x64 more on
    chip is slower, not faster (K1 64x64x64: 28.0 with 128 of each block's 512 pixels on
    chip, 29.2 with 192, 37.2 with 352, 35.5 with all 512, where one block fills an SM
    and 256 blocks take two waves; 64x64x128: 62.4 with 64 of 512, 62.9 with 96); at
    32x32x64 all of a span fits (10.4).
  * ``threads``: as many as the span has vectors, up to 256; a chunk of ``cpx`` pixels
    of both x and dy per bulk copy (CHUNK_BYTES each: chunks of a quarter to twice that
    size moved no time by more than 0.9).

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
# The backward (kernels/csrc/gn_bwd.cu): its own plan, on portable clusters
SMEM_SM = 233_472        # shared memory one SM's blocks share (228 KB) ...
SMEM_RESERVED = 1_024    # ... of which the card keeps 1 KB per block
BWD_STATIC = 3_072       # gn_bwd.cu's static shared memory, at most
BWD_CLUSTER = 8          # blocks per sample, at most (a portable cluster)
BWD_BLOCKS_PER_SM = 4    # blocks whose shared memory fits one SM
BWD_BLOCK_BYTES = 16 * 1024  # x and dy per block, at most, where 8 blocks suffice


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


def bwd_budget(blocks_per_sm: int) -> int:
    """The dynamic shared memory a backward block may take so that ``blocks_per_sm`` of
    them share an SM (each also holds its static part and the card's 1 KB)."""
    return min(SMEM_DYNAMIC, (SMEM_SM // blocks_per_sm - SMEM_RESERVED - BWD_STATIC) // 128 * 128)


def bwd_smem(p: NormPlan) -> int:
    """gn_bwd.cu ``gn_bwd_smem``: x's and dy's on-chip spans, the threads' per-channel
    sums ([2][threads][V] f32), the n ranks' G partials, and where n > 1 the n ranks'
    sums of the channels the block finishes (c with c % n == rank, of the 2C)."""
    recv = 4 * p.n * _cdiv(2 * p.C, p.n) if p.n > 1 else 0
    return (_cdiv(2 * p.rpx * p.C * p.elem_bytes, 16) * 16 + 8 * p.threads * p.vec
            + 8 * p.n * p.G + _cdiv(recv, 16) * 16)


@functools.lru_cache(maxsize=None)
def bwd_plan_for(b: int, hw: int, c: int, g: int, elem_bytes: int, n: int,
                 blocks_per_sm: int) -> NormPlan:
    """The backward plan of one call with ``n`` blocks per sample (at most 8) and shared
    memory for ``blocks_per_sm`` blocks on an SM: ``rpx`` pixels of x and dy on chip
    (all of the span where they fit), in ``chunks`` copies of ``cpx`` pixels of both;
    as many threads as the span has vectors, up to 256."""
    check_shape(c, g, elem_bytes)
    vec = 16 // elem_bytes
    cv = c // vec
    n = max(1, min(n, hw, BWD_CLUSTER))
    ppb = _cdiv(hw, n)
    n = _cdiv(hw, ppb)  # no block without pixels
    per_px = max(min(MAX_THREADS // cv, ppb), _cdiv(32, cv))  # pixels of one step
    threads = per_px * cv
    if threads > MAX_THREADS:
        raise ValueError(f"fused GroupNorm backward: C={c}, groups={g} need {threads} threads")
    pix = c * elem_bytes
    budget = (bwd_budget(blocks_per_sm) - 8 * threads * vec - 8 * n * g
              - 4 * n * _cdiv(2 * c, n) - 16)
    fit = budget // (2 * pix)
    if fit >= per_px:
        fit = fit // per_px * per_px  # whole steps on chip
    if fit < 1:
        raise ValueError(f"fused GroupNorm backward: C={c} does not fit {blocks_per_sm} "
                         "blocks per SM")
    rpx = min(ppb, fit)
    cpx = max(1, _cdiv(CHUNK_BYTES, pix * per_px)) * per_px
    if _cdiv(rpx, cpx) > MAX_CHUNKS:
        cpx = _cdiv(_cdiv(rpx, MAX_CHUNKS), per_px) * per_px
    p = NormPlan(B=b, HW=hw, C=c, G=g, elem_bytes=elem_bytes, vec=vec, threads=threads, n=n,
                 ppb=ppb, rpx=rpx, cpx=cpx, chunks=_cdiv(rpx, cpx), smem=0,
                 resident=int(rpx == ppb))
    return replace(p, smem=bwd_smem(p))


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, hw: int, c: int, g: int, elem_bytes: int) -> NormPlan:
    """The K2 and K1 backwards' plan (kernels/csrc/gn_bwd.cu) of a call on x (b, H, W, c)
    with H * W = hw: n = 1, 2, 4 or 8 blocks per sample, the smallest that leaves a block
    at most BWD_BLOCK_BYTES of x and dy, and the shared memory of BWD_BLOCKS_PER_SM blocks
    on an SM each."""
    sample = 2 * hw * c * elem_bytes
    n = 1
    while n < BWD_CLUSTER and sample > n * BWD_BLOCK_BYTES:
        n *= 2
    return bwd_plan_for(b, hw, c, g, elem_bytes, n, BWD_BLOCKS_PER_SM)


def bwd_plan_ok(p: NormPlan) -> bool:
    """gn_bwd.cu ``norm_bwd_plan_ok``: a backward plan the kernel runs."""
    return (_layout_ok(p) and p.n <= BWD_CLUSTER and p.threads >= p.G
            and p.smem == bwd_smem(p) and p.smem <= SMEM_DYNAMIC)


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
