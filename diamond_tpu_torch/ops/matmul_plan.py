"""Launch plans of K6, the int8 product with static activation scales
(ops/matmul_q8.py, kernels/csrc/matmul_q8.cu).

A plan is one of two variants of the kernel, with its tiles and grid:

* ``BULK`` (M >= BULK_MIN_M: the denoiser's up-path projections at 64² and 32²): a
  persistent grid, BULK_BLOCKS_PER_SM blocks an SM, each walking 64-row tiles of one
  64-column tile of y. A producer warp copies x's rows into a ring of ``stages`` tiles
  in shared memory with one bulk copy (``cp.async.bulk``) a row, each tile completing
  on its own mbarrier; one consumer warpgroup quantizes straight from the ring into
  wgmma's A registers, runs s8 wgmma m64n64k32 against the block's column tile of the
  weights (staged once, K rounded up to ``wstride``, a group of four K steps), hands the
  slot back, and stages the rescaled rows for 16-byte stores. It takes x rows the bulk
  copy can move (a 16-byte aligned base, row stride and row length), K <= BULK_MAX_K,
  and y rows of whole 16-byte vectors.
* ``SMALL`` (everything else): one tile of ``bm`` rows by ``bn`` columns a block (warps
  of 16 rows by ``nt`` 8-column mma.sync tiles), its K walked in chunks of ``kc``
  channels: x and the weights copied into shared memory by every thread (``cp.async``
  of 16 bytes where x's rows allow it, ``vec``, else element by element), act_max,
  w_scale and the bias loaded in the same round, x quantized once into int8 codes in
  shared memory, then the mma. Where K >= SPLIT_MIN_K and the tiles leave SMs idle, K is
  split over a thread-block cluster of ``split`` blocks (``kspan`` channels each); the
  int32 partials are summed through distributed shared memory by the cluster's first
  block, which alone runs the epilogue (int32 sums are exact in any order).

The rules, chosen by timing the alternatives at the paths' shapes on one H100
(scripts/matmul_variants.py; PERF.md §6 has the times):
  * BULK where M >= BULK_MIN_M and x and y allow it (at M = 8,192 the small variant's
    tiles were faster), with the deepest ring (at most MAX_STAGES) that keeps
    BULK_BLOCKS_PER_SM blocks an SM: more blocks an SM beat a deeper ring;
  * SMALL otherwise: ``bn`` = 64 columns (N rounded up to 8 below that), ``bm`` the
    largest of 64, 32 or 16 rows that still gives every SM a block (16 where none
    does), ``nt`` as few 8-column tiles a warp as keep the block within MAX_WARPS;
    ``split`` doubled (up to MAX_CLUSTER, a portable cluster) while the blocks number
    fewer than the SMs and each rank keeps at least SPLIT_MIN_SPAN channels.

Plans are pure functions of the call's shape, dtypes, row stride and x's alignment,
cached, and computed on the host, so the CPU tests hold them to the card's limits. The
kernel checks the plan against its own layout (``matmul_plan_ok``) and refuses one that
disagrees.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field, fields

NUM_SMS = 132             # H100 SXM
SMEM_BLOCK = 232_448      # bytes of shared memory one block may use (227 KB)
K_STEP = 32               # the int8 mma's K step: w_k's rows are zero-padded to a multiple
SMALL, BULK = 0, 1
BULK_MIN_M = 16_384       # rows from which a call takes the persistent pipeline
BULK_MAX_K = 512          # the column tile of the weights a bulk block keeps (64 x 512)
BULK_ROWS = 64            # rows of a bulk tile: one warpgroup's wgmma M
BULK_COLS = 64            # columns of a bulk tile: its wgmma N
MAX_STAGES = 4            # ring slots of x tiles
MIN_STAGES = 2
MAX_WARPS = 8             # warps of a SMALL block
MAX_CHUNK = 256           # channels a SMALL block holds in shared memory at once
SPLIT_MIN_K = 512         # K from which a SMALL call may split K over a cluster
SPLIT_MIN_SPAN = 128      # channels each rank of a split keeps, at least
MAX_CLUSTER = 8           # a portable cluster
BARRIER_BYTES = 128       # the bulk variant's mbarriers (2 * MAX_STAGES + 1 of 8 bytes)
SMEM_SM = 233_472         # shared memory one SM's blocks share (228 KB) ...
SMEM_RESERVED = 1_024     # ... of which the card keeps 1 KB per block
BULK_BLOCKS_PER_SM = 3    # the bulk kernel's launch bounds: three 160-thread blocks an SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(v: int, a: int = 128) -> int:
    return _cdiv(v, a) * a


@dataclass(frozen=True)
class MatmulPlan:
    """The ints matmul_q8.cu's ``MatmulPlan`` reads, in this order."""
    M: int
    K: int
    N: int
    ldx: int
    x_bytes: int      # 4 float32, 2 bfloat16
    out_bytes: int
    variant: int      # SMALL or BULK
    vec: int          # x's rows taken by 16-byte copies
    bm: int           # rows of a tile
    bn: int           # columns of a tile
    nt: int           # 8-column mma tiles a warp
    warps: int        # SMALL: all warps; BULK: the consumer warps (one producer more)
    threads: int
    kp: int           # w_k's row length: K rounded up to 32
    kc: int           # channels of a chunk in shared memory
    split: int        # cluster size along K (1: no split)
    kspan: int        # channels of each rank of the cluster
    stages: int       # BULK: ring slots
    xstride: int      # bytes of a row of x in shared memory
    qstride: int      # SMALL: bytes of a row of x's codes in shared memory
    wstride: int      # bytes of a row of the weights in shared memory
    ystride: int      # BULK: bytes of a row of the staged output tile
    row_tiles: int
    col_tiles: int
    grid: int         # blocks launched
    smem: int         # dynamic shared memory, bytes
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in PLAN_FIELDS]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


PLAN_FIELDS = tuple(f.name for f in fields(MatmulPlan) if f.name != "c_ints")


def bulk_strides(kp: int, x_bytes: int, out_bytes: int):
    """(xstride, wstride, ystride) of the bulk variant: x's rows in the ring, padded so
    that a lane (g, t), reading 8 channels of rows g and g + 8, hits distinct banks (16
    bytes of bf16: rows 64 bytes apart modulo 128; two 16-byte reads of f32: 16 modulo
    32); the weights' K (``wstride`` channels: kp rounded up to a group of four wgmma K
    steps); the staged output rows, 8 outputs longer than the tile so that a lane's pair
    of rows g and g + 8 hits distinct banks."""
    xb = kp * x_bytes
    xstride = (xb + 64 if xb % 128 == 0 else xb) if x_bytes == 2 else xb + 16
    return xstride, _align(kp), (BULK_COLS + 8) * out_bytes


def bulk_smem(kp: int, stages: int, x_bytes: int, out_bytes: int) -> int:
    """matmul_q8.cu ``bulk_layout``: barriers, scales and reciprocals, the column tile's
    w_scale and bias, its weights, the ring of x tiles and each consumer warp's output
    stage."""
    xs, ws, ys = bulk_strides(kp, x_bytes, out_bytes)
    return (BARRIER_BYTES + _align(8 * kp) + _align(8 * BULK_COLS) + BULK_COLS * ws
            + stages * _align(BULK_ROWS * xs) + _align(BULK_ROWS * ys))


def bulk_blocks_per_sm(smem: int) -> int:
    """Bulk blocks an SM holds at once: as many as the kernel's launch bounds promise
    registers for and shared memory (SMEM_SM, less SMEM_RESERVED a block) takes."""
    return max(1, min(BULK_BLOCKS_PER_SM, SMEM_SM // (smem + SMEM_RESERVED)))


def small_strides(kc: int, x_bytes: int):
    """(xstride, qstride, wstride) of the small variant: rows of raw x, of its codes and
    of the weights, 16 bytes longer than their chunk, so that the mma's fragment reads
    (lane (g, t): row g, word t) fall in distinct banks."""
    return kc * x_bytes + 16, kc + 16, kc + 16


def small_smem(kc: int, bm: int, bn: int, split: int, x_bytes: int) -> int:
    """matmul_q8.cu ``small_layout``: scales and reciprocals, the weights' chunk, raw x,
    its codes, and the int32 partials a split sums."""
    xs, qs, ws = small_strides(kc, x_bytes)
    return (_align(8 * kc) + _align(bn * ws) + _align(bm * xs) + _align(bm * qs)
            + (_align(bm * bn * 4) if split > 1 else 0))


def x_vec(k: int, ldx: int, x_bytes: int, aligned: bool) -> bool:
    """x's rows can be moved by 16-byte copies: an aligned base, row stride and length."""
    return aligned and (ldx * x_bytes) % 16 == 0 and (k * x_bytes) % 16 == 0


def _bulk_plan(m, k, n, ldx, x_bytes, out_bytes, stages=None):
    kp = _cdiv(k, K_STEP) * K_STEP
    col_tiles = _cdiv(n, BULK_COLS)

    def smem(s):
        return bulk_smem(kp, s, x_bytes, out_bytes)

    if stages is None:  # the deepest ring that keeps the blocks an SM holds
        most = bulk_blocks_per_sm(smem(MIN_STAGES))
        stages = max(s for s in range(MIN_STAGES, MAX_STAGES + 1)
                     if s == MIN_STAGES or bulk_blocks_per_sm(smem(s)) == most)
    row_tiles = _cdiv(m, BULK_ROWS)
    xs, ws, ys = bulk_strides(kp, x_bytes, out_bytes)
    per_sm = bulk_blocks_per_sm(smem(stages))
    grid = col_tiles * min(row_tiles, max(1, per_sm * NUM_SMS // col_tiles))
    return MatmulPlan(M=m, K=k, N=n, ldx=ldx, x_bytes=x_bytes, out_bytes=out_bytes,
                      variant=BULK, vec=1, bm=BULK_ROWS, bn=BULK_COLS, nt=BULK_COLS // 8,
                      warps=BULK_ROWS // 16, threads=32 * (BULK_ROWS // 16 + 1), kp=kp,
                      kc=kp, split=1, kspan=kp, stages=stages, xstride=xs, qstride=0,
                      wstride=ws, ystride=ys, row_tiles=row_tiles, col_tiles=col_tiles,
                      grid=grid, smem=smem(stages))


def _small_plan(m, k, n, ldx, x_bytes, out_bytes, vec, bm=None, split=None):
    kp = _cdiv(k, K_STEP) * K_STEP
    bn = min(64, _cdiv(n, 8) * 8)
    if bm is None:  # the largest tile that still gives every SM a block
        bm = next((b for b in (64, 32) if _cdiv(m, b) * _cdiv(n, bn) >= NUM_SMS), 16)
    # the fewest 8-column tiles a warp that keep the block within MAX_WARPS; the column
    # tile is rounded up to whole warps
    nt = next(t for t in (1, 2, 4) if (bm // 16) * _cdiv(bn // 8, t) <= MAX_WARPS)
    bn = _cdiv(bn, 8 * nt) * 8 * nt
    row_tiles, col_tiles = _cdiv(m, bm), _cdiv(n, bn)
    blocks = row_tiles * col_tiles
    if split is None:
        split = 1
        if kp >= SPLIT_MIN_K:
            while (split < MAX_CLUSTER and blocks * split < NUM_SMS
                   and kp // (2 * split) >= SPLIT_MIN_SPAN):
                split *= 2
    kspan = _cdiv(kp // K_STEP, split) * K_STEP
    split = _cdiv(kp, kspan)  # every rank gets channels
    kc = min(kspan, MAX_CHUNK)
    warps = (bm // 16) * (bn // 8 // nt)
    xs, qs, ws = small_strides(kc, x_bytes)
    return MatmulPlan(M=m, K=k, N=n, ldx=ldx, x_bytes=x_bytes, out_bytes=out_bytes,
                      variant=SMALL, vec=int(vec), bm=bm, bn=bn, nt=nt, warps=warps,
                      threads=32 * warps, kp=kp, kc=kc, split=split, kspan=kspan, stages=1,
                      xstride=xs, qstride=qs, wstride=ws, ystride=0, row_tiles=row_tiles,
                      col_tiles=col_tiles, grid=blocks * split,
                      smem=small_smem(kc, bm, bn, split, x_bytes))


def _check_call(m, k, n, ldx, x_bytes, out_bytes):
    if m <= 0 or k <= 0 or n <= 0 or x_bytes not in (2, 4) or out_bytes not in (2, 4):
        raise ValueError(f"matmul_q8: no plan for M={m}, K={k}, N={n}, "
                         f"{x_bytes}-byte x, {out_bytes}-byte y")
    if ldx < k and m > 1:
        raise ValueError(f"matmul_q8: row stride {ldx} < K={k}")
    if m >= 2 ** 31 or ldx >= 2 ** 31:
        raise ValueError(f"matmul_q8: M={m}, row stride {ldx} beyond the kernel's range")


def bulk_takes(m: int, k: int, n: int, ldx: int, x_bytes: int, out_bytes: int,
               aligned: bool) -> bool:
    """The bulk variant can run the call: x's rows move by bulk copies, the weights' column
    tile fits, y's rows are whole 16-byte vectors."""
    return (x_vec(k, ldx, x_bytes, aligned) and k <= BULK_MAX_K
            and (n * out_bytes) % 16 == 0)


@functools.lru_cache(maxsize=None)
def matmul_plan(m: int, k: int, n: int, ldx: int, x_bytes: int, out_bytes: int,
                aligned: bool = True) -> MatmulPlan:
    """The plan of one call: x (M rows of K channels, ``ldx`` elements apart, of
    ``x_bytes``; ``aligned``: its base is 16-byte aligned) -> y (M, N) of ``out_bytes``.
    Raises ValueError on a shape no plan takes."""
    _check_call(m, k, n, ldx, x_bytes, out_bytes)
    if m >= BULK_MIN_M and bulk_takes(m, k, n, ldx, x_bytes, out_bytes, aligned):
        return _bulk_plan(m, k, n, ldx, x_bytes, out_bytes)
    plan = _small_plan(m, k, n, ldx, x_bytes, out_bytes, x_vec(k, ldx, x_bytes, aligned))
    if plan.smem > SMEM_BLOCK:
        raise ValueError(f"matmul_q8: no plan fits shared memory at M={m}, K={k}, N={n}")
    return plan


def plan_for(m: int, k: int, n: int, ldx: int, x_bytes: int, out_bytes: int, aligned: bool,
             variant: int, bm=None, split=None, stages=None) -> MatmulPlan:
    """A plan of the given variant with the given rows a tile, split or stages (the rules'
    choice for what is None): the alternatives scripts/matmul_variants.py times."""
    _check_call(m, k, n, ldx, x_bytes, out_bytes)
    if variant == BULK:
        if not bulk_takes(m, k, n, ldx, x_bytes, out_bytes, aligned):
            raise ValueError(f"matmul_q8: the bulk variant cannot take M={m}, K={k}, N={n}")
        return _bulk_plan(m, k, n, ldx, x_bytes, out_bytes, stages)
    return _small_plan(m, k, n, ldx, x_bytes, out_bytes, x_vec(k, ldx, x_bytes, aligned), bm,
                       split)


def plan_ok(p: MatmulPlan) -> bool:
    """matmul_q8.cu ``matmul_plan_ok``: a plan the kernel runs and its layout agrees with."""
    kp = _cdiv(p.K, K_STEP) * K_STEP
    common = (p.M > 0 and p.K > 0 and p.N > 0 and p.kp == kp and p.x_bytes in (2, 4)
              and p.out_bytes in (2, 4) and (p.ldx >= p.K or p.M == 1)
              and p.bn % 8 == 0 and 8 <= p.bn <= 64 and p.bm % 16 == 0
              and p.row_tiles * p.bm >= p.M and (p.row_tiles - 1) * p.bm < p.M
              and p.col_tiles * p.bn >= p.N and (p.col_tiles - 1) * p.bn < p.N
              and 0 < p.smem <= SMEM_BLOCK)
    if not common:
        return False
    if p.variant == BULK:
        return (p.vec == 1 and x_vec(p.K, p.ldx, p.x_bytes, True) and p.kp <= BULK_MAX_K
                and p.bm == BULK_ROWS and p.bn == BULK_COLS and p.warps == BULK_ROWS // 16
                and p.threads == 32 * (p.warps + 1) and p.nt == 8 and p.kc == p.kp
                and p.split == 1 and MIN_STAGES <= p.stages <= MAX_STAGES
                and (p.xstride, p.wstride, p.ystride)
                == bulk_strides(p.kp, p.x_bytes, p.out_bytes)
                and (p.N * p.out_bytes) % 16 == 0 and p.grid % p.col_tiles == 0
                and p.col_tiles <= p.grid <= p.tiles
                and p.smem == bulk_smem(p.kp, p.stages, p.x_bytes, p.out_bytes))
    tiles8 = p.bn // 8
    return (p.variant == SMALL and p.vec in (0, int(x_vec(p.K, p.ldx, p.x_bytes, True)))
            and p.bm in (16, 32, 64) and p.nt in (1, 2, 4)
            and tiles8 % p.nt == 0 and p.warps == (p.bm // 16) * (tiles8 // p.nt)
            and p.warps <= MAX_WARPS and p.threads == 32 * p.warps
            and 1 <= p.split <= MAX_CLUSTER and p.kspan % K_STEP == 0
            and p.split * p.kspan >= p.kp and (p.split - 1) * p.kspan < p.kp
            and p.kc % K_STEP == 0 and 0 < p.kc <= min(p.kspan, MAX_CHUNK)
            and (p.xstride, p.qstride, p.wstride) == small_strides(p.kc, p.x_bytes)
            and p.grid == p.tiles * p.split
            and p.smem == small_smem(p.kc, p.bm, p.bn, p.split, p.x_bytes))


def describe(p: MatmulPlan) -> str:
    """The plan in a few words, as chip_smoke.py prints it beside a K6 row."""
    if p.variant == BULK:
        return (f"bulk {p.bm}x{p.bn} tiles, {p.stages} stages, {p.grid} persistent blocks "
                f"of {p.threads} threads")
    return (f"small {p.bm}x{p.bn} tiles, {p.nt} mma tiles a warp, "
            + (f"split-K cluster of {p.split} ({p.kspan} channels each), " if p.split > 1
               else "") + f"{p.grid} blocks of {p.threads} threads")
