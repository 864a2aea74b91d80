"""Launch plans of the Hopper 3x3 conv kernels: K3 in bf16 (ops/conv3x3.py) and K5 in
int8 (ops/conv3x3_q8.py), both kernels/csrc/conv_halo.cuh.

A plan fixes how a call is cut up: the tile (``tr`` whole output rows of one image, or
``tw`` pixels of one row where Wo is wider than the block), the warpgroups per block
(``wgs``, two; 64 output pixels each), the output channels per block (``nt``, one wgmma
N: 8, 16, 32 or 64, fitted to Cout, and halved while the grid would leave SMs idle),
the halo tile (``hr`` x ``hc`` input pixels of ``pxb`` bytes, channels zero-padded to
``cpad``), the halo buffers (``stages``: 2 where x is copied by cp.async, both fit and
a block walks more than one tile, so the next tile's halo loads during this one's
math), the dynamic shared memory, and the persistent grid (as many blocks as fit on
the card at once, a multiple of ``nslices``). The kernel checks the plan against its
own layout (``plan_ok``) and refuses one that disagrees.

K3's weight gradient (kernels/csrc/conv3x3_wgrad.cu) has a plan of its own
(``wgrad_plan``): (tap, ci) rows in wgmma M-tiles dealt to three warpgroups, channel
groups of up to 64, tiles of whole dy rows, a split of the pixels over ``kblocks``
blocks per group. So has the stride-2 data gradient (kernels/csrc/conv3x3_dgrad_s2.cu,
``dgrad_s2_plan``), with the parity classes' tap table ``S2_TAPS`` that its kernel checks.

Plans are pure functions of the call's shape, cached, and computed on the host, so the
CPU tests hold them to the card's limits.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field, fields

NUM_SMS = 132            # H100 SXM
SMEM_BLOCK = 232_448     # bytes of shared memory one block may use (227 KB)
SMEM_SM = 233_472        # bytes of shared memory per SM (228 KB), 1 KB of it kept per block
SMEM_RESERVED = 1_024
WGS = 2                  # warpgroups per block
MAX_BLOCKS_PER_SM = 2    # the kernel's launch bounds: 2 blocks of 256 threads, 128 registers


def _align128(v: int) -> int:
    return -(-v // 128) * 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ConvPlan:
    """The ints conv_halo.cuh's ``HaloPlan`` reads, in this order."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    stride: int
    Ho: int
    Wo: int
    cpad: int
    nt: int
    nslices: int
    wgs: int
    tr: int
    tw: int
    hr: int
    hc: int
    pxb: int
    stages: int
    tiles_y: int
    tiles_x: int
    tiles: int
    smem: int
    grid: int
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in PLAN_FIELDS]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))


PLAN_FIELDS = tuple(f.name for f in fields(ConvPlan) if f.name != "c_ints")


def smem_bytes(cpad: int, nt: int, hr: int, hc: int, pxb: int, stages: int, elem_bytes: int,
               quantize: bool, cin: int, wgs: int) -> int:
    """conv_halo.cuh ``halo_layout``: the weights, the halo ring (a buffer also stages
    the tile's accumulators, 64 * wgs rows of nt * 4 + 16 bytes), the quantizing scales
    and their reciprocals."""
    halo = max(hr * hc * pxb, 64 * wgs * (nt * 4 + 16))
    return (_align128(9 * cpad * nt * elem_bytes) + stages * _align128(halo)
            + (8 * cin if quantize else 0))


def channels_padded(cin: int, elem_bytes: int) -> int:
    """Cin rounded up to one wgmma K step: 16 bf16 or 32 int8 channels (32 bytes)."""
    ke = 32 // elem_bytes
    return _cdiv(cin, ke) * ke


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, h: int, w: int, cin: int, cout: int, stride: int, elem_bytes: int,
              quantize: bool) -> ConvPlan:
    """The plan of one call. ``elem_bytes``: 2 for K3's bf16 halo tile, 1 for K5's int8;
    ``quantize``: K5 quantizes a float x as it loads it. The rules were chosen by timing
    the alternatives on one H100 (PERF.md, PR 3); one plan per call shape is cached."""
    cpad = channels_padded(cin, elem_bytes)
    pxb = cpad * elem_bytes + 16
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    wgs = WGS  # two warpgroups share a halo tile, also where one would cover the image
    cap = 64 * wgs
    tw, tr = (wo, min(ho, cap // wo)) if wo <= cap else (cap, 1)
    tiles_y, tiles_x = _cdiv(ho, tr), _cdiv(wo, tw)
    tiles = b * tiles_y * tiles_x
    hr, hc = (tr - 1) * stride + 3, (tw - 1) * stride + 3

    def smem(n, s):
        return smem_bytes(cpad, n, hr, hc, pxb, s, elem_bytes, quantize, cin, wgs)

    nt = next(n for n in (8, 16, 32, 64) if n >= min(cout, 64))
    while nt > 16 and 2 * tiles * _cdiv(cout, nt) <= NUM_SMS:  # too few tiles: split Cout
        nt //= 2
    while nt > 8 and smem(nt, 1) > SMEM_BLOCK:
        nt //= 2
    if smem(nt, 1) > SMEM_BLOCK:
        raise ValueError(f"conv3x3: no plan fits shared memory at Cin={cin}, W={w}")
    nslices = _cdiv(cout, nt)

    def per_slice(s):
        per_sm = min(SMEM_SM // (smem(nt, s) + SMEM_RESERVED), MAX_BLOCKS_PER_SM)
        return max(1, min(tiles, per_sm * NUM_SMS // nslices))

    # a second halo buffer where it fits and a block has tiles to walk; not where the
    # threads load and quantize x, which a second buffer cannot overlap
    stages = 2 if not quantize and smem(nt, 2) <= SMEM_BLOCK and tiles > per_slice(2) else 1
    return ConvPlan(B=b, H=h, W=w, Cin=cin, Cout=cout, stride=stride, Ho=ho, Wo=wo, cpad=cpad,
                    nt=nt, nslices=nslices, wgs=wgs, tr=tr, tw=tw, hr=hr, hc=hc, pxb=pxb,
                    stages=stages, tiles_y=tiles_y, tiles_x=tiles_x, tiles=tiles,
                    smem=smem(nt, stages), grid=nslices * per_slice(stages))


def plan_ok(p: ConvPlan, elem_bytes: int, quantize: bool) -> bool:
    """conv_halo.cuh ``plan_ok``: a plan the kernel runs and its layout agrees with."""
    ke = 32 // elem_bytes
    total = smem_bytes(p.cpad, p.nt, p.hr, p.hc, p.pxb, p.stages, elem_bytes, quantize, p.Cin,
                       p.wgs)
    return (p.Ho == (p.H - 1) // p.stride + 1 and p.Wo == (p.W - 1) // p.stride + 1
            and p.cpad % ke == 0 and p.cpad >= p.Cin and p.wgs in (1, 2)
            and p.tr * p.tw <= 64 * p.wgs and (p.tw == p.Wo or p.tr == 1)
            and p.hr == (p.tr - 1) * p.stride + 3 and p.hc == (p.tw - 1) * p.stride + 3
            and p.pxb == p.cpad * elem_bytes + 16 and p.stages in (1, 2)
            and p.nslices * p.nt >= p.Cout and p.tiles_y * p.tr >= p.Ho
            and p.tiles_x * p.tw >= p.Wo and p.tiles == p.B * p.tiles_y * p.tiles_x
            and p.grid % p.nslices == 0 and p.grid > 0 and total <= p.smem <= SMEM_BLOCK)


def k3_plan(b, h, w, cin, cout, stride) -> ConvPlan:
    """K3's plan: a bf16 halo tile."""
    return conv_plan(b, h, w, cin, cout, stride, 2, False)


def k5_plan(b, h, w, cin, cout, stride, x_is_int8: bool) -> ConvPlan:
    """K5's plan: an int8 halo tile, from int8 codes or quantized from a float x as it
    loads."""
    return conv_plan(b, h, w, cin, cout, stride, 1, not x_is_int8)


# ---------------------------------------------------------------------------
# K3's weight gradient (kernels/csrc/conv3x3_wgrad.cu), bf16 on wgmma

WGRAD_WGS = 3          # warpgroups per block
WGRAD_THREADS = 128 * WGRAD_WGS
WGRAD_GROUP = 64       # input channels per block at most (a channel group)
WGRAD_TILE_PX = 256    # dy pixels of whole rows per tile, at most


@dataclass(frozen=True)
class WgradPlan:
    """The ints conv3x3_wgrad.cu's ``WgradPlan`` reads, in this order."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    stride: int
    Ho: int
    Wo: int
    cg: int
    ngroups: int
    mtiles: int
    mpw: int
    mgroups: int
    nt: int
    tr: int
    tiles_y: int
    tiles: int
    ksteps: int
    hr: int
    hc: int
    pxb: int
    halo_bytes: int
    dy_bytes: int
    stages: int
    cluster: int
    kblocks: int
    smem: int
    grid: int
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in WGRAD_FIELDS]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))

    @property
    def rows(self) -> int:
        """Rows of one partial: every M-tile slot of its blocks, 64 each."""
        return self.mgroups * WGRAD_WGS * self.mpw * 64

    @property
    def parts(self) -> int:
        """The partials: one per cluster of K splits and channel group."""
        return self.kblocks // self.cluster * self.ngroups


WGRAD_FIELDS = tuple(f.name for f in fields(WgradPlan) if f.name != "c_ints")


def _wgrad_smem(tr: int, stride: int, wo: int, pxb: int, nt: int, stages: int, mpw: int):
    """(halo rows, halo columns, halo bytes, dy bytes, shared memory) of a tile of tr
    dy rows: the halo of x and the tile's dy in core matrices, ``stages`` times; at
    least the block's accumulators staged for the cluster's sum (rows of nt + 4 floats)
    and the bias sums' scratch (8 floats per thread)."""
    hr, hc = (tr - 1) * stride + 3, (wo - 1) * stride + 3
    halo = _align128(hr * hc * pxb)
    dy = _cdiv(tr * wo, 16) * 16 * nt * 2
    staged = WGRAD_WGS * mpw * 64 * (nt + 4) * 4
    return hr, hc, halo, dy, max(stages * (halo + dy), staged, WGRAD_THREADS * 32)


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int, stride: int = 1) -> WgradPlan:
    """The plan of one weight-gradient call on x (b, h, w, cin) and dy (b, ho, wo, cout),
    the cotangent of the conv at ``stride``. The GEMM's rows are (tap, ci) with Cin
    padded to 16 and cut into ``ngroups`` channel groups of ``cg`` (at most 64): a
    group's 9 * cg rows are ``mtiles`` wgmma M-tiles of 64, dealt to 3 warpgroups,
    ``mpw`` each (so at Cin <= 32 one M-tile holds several taps), in one block or, where
    the K splits fill less than half the card, over ``mgroups`` blocks. N is Cout padded to
    ``nt`` (8, 16, 32 or 64), K the dy pixels: tiles of ``tr`` whole dy rows, the
    largest up to 256 pixels whose halo and dy fit two stages (else one); 512 pixels
    where the image gives each SM two such tiles and they fit two stages (narrow
    channels: Cin <= 32 or Cout = 3 at 64x64, 1.3-3.3 µs faster per call on an NVIDIA
    H100 80GB HBM3 at 700 W, scripts/time_conv_grads.py --explore). The grid holds
    one block per SM: ``kblocks`` per channel group, each walking the tiles kb, kb +
    kblocks, ...; ``cluster`` (2) neighbouring K splits sum their partials on chip, so
    kblocks is a multiple of it (clusters of 4 were slower: at one block per SM the card
    cannot place them all at once).

    One kernel takes every shape. The earlier mma.sync kernel (one warp per tap, slices
    of 16 channels) was faster at the 16x16 levels (9.0-15.0 against 12.0-16.3 µs per
    call) but is not kept: it would need its own bias sum, and the actor-critic step's
    weight gradient stays within 1.05x of it (1.292 against 1.262 ms per step; NVIDIA
    H100 80GB HBM3, 700 W, scripts/time_conv_grads.py). Cout > 64 is
    refused: three M-tiles per warpgroup hold 96 f32 accumulators a thread at N = 64,
    and the 192 of N = 128 do not fit beside the fragments."""
    if cout > 64:
        raise ValueError(f"conv3x3_wgrad: Cout={cout} > 64 is not supported")
    if stride not in (1, 2):
        raise ValueError(f"conv3x3_wgrad: stride must be 1 or 2, got {stride}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    nt = next(n for n in (8, 16, 32, 64) if n >= cout)
    cpad = _cdiv(cin, 16) * 16
    ngroups = _cdiv(cpad, WGRAD_GROUP)
    cg = _cdiv(_cdiv(cpad, ngroups), 16) * 16
    mtiles = _cdiv(9 * cg, 64)
    pxb = cg * 2 + 16
    def fits(t, s):
        return _wgrad_smem(t, stride, wo, pxb, nt, s, 3)[-1] <= SMEM_BLOCK

    top = max(1, min(ho, WGRAD_TILE_PX // wo))
    big = max(1, min(ho, 2 * WGRAD_TILE_PX // wo))
    if b * ho * wo >= 2 * WGRAD_TILE_PX * NUM_SMS and big > top and fits(big, 2):
        trs = (big,)  # a large image whose double tile fits two stages: half the tiles
    else:
        trs = range(top, 0, -1)
    choice = next(((t, s) for s in (2, 1) for t in trs if fits(t, s)), None)
    if choice is None:
        raise ValueError(f"conv3x3_wgrad: no plan fits shared memory at W={w}")
    tr, stages = choice
    tiles_y = _cdiv(ho, tr)
    tiles = b * tiles_y
    kblocks = min(tiles, max(1, NUM_SMS // ngroups))
    cluster = 2 if kblocks > 1 else 1
    kblocks = kblocks // cluster * cluster
    # the M-tiles over more blocks where the K splits fill less than half the card
    mgroups = 1 if 2 * kblocks * ngroups > NUM_SMS else min(
        _cdiv(mtiles, WGRAD_WGS), max(1, NUM_SMS // (kblocks * ngroups)))
    mpw = _cdiv(mtiles, WGRAD_WGS * mgroups)
    mgroups = _cdiv(mtiles, WGRAD_WGS * mpw)
    hr, hc, halo, dy, smem = _wgrad_smem(tr, stride, wo, pxb, nt, stages, mpw)
    return WgradPlan(B=b, H=h, W=w, Cin=cin, Cout=cout, stride=stride, Ho=ho, Wo=wo, cg=cg,
                     ngroups=ngroups, mtiles=mtiles, mpw=mpw, mgroups=mgroups, nt=nt, tr=tr,
                     tiles_y=tiles_y, tiles=tiles, ksteps=_cdiv(tr * wo, 16), hr=hr, hc=hc,
                     pxb=pxb, halo_bytes=halo, dy_bytes=dy, stages=stages, cluster=cluster,
                     kblocks=kblocks, smem=smem, grid=ngroups * kblocks * mgroups)


def wgrad_plan_ok(p: WgradPlan) -> bool:
    """conv3x3_wgrad.cu ``wgrad_plan_ok``."""
    hr, hc, halo, dy, smem = _wgrad_smem(p.tr, p.stride, p.Wo, p.pxb, p.nt, p.stages, p.mpw)
    return (p.B > 0 and p.H > 0 and p.W > 0 and p.Cin > 0 and 0 < p.Cout <= p.nt
            and p.stride in (1, 2) and p.Ho == (p.H - 1) // p.stride + 1
            and p.Wo == (p.W - 1) // p.stride + 1 and p.nt in (8, 16, 32, 64)
            and p.cg % 16 == 0 and 0 < p.cg <= WGRAD_GROUP
            and p.ngroups * p.cg >= p.Cin > (p.ngroups - 1) * p.cg
            and p.mtiles * 64 >= 9 * p.cg and p.mpw in (1, 2, 3) and p.mgroups >= 1
            and p.mgroups * WGRAD_WGS * p.mpw >= p.mtiles
            > (p.mgroups - 1) * WGRAD_WGS * p.mpw and 1 <= p.tr <= p.Ho
            and p.tiles_y * p.tr >= p.Ho and p.tiles == p.B * p.tiles_y
            and p.ksteps * 16 >= p.tr * p.Wo > (p.ksteps - 1) * 16
            and (p.hr, p.hc, p.halo_bytes, p.dy_bytes) == (hr, hc, halo, dy)
            and p.pxb == p.cg * 2 + 16 and p.stages in (1, 2) and p.cluster in (1, 2)
            and p.kblocks % p.cluster == 0 and 1 <= p.kblocks <= p.tiles
            and p.smem == smem <= SMEM_BLOCK
            and p.grid == p.ngroups * p.kblocks * p.mgroups)


WGRAD_F32_SPLIT_BLOCKS = 2 * NUM_SMS


@functools.lru_cache(maxsize=None)
def wgrad_f32_split(b: int, ho: int, wo: int, cin: int, cout: int):
    """(splits, dy pixels per split) of the f32 weight gradient's K (the B * Ho * Wo
    pixels of dy): enough 64 x 64 tiles of (tap, ci) x Cout times splits for two blocks
    per SM, each split a multiple of 16."""
    m = b * ho * wo
    tiles = _cdiv(9 * cin, 64) * _cdiv(cout, 64)
    per = _cdiv(_cdiv(m, max(1, WGRAD_F32_SPLIT_BLOCKS // tiles)), 16) * 16
    return _cdiv(m, per), per


# ---------------------------------------------------------------------------
# The stride-2 data gradient (kernels/csrc/conv3x3_dgrad_s2.cu)

# With pad 1, dx row 2i takes tap ky = 1 from dy row i; row 2i + 1 takes ky = 0 from dy
# row i + 1 and ky = 2 from row i; columns the same. (dy offset, tap) per parity:
_S2_AXIS = {0: ((0, 1),), 1: ((1, 0), (0, 2))}
S2_CLASSES = ((0, 0), (0, 1), (1, 0), (1, 1))
# Per parity class (py, px) of dx, in S2_CLASSES order: its taps (dy row offset, dy
# column offset, ky, kx): dx[2i + py, 2j + px] = sum over them of dy[i + ro, j + co] @
# w[ky, kx].T. 1, 2, 2 and 4 taps: 9 in all.
S2_TAPS = tuple(tuple((ro, co, ky, kx) for ro, ky in _S2_AXIS[py] for co, kx in _S2_AXIS[px])
                for py, px in S2_CLASSES)
S2_WGS = 2             # warpgroups per block, 64 class pixels each


@dataclass(frozen=True)
class DgradS2Plan:
    """The ints conv3x3_dgrad_s2.cu's ``S2Plan`` reads, in this order, then the tap
    table (S2_TAPS flattened, 36 ints)."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    Ho: int
    Wo: int
    kpad: int
    nt: int
    nslices: int
    tr: int
    tw: int
    hr: int
    hc: int
    pxb: int
    stages: int
    tiles_y: int
    tiles_x: int
    tiles: int
    w_bytes: int
    halo_bytes: int
    smem: int
    grid: int
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in S2_FIELDS] + [v for tap in sum(S2_TAPS, ())
                                                         for v in tap]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))


S2_FIELDS = tuple(f.name for f in fields(DgradS2Plan) if f.name != "c_ints")


def _s2_smem(kpad: int, nt: int, hr: int, hc: int, pxb: int, stages: int):
    """(weight bytes, halo bytes, shared memory): the block's weights (9 taps of kpad x nt,
    K-major), the dy halo ring, and each warp's staging rows (16 x (nt * 2 + 16) bytes)."""
    wb = 9 * kpad * nt * 2
    halo = _align128(hr * hc * pxb)
    return wb, halo, wb + stages * halo + 4 * S2_WGS * 16 * (nt * 2 + 16)


@functools.lru_cache(maxsize=None)
def dgrad_s2_plan(b: int, h: int, w: int, cin: int, cout: int) -> DgradS2Plan:
    """The plan of one stride-2 data-gradient call: dy (b, ho, wo, cout) of the conv of x
    (b, h, w, cin) with w (3, 3, cin, cout). Per parity class the GEMM is M = the class's
    pixels (at most the dy grid's ho x wo), N = Cin, K = its taps x Cout. A tile is tr
    whole dy-grid rows (tw = wo) or tw pixels of one row, at most 128 pixels (64 per
    warpgroup); its halo is the dy pixels (tr + 1) x (tw + 1) with Cout padded to kpad.
    N per block (``nt``) is fitted to Cin and halved while the grid would leave SMs idle;
    the weights of the block's slice stay in shared memory."""
    if cout > 64 * 4:
        raise ValueError(f"conv3x3_dgrad_s2: Cout={cout} > 256 is not supported")
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    cap = 64 * S2_WGS
    tw, tr = (wo, min(ho, cap // wo)) if wo <= cap else (cap, 1)
    tiles_y, tiles_x = _cdiv(ho, tr), _cdiv(wo, tw)
    tiles = b * tiles_y * tiles_x
    kpad = _cdiv(cout, 16) * 16
    pxb = kpad * 2 + 16
    hr, hc = tr + 1, tw + 1

    def smem(n, s):
        return _s2_smem(kpad, n, hr, hc, pxb, s)[-1]

    nt = next(n for n in (8, 16, 32, 64) if n >= min(cin, 64))
    while nt > 16 and 2 * tiles * _cdiv(cin, nt) <= NUM_SMS:  # too few tiles: split Cin
        nt //= 2
    while nt > 8 and smem(nt, 1) > SMEM_BLOCK:
        nt //= 2
    if smem(nt, 1) > SMEM_BLOCK:
        raise ValueError(f"conv3x3_dgrad_s2: no plan fits shared memory at Cout={cout}")
    nslices = _cdiv(cin, nt)

    def per_slice(s):
        per_sm = min(SMEM_SM // (smem(nt, s) + SMEM_RESERVED), MAX_BLOCKS_PER_SM)
        return max(1, min(tiles, per_sm * NUM_SMS // nslices))

    stages = 2 if smem(nt, 2) <= SMEM_BLOCK and tiles > per_slice(2) else 1
    wb, halo, total = _s2_smem(kpad, nt, hr, hc, pxb, stages)
    return DgradS2Plan(B=b, H=h, W=w, Cin=cin, Cout=cout, Ho=ho, Wo=wo, kpad=kpad, nt=nt,
                       nslices=nslices, tr=tr, tw=tw, hr=hr, hc=hc, pxb=pxb, stages=stages,
                       tiles_y=tiles_y, tiles_x=tiles_x, tiles=tiles, w_bytes=wb,
                       halo_bytes=halo, smem=total, grid=nslices * per_slice(stages))


def dgrad_s2_plan_ok(p: DgradS2Plan) -> bool:
    """conv3x3_dgrad_s2.cu ``s2_plan_ok`` (the tap table included)."""
    wb, halo, total = _s2_smem(p.kpad, p.nt, p.hr, p.hc, p.pxb, p.stages)
    taps = list(p.c_ints)[len(S2_FIELDS):]
    return (p.Ho == (p.H - 1) // 2 + 1 and p.Wo == (p.W - 1) // 2 + 1
            and p.kpad % 16 == 0 and p.Cout <= p.kpad < p.Cout + 16
            and p.nt in (8, 16, 32, 64) and p.nslices * p.nt >= p.Cin
            and p.tr * p.tw <= 64 * S2_WGS and (p.tw == p.Wo or p.tr == 1)
            and p.hr == p.tr + 1 and p.hc == p.tw + 1 and p.pxb == p.kpad * 2 + 16
            and p.stages in (1, 2) and p.tiles_y * p.tr >= p.Ho and p.tiles_x * p.tw >= p.Wo
            and p.tiles == p.B * p.tiles_y * p.tiles_x and p.grid % p.nslices == 0
            and p.grid > 0 and (p.w_bytes, p.halo_bytes, p.smem) == (wb, halo, total)
            and total <= SMEM_BLOCK
            and taps == [v for tap in sum(S2_TAPS, ()) for v in tap])
