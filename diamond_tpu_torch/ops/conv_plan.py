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
(``wgrad_plan``): input-channel slices of 16, tiles of whole image rows, a split of the
pixels over ``kblocks`` blocks per slice.

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
# K3's weight gradient (kernels/csrc/conv3x3_wgrad.cu), bf16 on the tensor cores

WGRAD_CH = 16          # input channels per block (a slice of Cin)
WGRAD_HALO_PX = 48     # bytes per halo pixel: 16 bf16 channels + 16 of padding
WGRAD_TILE_PX = 256    # pixels of whole image rows per tile, at most (one row if wider)
WGRAD_BLOCKS = 2 * NUM_SMS  # the grid: two blocks of 9 warps per SM


@dataclass(frozen=True)
class WgradPlan:
    """The ints conv3x3_wgrad.cu's ``WgradPlan`` reads, in this order."""
    B: int
    H: int
    W: int
    Cin: int
    Cout: int
    nt: int
    slices: int
    tr: int
    tiles_y: int
    tiles: int
    kblocks: int
    ksteps: int
    dy_stride: int
    halo_bytes: int
    smem: int
    grid: int
    c_ints: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        vals = [getattr(self, f) for f in WGRAD_FIELDS]
        object.__setattr__(self, "c_ints", (ctypes.c_int * len(vals))(*vals))


WGRAD_FIELDS = tuple(f.name for f in fields(WgradPlan) if f.name != "c_ints")


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int) -> WgradPlan:
    """The plan of one weight-gradient call on x (b, h, w, cin) and dy (b, h, w, cout):
    Cin in slices of 16 channels, Cout (at most 64) padded to nt = 16, 32 or 64, tiles
    of ``tr`` whole image rows (about 256 pixels), ``kblocks`` blocks per slice walking
    the tiles, each with the halo of x (its 16 channels) and dy in shared memory."""
    if cout > 64:
        raise ValueError(f"conv3x3_wgrad: Cout={cout} > 64 is not supported")
    nt = next(n for n in (16, 32, 64) if n >= cout)
    slices = _cdiv(cin, WGRAD_CH)
    tr = max(1, min(h, WGRAD_TILE_PX // w))
    tiles_y = _cdiv(h, tr)
    tiles = b * tiles_y
    ksteps = _cdiv(tr * w, 16)
    dy_stride = nt * 2 + 16
    halo_bytes = _align128((tr + 2) * (w + 2) * WGRAD_HALO_PX)
    smem = halo_bytes + ksteps * 16 * dy_stride
    if smem > SMEM_BLOCK:
        raise ValueError(f"conv3x3_wgrad: no plan fits shared memory at W={w}")
    kblocks = max(1, min(tiles, WGRAD_BLOCKS // slices))
    return WgradPlan(B=b, H=h, W=w, Cin=cin, Cout=cout, nt=nt, slices=slices, tr=tr,
                     tiles_y=tiles_y, tiles=tiles, kblocks=kblocks, ksteps=ksteps,
                     dy_stride=dy_stride, halo_bytes=halo_bytes, smem=smem,
                     grid=slices * kblocks)


def wgrad_plan_ok(p: WgradPlan) -> bool:
    """conv3x3_wgrad.cu ``wgrad_plan_ok``."""
    tile_px = p.tr * p.W
    return (p.B > 0 and p.H > 0 and p.W > 0 and p.Cin > 0 and 0 < p.Cout <= p.nt
            and p.nt in (16, 32, 64) and p.slices * WGRAD_CH >= p.Cin
            > (p.slices - 1) * WGRAD_CH and 1 <= p.tr <= p.H and p.tiles_y * p.tr >= p.H
            and p.tiles == p.B * p.tiles_y and 1 <= p.kblocks <= p.tiles
            and p.ksteps * 16 >= tile_px > (p.ksteps - 1) * 16
            and p.dy_stride == p.nt * 2 + 16
            and p.halo_bytes == _align128((p.tr + 2) * (p.W + 2) * WGRAD_HALO_PX)
            and p.smem == p.halo_bytes + p.ksteps * 16 * p.dy_stride <= SMEM_BLOCK
            and p.grid == p.slices * p.kblocks)


WGRAD_F32_SPLIT_BLOCKS = 2 * NUM_SMS


@functools.lru_cache(maxsize=None)
def wgrad_f32_split(b: int, h: int, w: int, cin: int, cout: int):
    """(splits, pixels per split) of the f32 weight gradient's K: enough 64 x 64 tiles of
    (tap, ci) x Cout times splits for two blocks per SM, each split a multiple of 16."""
    m = b * h * w
    tiles = _cdiv(9 * cin, 64) * _cdiv(cout, 64)
    per = _cdiv(_cdiv(m, max(1, WGRAD_F32_SPLIT_BLOCKS // tiles)), 16) * 16
    return _cdiv(m, per), per
