"""The host side of the Hopper 3x3 conv kernels (K3 bf16, K5 int8): the launch plans of
diamond_tpu_torch/ops/conv_plan.py, the tile and halo geometry they imply, and K5's
K-major weight copy with its place beside the int8 collection. The kernels themselves
run on a card (tests/test_torch_cuda.py); these checks need none."""

import numpy as np
import pytest
import torch

from diamond_tpu_torch.interop import jax_vars
from diamond_tpu_torch.models.blocks import Conv3x3
from diamond_tpu_torch.ops import conv_plan, kmajor_weights, quant
from diamond_tpu_torch.ops.conv_plan import k3_plan, k5_plan, plan_ok

# Every 3x3 conv signature of the full-size rollout at B = 32 (PERF.md's per-signature
# tables): (H, Cin, Cout, stride) of x (B, H, H, Cin).
ROLLOUT = [(64, 64, 64, 1), (64, 128, 64, 1), (8, 64, 64, 1), (32, 64, 64, 1), (64, 64, 3, 1),
           (32, 128, 64, 1), (16, 64, 64, 1), (8, 128, 64, 1), (16, 128, 64, 1),
           (64, 32, 32, 1), (64, 64, 64, 2), (32, 64, 64, 2), (16, 64, 64, 2), (64, 6, 32, 1),
           (8, 32, 32, 1), (32, 32, 32, 1), (16, 32, 32, 1), (64, 32, 32, 2), (16, 32, 32, 2),
           (32, 32, 32, 2), (64, 12, 64, 1), (64, 3, 64, 1), (64, 3, 32, 1), (16, 32, 64, 1)]
# Ragged cases: odd H with stride 2, M not a multiple of a tile, B = 1, rows wider than a
# block (several tiles per row), Cout = 3 and 24, Cin = 3, 6 and 12.
RAGGED = [(2, 9, 9, 32, 24, 2), (3, 5, 5, 16, 32, 1), (1, 64, 64, 64, 64, 1), (2, 33, 33, 64, 3, 1),
          (1, 4, 150, 16, 8, 1), (1, 5, 7, 6, 3, 2), (2, 9, 9, 12, 32, 1), (1, 8, 8, 3, 24, 2)]
KINDS = {"k3": (2, False), "k5_int8": (1, False), "k5_float": (1, True)}


def _plan(kind, b, h, w, cin, cout, stride):
    if kind == "k3":
        return k3_plan(b, h, w, cin, cout, stride)
    return k5_plan(b, h, w, cin, cout, stride, kind == "k5_int8")


def _cases():
    for kind in KINDS:
        for h, cin, cout, s in ROLLOUT:
            yield kind, (32, h, h, cin, cout, s)
        for sig in RAGGED:
            yield kind, sig


@pytest.mark.parametrize("kind,sig", list(_cases()))
def test_plan_fits_the_card_and_the_kernel(kind, sig):
    """The plan agrees with the kernel's own check (conv_halo.cuh plan_ok), stays within a
    block's 227 KB of shared memory, uses a wgmma N the kernel has, and launches a
    persistent grid: a multiple of the N slices, no more blocks than work items, and no
    more than fit on 132 SMs at once."""
    elem_bytes, quantize = KINDS[kind]
    p = _plan(kind, *sig)
    assert plan_ok(p, elem_bytes, quantize)
    assert p.smem <= conv_plan.SMEM_BLOCK == 232_448
    assert p.nt in (8, 16, 32, 64) and p.nt * p.nslices >= p.Cout > p.nt * (p.nslices - 1)
    assert p.grid % p.nslices == 0 and p.grid <= p.tiles * p.nslices
    per_sm = min(conv_plan.SMEM_SM // (p.smem + conv_plan.SMEM_RESERVED),
                 conv_plan.MAX_BLOCKS_PER_SM)
    assert p.grid <= max(p.nslices, per_sm * conv_plan.NUM_SMS)
    assert list(p.c_ints) == [getattr(p, f) for f in conv_plan.PLAN_FIELDS]


@pytest.mark.parametrize("kind,sig", [(k, s) for k in KINDS for s in RAGGED]
                         + [("k3", (32, 8, 8, 64, 64, 1)), ("k5_int8", (32, 64, 64, 64, 64, 2))])
def test_tiles_cover_every_output_pixel_once_and_read_inside_the_halo(kind, sig):
    """The kernel's mapping, replayed: tile t of image b covers output rows oy0.. and
    columns ox0.. whose pixels are consecutive in M; each warpgroup row reads, for every
    tap, a halo pixel inside the hr x hc tile, which is the input pixel the conv needs
    (or lies outside the image: the zero padding)."""
    b, h, w, cin, cout, s = sig
    p = _plan(kind, *sig)
    seen = np.zeros(b * p.Ho * p.Wo, dtype=np.int64)
    for t in range(p.tiles):
        bi, r = divmod(t, p.tiles_y * p.tiles_x)
        ty, tx = divmod(r, p.tiles_x)
        oy0, ox0 = ty * p.tr, tx * p.tw
        npix = (min(p.tr, p.Ho - oy0) * p.Wo if p.tw == p.Wo else min(p.tw, p.Wo - ox0))
        assert 0 < npix <= 64 * p.wgs
        m0 = bi * p.Ho * p.Wo + oy0 * p.Wo + ox0
        for row in range(npix):
            py, px = divmod(row, p.tw)
            oy, ox = oy0 + py, ox0 + px
            assert m0 + row == bi * p.Ho * p.Wo + oy * p.Wo + ox  # consecutive in M
            seen[m0 + row] += 1
            for ky in range(3):
                for kx in range(3):
                    hy, hx = py * s + ky, px * s + kx
                    assert hy < p.hr and hx < p.hc
                    iy, ix = ty * p.tr * s - 1 + hy, tx * p.tw * s - 1 + hx
                    assert (iy, ix) == (oy * s - 1 + ky, ox * s - 1 + kx)
    assert (seen == 1).all()


@pytest.mark.parametrize("hc", [3, 9, 65, 127, 129])
def test_stride2_halo_columns_even_first(hc):
    """At stride 2 the halo stores its even columns, then its odd ones: a bijection onto
    the hc slots, under which the taps kx = 0, 1, 2 of neighbouring output pixels land
    on neighbouring slots (bank-conflict-free ldmatrix rows)."""
    half = (hc + 1) // 2
    slot = [(hx & 1) * half + (hx >> 1) for hx in range(hc)]
    assert sorted(slot) == list(range(hc))
    for kx in range(3):
        cols = [slot[2 * px + kx] for px in range((hc - 3) // 2 + 1)]
        assert cols == list(range(cols[0], cols[0] + len(cols)))


def test_small_images_split_cout_and_large_ones_keep_it():
    """At 8x8 and B = 32 a block per image leaves most SMs idle, so Cout is split into
    slices (here 4 of 16 channels); at 64x64 the tiles fill the card with Cout whole."""
    small, large = k3_plan(32, 8, 8, 64, 64, 1), k3_plan(32, 64, 64, 64, 64, 1)
    assert (small.nt, small.nslices) == (16, 4) and small.grid == 128
    assert (large.nt, large.nslices, large.wgs) == (64, 1, 2)
    assert k3_plan(32, 64, 64, 64, 3, 1).nt == 8  # Cout = 3: N = 8, not 64


def test_plan_refuses_a_call_that_does_not_fit_shared_memory():
    with pytest.raises(ValueError):
        conv_plan.conv_plan(1, 8, 8, 4096, 8, 1, 2, False)


@pytest.mark.parametrize("cin,cout", [(64, 64), (6, 32), (16, 24), (128, 3)])
def test_kmajor_weights_is_w_q_transposed(cin, cout):
    """Row n of the copy holds w_q[ky, kx, :, n] at columns (3 ky + kx) * cpad .. + Cin,
    zeros in the padded channels (cpad = Cin rounded up to 32) and padded rows."""
    rng = np.random.default_rng(0)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))
    wk = kmajor_weights(wq)
    cpad = -(-cin // 32) * 32
    assert wk.dtype == torch.int8 and wk.is_contiguous()
    assert tuple(wk.shape) == (-(-cout // 8) * 8, 9 * cpad)
    grid = wk[:cout].reshape(cout, 3, 3, cpad)
    assert torch.equal(grid[..., :cin], wq.permute(3, 0, 1, 2))
    assert not grid[..., cin:].any() and not wk[cout:].any()


def _site(cin=16, cout=24, seed=0):
    """A module tree with one 3x3 site, ``tree.conv``, and that site's collection."""
    tree = torch.nn.Module()
    tree.conv = Conv3x3(cin, cout, dtype=torch.float32)
    with torch.no_grad():
        tree.conv.reset_parameters(torch.Generator().manual_seed(seed))
    am = torch.rand(cin, generator=torch.Generator().manual_seed(seed)) + 0.5
    wq, ws = quant.fold_quantize_weight(tree.conv.kernel.detach(), am)
    return tree, {"conv": {"act_scale": am, "w_q": wq, "w_scale": ws}}


def test_install_makes_the_kmajor_copy_outside_state_and_collection():
    """``quant.install`` gives a 3x3 site its K-major copy ``w_k`` as a non-persistent
    buffer: the state dict keys stay the parameters, the collection stays act_scale /
    w_q / w_scale, and the weight bridge's round trip is unchanged; ``strip`` drops it."""
    tree, coll = _site()
    keys = set(tree.state_dict())
    quant.install(tree, coll)
    assert torch.equal(tree.conv.w_k, kmajor_weights(coll["conv"]["w_q"]))
    assert set(tree.state_dict()) == keys
    assert set(quant.collection(tree)["conv"]) == {"act_scale", "w_q", "w_scale"}
    variables = jax_vars.module_to_variables(tree)
    assert set(variables["quant"]["conv"]) == {"act_scale", "w_q", "w_scale"}
    twin = jax_vars.load_variables(_site(seed=1)[0], variables)
    assert torch.equal(twin.conv.w_k, tree.conv.w_k)
    assert set(twin.state_dict()) == keys
    quant.strip(tree)
    assert tree.conv.w_k is None and tree.conv.w_q is None


def test_int8_conv_takes_the_installed_copy_or_makes_one():
    """On the CPU the wrapper runs the plain version either way; the site with its
    installed copy and the op with one made per call give the same result."""
    tree, coll = _site()
    quant.install(tree, coll)
    x = torch.randn(2, 9, 9, 16, generator=torch.Generator().manual_seed(2))
    with quant.int8_scope(True), torch.no_grad():
        y = tree.conv(x)
    c = coll["conv"]
    ref = quant.conv3x3_q8_static(x, tree.conv.kernel, c["act_scale"], 1, c["w_q"], c["w_scale"],
                                  tree.conv.bias, torch.float32)
    assert torch.equal(y, ref)


# K3's weight gradient (kernels/csrc/conv3x3_wgrad.cu): every (H, Cin, Cout, stride) of x
# (32, H, H, Cin) that the denoiser and actor-critic train steps send it, then ragged
# sizes (B, H, W, Cin, Cout, stride).
WGRAD_STEPS = [(64, 128, 64, 1), (64, 64, 64, 1), (64, 64, 64, 2), (64, 15, 64, 1),
               (64, 64, 3, 1), (32, 128, 64, 1), (32, 64, 64, 1), (32, 64, 64, 2),
               (16, 128, 64, 1), (16, 64, 64, 1), (16, 64, 64, 2), (8, 128, 64, 1),
               (8, 64, 64, 1), (64, 3, 32, 1), (64, 32, 32, 1), (32, 32, 32, 1),
               (16, 32, 64, 1)]
WGRAD_RAGGED = [(2, 7, 9, 32, 24, 1), (2, 7, 9, 32, 24, 2), (2, 9, 6, 16, 3, 2),
                (3, 5, 7, 3, 32, 1), (3, 5, 7, 128, 64, 2), (1, 3, 300, 48, 8, 1)]


@pytest.mark.parametrize("sig", [(32, h, h, ci, co, s) for h, ci, co, s in WGRAD_STEPS]
                         + WGRAD_RAGGED, ids=str)
def test_wgrad_plan_covers_every_dy_pixel_once_and_reads_inside_the_halo(sig):
    """The weight gradient's plan fits the card (the kernel's own check, 227 KB of shared
    memory, one block per SM); the tiles of its blocks cover every dy pixel of every
    image exactly once; and every lane's A address (each M-tile slot's tap shift and
    channel chunk, each K step's pixel, stride 2's even-first halo columns) lies inside
    the halo buffer of its tile."""
    from diamond_tpu_torch.ops.conv_plan import WGRAD_WGS, wgrad_plan, wgrad_plan_ok

    b, h, w, cin, cout, s = sig
    p = wgrad_plan(b, h, w, cin, cout, s)
    assert wgrad_plan_ok(p) and p.smem <= conv_plan.SMEM_BLOCK
    assert p.grid <= conv_plan.NUM_SMS or p.kblocks == 1
    hits = np.zeros((b, p.Ho * p.Wo), int)
    for kb in range(p.kblocks):
        for tile in range(kb, p.tiles, p.kblocks):
            bb, y0 = divmod(tile, p.tiles_y)
            y0 *= p.tr
            hits[bb, y0 * p.Wo:min(y0 + p.tr, p.Ho) * p.Wo] += 1
    assert (hits == 1).all()
    cpt, half = p.cg // 8, (p.hc + 1) // 2
    lanes = np.arange(32)
    mi = lanes >> 3
    a_px = (mi >> 1) * 8 + (lanes & 7)
    for y0 in range(0, p.Ho, p.tr):
        tile_px = min(p.tr, p.Ho - y0) * p.Wo
        for st in range(p.ksteps):
            k = st * 16 + a_px
            k = np.where(k < tile_px, k, 0)
            pix = (k // p.Wo * s * p.hc + k % p.Wo) * p.pxb
            for wg, j, mg in np.ndindex(WGRAD_WGS, p.mpw, p.mgroups):
                mt = mg * WGRAD_WGS * p.mpw + wg + WGRAD_WGS * j
                assert mt * 64 < p.rows
                for warp in range(4):
                    chunk = mt * 8 + warp * 2 + (mi & 1)
                    chunk = np.where(chunk < 9 * cpt, chunk, 0)
                    tap, cc = chunk // cpt, chunk % cpt
                    ky, kx = tap // 3, tap % 3
                    koff = kx if s == 1 else np.choose(kx, [0, half, 1])
                    addr = pix + (ky * p.hc + koff) * p.pxb + cc * 16
                    assert addr.min() >= 0 and (addr + 16).max() <= p.hr * p.hc * p.pxb
