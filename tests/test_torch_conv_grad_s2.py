"""The stride-2 data gradient of the 3x3 conv on the CPU (kernels/csrc/conv3x3_dgrad_s2.cu
runs on a card, tests/test_torch_cuda.py): the parity-class tap table of
diamond_tpu_torch/ops/conv_plan.py (``S2_TAPS``) rebuilt into the gradient with four
small ``F.conv2d`` calls and held to JAX's ``jax.vjp`` of the stride-2
``lax.conv_general_dilated``; the launch plan (``dgrad_s2_plan``) at the denoiser's
Downsample signatures and ragged sizes; and the kernel's data flow replayed in numpy."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diamond_tpu_torch.ops import conv3x3_dgrad_plain, conv3x3_dgrad_s2
from diamond_tpu_torch.ops.conv_plan import (S2_CLASSES, S2_FIELDS, S2_TAPS, S2_WGS, SMEM_BLOCK,
                                             dgrad_s2_plan, dgrad_s2_plan_ok)

from torch_port_util import t

# (B, H, W, Cin, Cout) of the stride-2 convs: the denoiser's Downsample at B = 32 (x 64,
# 32 and 16 wide, 64 channels), then ragged sizes (odd H and W, Cin != Cout, Cout = 3,
# 15 and 24, Cin = 3 and 128).
DENOISER_S2 = [(32, 64, 64, 64, 64), (32, 32, 32, 64, 64), (32, 16, 16, 64, 64)]
RAGGED_S2 = [(2, 7, 9, 32, 24), (2, 9, 6, 16, 3), (3, 5, 7, 3, 32), (2, 9, 9, 128, 15),
             (1, 8, 8, 24, 40), (1, 3, 300, 16, 8)]


def _rel_close(a, b, share):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= share * max(np.abs(b).max(), 1e-30), np.abs(a - b).max()


def parity_rebuild(dy: torch.Tensor, w: torch.Tensor, hw) -> torch.Tensor:
    """dx of the stride-2 conv from S2_TAPS: per parity class (py, px) one F.conv2d of dy
    (zero-padded by one row and column at the far end) with a 2x2 kernel holding w's
    unflipped taps at their dy offsets, scattered to dx[:, py::2, px::2]."""
    h, wd = hw
    b, ho, wo, cout = dy.shape
    cin = w.shape[2]
    dyp = F.pad(dy.permute(0, 3, 1, 2), (0, 1, 0, 1))
    dx = dy.new_zeros((b, cin, h, wd))
    for (py, px), taps in zip(S2_CLASSES, S2_TAPS):
        k = dy.new_zeros((cin, cout, 2, 2))
        for ro, co, ky, kx in taps:
            k[:, :, ro, co] = w[ky, kx]
        out = F.conv2d(dyp, k)  # (b, cin, ho, wo)
        part = dx[:, :, py::2, px::2]
        part.copy_(out[:, :, :part.shape[2], :part.shape[3]])
    return dx.permute(0, 2, 3, 1)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 24), (1, 7, 9, 6, 5), (3, 9, 6, 12, 4)])
def test_parity_rebuild_matches_jax_vjp_of_the_stride2_conv(b, h, w, cin, cout):
    """The tap table rebuilds dx: four small convs of dy with w's taps as they are, against
    JAX's VJP of lax.conv_general_dilated at stride 2, padding ((1, 1), (1, 1)), f32,
    within 1e-5 of the largest |value| (the same products, summed in another order); and
    the plain data gradient (the interleave route) agrees."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / (3 * cin ** 0.5)).astype(np.float32)
    dy = rng.normal(size=(b, (h + 1) // 2, (w + 1) // 2, cout)).astype(np.float32)
    conv = lambda x_: jax.lax.conv_general_dilated(  # noqa: E731
        x_, k, (2, 2), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(conv, x)
    (dx,) = vjp(jnp.asarray(dy))
    _rel_close(parity_rebuild(t(dy), t(k), (h, w)).numpy(), dx, 1e-5)
    _rel_close(conv3x3_dgrad_plain(t(dy), t(k), 2, (h, w)).numpy(), dx, 1e-5)
    _rel_close(conv3x3_dgrad_s2(t(dy), t(k), (h, w)).numpy(), dx, 1e-5)


def test_tap_table_holds_nine_taps_each_once():
    """1, 2, 2 and 4 taps for the classes (0, 0), (0, 1), (1, 0), (1, 1); every (ky, kx)
    once; each tap maps its dy pixel onto the class's dx pixel."""
    assert [len(ts) for ts in S2_TAPS] == [1, 2, 2, 4]
    assert sorted((ky, kx) for ts in S2_TAPS for _, _, ky, kx in ts) == [
        (ky, kx) for ky in range(3) for kx in range(3)]
    for (py, px), ts in zip(S2_CLASSES, S2_TAPS):
        for ro, co, ky, kx in ts:
            # dx row 2i + py reads dy row i + ro through tap ky: 2 (i + ro) + ky - 1 = 2i + py
            assert 2 * ro + ky - 1 == py and 2 * co + kx - 1 == px


@pytest.mark.parametrize("sig", DENOISER_S2 + RAGGED_S2, ids=str)
def test_plan_fits_and_its_tiles_cover_every_dx_pixel_once_inside_the_halo(sig):
    """The plan agrees with the kernel's check (tap table included), fits a block's shared
    memory and launches whole N slices; its tiles, with the four classes, write every dx
    pixel exactly once, and every tap of every tile pixel reads inside the tile's halo."""
    b, h, w, cin, cout = sig
    p = dgrad_s2_plan(*sig)
    assert dgrad_s2_plan_ok(p) and p.smem <= SMEM_BLOCK
    assert p.nt * p.nslices >= cin > p.nt * (p.nslices - 1) and p.grid % p.nslices == 0
    assert list(p.c_ints)[:len(S2_FIELDS)] == [getattr(p, f) for f in S2_FIELDS]
    hits = np.zeros((b, h, w), int)
    for tile in range(p.tiles):
        bb, r = divmod(tile, p.tiles_y * p.tiles_x)
        ty, tx = divmod(r, p.tiles_x)
        i0, j0 = ty * p.tr, tx * p.tw
        for m in range(64 * S2_WGS):
            ti, tj = divmod(m, p.tw)
            i, j = i0 + ti, j0 + tj
            if ti >= p.tr or i >= p.Ho or j >= p.Wo or tj >= p.tw:
                continue
            for (py, px), taps in zip(S2_CLASSES, S2_TAPS):
                for ro, co, _, _ in taps:
                    assert ti + ro < p.hr and tj + co < p.hc
                if 2 * i + py < h and 2 * j + px < w:
                    hits[bb, 2 * i + py, 2 * j + px] += 1
    assert (hits == 1).all()


def test_plan_refuses_what_the_kernel_does_not_take():
    p = dgrad_s2_plan(32, 64, 64, 64, 64)
    assert not dgrad_s2_plan_ok(replace(p, smem=p.smem + 128))
    assert not dgrad_s2_plan_ok(replace(p, hr=p.hr + 1))
    bad = replace(p)
    bad.c_ints[len(S2_FIELDS) + 2] = 0  # a tap of class (0, 0) other than (1, 1)
    assert not dgrad_s2_plan_ok(bad)
    with pytest.raises(ValueError, match="Cout"):
        dgrad_s2_plan(2, 8, 8, 16, 300)


def _replay_dgrad_s2(dy, w, p):
    """conv3x3_dgrad_s2.cu's bf16 kernel tile by tile, warpgroup by warpgroup, warp by
    warp, on an emulated shared memory (one float per bf16 element, the kernel's byte
    offsets halved, NaN where nothing was copied): the weights of each N slice in K-major
    core matrices, the dy halo, each lane's ldmatrix row address per tap (the plan's tap
    table), the wgmma B operand read through the K-major layout, and the stores to each
    class's pixels."""
    b, ho, wo, cout = dy.shape
    cin, h, wd, nt = w.shape[2], p.H, p.W, p.nt
    nq, kch = nt // 8, p.kpad // 8
    table = np.array(list(p.c_ints)[len(S2_FIELDS):]).reshape(9, 4)
    starts = np.cumsum([0] + [len(ts) for ts in S2_TAPS])
    dx = np.full((b, h, wd, cin), np.nan)
    tap_el = p.kpad * nt  # elements of one tap of the weights
    for sl in range(p.nslices):
        n0 = sl * nt
        wsm = np.full(9 * tap_el, np.nan)
        for tap in range(9):
            for kc in range(kch):
                for n in range(nt):
                    v = np.zeros(8)
                    ci = n0 + n
                    if ci < cin:
                        src = w[tap // 3, tap % 3, ci, kc * 8:kc * 8 + 8]
                        v[:len(src)] = src
                    off = tap * tap_el + ((kc * nq + n // 8) * 128 + (n % 8) * 16) // 2
                    wsm[off:off + 8] = v
        for tile in range(p.tiles):
            bb, r = divmod(tile, p.tiles_y * p.tiles_x)
            ty, tx = divmod(r, p.tiles_x)
            i0, j0 = ty * p.tr, tx * p.tw
            npix = min(p.tr, ho - i0) * wo if p.tw == wo else min(p.tw, wo - j0)
            hsm = np.full(p.halo_bytes // 2, np.nan)
            for hy in range(p.hr):
                for hx in range(p.hc):
                    for c in range(0, p.kpad, 8):
                        v = np.zeros(8)
                        oy, ox = i0 + hy, j0 + hx
                        if oy < ho and ox < wo:
                            src = dy[bb, oy, ox, c:c + 8]
                            v[:len(src)] = src
                        off = ((hy * p.hc + hx) * p.pxb + c * 2) // 2
                        hsm[off:off + 8] = v
            for wg in range(S2_WGS):
                for warp in range(4):
                    for c, (py, px) in enumerate(S2_CLASSES):
                        acc = np.zeros((16, nt))
                        for e in range(starts[c], starts[c + 1]):
                            ro, co, ky, kx = table[e]
                            for ks in range(p.kpad // 16):
                                a = np.zeros((16, 16))
                                for lane in range(32):
                                    a_row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8
                                    pr = a_row if a_row < npix else 0
                                    pi, pj = divmod(pr, p.tw)
                                    addr = ((pi * p.hc + pj) * p.pxb + (lane >> 4) * 16
                                            + (ro * p.hc + co) * p.pxb + ks * 32)
                                    rr = (lane & 7) + ((lane >> 3) & 1) * 8
                                    a[rr, (lane >> 4) * 8:(lane >> 4) * 8 + 8] = \
                                        hsm[addr // 2:addr // 2 + 8]
                                kk = ks * 16 + np.arange(16)[:, None]
                                nn = np.arange(nt)[None, :]
                                bmat = wsm[(ky * 3 + kx) * tap_el + (((kk >> 3) * nq + nn // 8) * 128
                                                                      + (nn % 8) * 16 + (kk & 7) * 2) // 2]
                                assert not (np.isnan(a).any() or np.isnan(bmat).any())
                                acc += a @ bmat
                        for rl in range(16):
                            m = wg * 64 + warp * 16 + rl
                            ti, tj = divmod(m, p.tw)
                            oy, ox = 2 * (i0 + ti) + py, 2 * (j0 + tj) + px
                            if m < npix and oy < h and ox < wd:
                                k = min(nt, cin - n0)
                                dx[bb, oy, ox, n0:n0 + k] = acc[rl, :k]
    return dx


@pytest.mark.parametrize("sig", [(2, 7, 9, 32, 24), (2, 9, 6, 16, 3), (1, 5, 7, 3, 32),
                                 (1, 6, 6, 24, 80), (1, 3, 300, 8, 8)], ids=str)
def test_dgrad_s2_kernel_replayed_gives_the_data_gradient(sig):
    """The bf16 kernel's data flow, replayed, equals the plain data gradient: odd H and
    W, Cout = 3 and 24 (channels padded to 16), Cin = 3 (N padded), Cout = 80 (two K
    groups of 64 channels), and rows wider than a tile (tw < Wo)."""
    b, h, w, cin, cout = sig
    rng = np.random.default_rng(4)
    dy = rng.normal(size=(b, (h + 1) // 2, (w + 1) // 2, cout))
    k = rng.normal(size=(3, 3, cin, cout))
    p = dgrad_s2_plan(*sig)
    got = _replay_dgrad_s2(dy, k, p)
    ref = conv3x3_dgrad_plain(t(dy.astype(np.float32)), t(k.astype(np.float32)), 2, (h, w))
    assert not np.isnan(got).any()  # every dx element written
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4)
