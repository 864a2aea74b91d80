"""The backward kernels of diamond_tpu_torch on the CPU: their plain versions against the
JAX package's VJPs, the autograd Functions' wiring, and the host side of the kernels
(launch plans, and the weight-gradient kernel's fragments replayed), which the card
tests (tests/test_torch_cuda.py) take as given.

  * K2's backward (ops/fused_norms.py ``groupnorm_silu_bwd``) against ``jax.vjp`` of the
    JAX package's ``_gn_silu_ref`` (its custom_vjp backward), f32, within 1e-5 of the
    largest |value| (the same formula, sums in another order);
  * K3's data and weight gradients (ops/conv3x3.py) against ``jax.vjp`` of the
    ``lax.conv_general_dilated`` the JAX blocks differentiate, f32, within 1e-5;
  * ``GroupNormSiLU`` and ``Conv3x3Fn`` on CPU tensors (their forward and backward are
    then the plain versions) against autograd of the plain forward, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.ops.fused_norms import _gn_silu_ref
from diamond_tpu_torch.ops import (conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad_plain,
                                   groupnorm_silu_bwd_plain, groupnorm_silu_plain)
from diamond_tpu_torch.ops.conv3x3 import Conv3x3Fn, flip_kernel
from diamond_tpu_torch.ops.conv_plan import (WGRAD_CH, WGRAD_HALO_PX, wgrad_f32_split,
                                             wgrad_plan, wgrad_plan_ok)
from diamond_tpu_torch.ops.fused_norms import GroupNormSiLU
from diamond_tpu_torch.ops.norm_plan import bwd_plan, bwd_plan_ok, norm_plan, plan_for

from torch_port_util import t

# The actor-critic trunk's norm signatures (B, H, C) and ragged cases; its 3x3 convs
# (B, H, W, Cin, Cout) and ragged cases (odd H * W, Cin = 3 and 6, Cout = 3 and 24).
AC_NORMS = [(32, 64, 32), (32, 32, 32), (32, 16, 32), (32, 8, 64)]
RAGGED_NORMS = [(1, 9, 32), (3, 5, 96), (2, 64, 128), (1, 64, 256), (4, 7, 512)]
AC_CONVS = [(32, 64, 64, 3, 32), (32, 64, 64, 32, 32), (32, 32, 32, 32, 32),
            (32, 16, 16, 32, 64), (32, 8, 8, 64, 64)]
RAGGED_CONVS = [(2, 9, 9, 3, 24), (3, 5, 7, 6, 3), (1, 33, 33, 64, 64), (2, 4, 150, 16, 8),
                (2, 3, 3, 48, 16)]


def _rel_close(a, b, share):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= share * max(np.abs(b).max(), 1e-30), np.abs(a - b).max()


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("b,h,w,c,g", [(2, 8, 8, 64, 2), (3, 5, 7, 32, 1), (1, 4, 4, 96, 3)])
def test_groupnorm_silu_bwd_plain_matches_jax_vjp(b, h, w, c, g, silu):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.5).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bi = (0.1 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _gn_silu_ref(*a, g, silu), x, sc, bi)
    ref = vjp(jnp.asarray(dy))
    got = groupnorm_silu_bwd_plain(t(x), t(dy), t(sc), t(bi), g, silu)
    for a, r in zip(got, ref):
        _rel_close(a.numpy(), r, 1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 8), (1, 5, 7, 3, 6), (2, 9, 9, 6, 3)])
def test_conv3x3_gradients_match_jax_vjp(b, h, w, cin, cout):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / (3 * cin ** 0.5)).astype(np.float32)
    dy = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    conv = lambda x_, k_: jax.lax.conv_general_dilated(  # noqa: E731
        x_, k_, (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(conv, x, k)
    dx, dk = vjp(jnp.asarray(dy))
    _rel_close(conv3x3_dgrad_plain(t(dy), t(k)).numpy(), dx, 1e-5)
    _rel_close(conv3x3_wgrad_plain(t(x), t(dy)).numpy(), dk, 1e-5)


def test_flipped_kernel_is_the_data_gradient_of_the_conv():
    """dx of the SAME stride-1 conv equals the same conv of dy with w_t[ky, kx, co, ci] =
    w[2 - ky, 2 - kx, ci, co], element for element of the flip."""
    rng = np.random.default_rng(2)
    k = t(rng.normal(size=(3, 3, 4, 5)).astype(np.float32))
    kt = flip_kernel(k)
    assert kt.shape == (3, 3, 5, 4) and kt.is_contiguous()
    for ky in range(3):
        for kx in range(3):
            assert torch.equal(kt[ky, kx], k[2 - ky, 2 - kx].T)


@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_function_on_cpu_matches_autograd_of_the_plain_version(silu):
    torch.manual_seed(0)
    x = (torch.randn(2, 6, 5, 64) * 2 + 0.5).requires_grad_()
    sc = (1 + 0.1 * torch.randn(64)).requires_grad_()
    bi = (0.1 * torch.randn(64)).requires_grad_()
    dy = torch.randn(2, 6, 5, 64)
    ref = torch.autograd.grad(groupnorm_silu_plain(x, sc, bi, 2, silu), (x, sc, bi), dy)
    got = torch.autograd.grad(GroupNormSiLU.apply(x, sc, bi, 2, silu), (x, sc, bi), dy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)


def test_conv_function_on_cpu_matches_autograd_and_skips_unneeded_gradients():
    torch.manual_seed(1)
    x = torch.randn(2, 7, 6, 5, requires_grad=True)
    k = (torch.randn(3, 3, 5, 8) / 6).requires_grad_()
    b = torch.randn(8, requires_grad=True)
    dy = torch.randn(2, 7, 6, 8)
    ref = torch.autograd.grad(conv3x3_plain(x, k, b), (x, k, b), dy)
    got = torch.autograd.grad(Conv3x3Fn.apply(x, k, b, 1), (x, k, b), dy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)
    # the input convs' x needs no gradient: only the weights get one, and no bias
    y = Conv3x3Fn.apply(x.detach(), k, None, 1)
    (gk,) = torch.autograd.grad(y, (k,), dy)
    torch.testing.assert_close(gk, ref[1], rtol=0, atol=1e-5)
    # stride 2 (the Downsample): the gradients through the zero interleave
    dy2 = torch.randn(2, 4, 3, 8)
    ref = torch.autograd.grad(conv3x3_plain(x, k, b, 2), (x, k, b), dy2)
    got = torch.autograd.grad(Conv3x3Fn.apply(x, k, b, 2), (x, k, b), dy2)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K2's backward plan


def _norm_cases():
    for b, h, c in AC_NORMS + RAGGED_NORMS:
        for es in (2, 4):
            yield pytest.param(b, h, c, es, id=f"b{b}-{h}x{h}x{c}-e{es}")


@pytest.mark.parametrize("b,h,c,es", list(_norm_cases()))
def test_bwd_plan_is_the_forward_layout_with_dy_on_chip(b, h, c, es):
    """The backward runs on its forward's clusters, blocks, threads and pixel spans (so
    it recomputes the same moments), fits the card with x and dy in shared memory, and
    agrees with the kernel's check; every actor-critic shape keeps both resident."""
    fwd = norm_plan(b, h * h, c, max(1, c // 32), es)
    p = bwd_plan(fwd)
    assert bwd_plan_ok(p)
    for f in ("B", "HW", "C", "G", "elem_bytes", "vec", "threads", "n", "ppb"):
        assert getattr(p, f) == getattr(fwd, f), f
    assert p.rpx % p.step_px == 0 or p.rpx == p.ppb
    assert 2 * p.rpx * c * es <= p.smem
    if (b, h, c) in AC_NORMS:
        assert p.resident and p.n <= 8
    if not p.resident:  # the rest of the span is read from device memory
        assert p.rpx < p.ppb
    assert list(p.c_ints)[:9] == list(fwd.c_ints)[:9]


def test_bwd_plan_of_a_spilling_sample_and_a_refused_one():
    """f32 64x64x256 keeps part of each block's span on chip; a plan whose shared
    memory disagrees with its layout is refused."""
    p = bwd_plan(norm_plan(1, 64 * 64, 256, 8, 4))
    assert not p.resident and bwd_plan_ok(p)
    from dataclasses import replace
    assert not bwd_plan_ok(replace(p, smem=p.smem - 16))
    assert not bwd_plan_ok(replace(p, rpx=p.ppb))
    small = bwd_plan(plan_for(32, 64, 64, 2, 2, 1))
    assert small.resident and small.n == 1 and small.chunks == 1


# ---------------------------------------------------------------------------
# K3's weight gradient: the plan, and the kernel's fragments replayed


@pytest.mark.parametrize("sig", AC_CONVS + RAGGED_CONVS, ids=str)
def test_wgrad_plan_fits_the_card_and_covers_every_row_once(sig):
    b, h, w, cin, cout = sig
    p = wgrad_plan(*sig)
    assert wgrad_plan_ok(p) and p.smem <= 232_448
    assert p.slices * WGRAD_CH >= cin and p.nt >= cout
    rows = np.zeros((b, h), int)
    for kb in range(p.kblocks):
        for tile in range(kb, p.tiles, p.kblocks):
            bb, y0 = tile // p.tiles_y, tile % p.tiles_y * p.tr
            rows[bb, y0:y0 + min(p.tr, h - y0)] += 1
    assert (rows == 1).all()
    splits, per = wgrad_f32_split(*sig)
    assert per % 16 == 0 and (splits - 1) * per < b * h * w <= splits * per


def test_wgrad_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="Cout"):
        wgrad_plan(2, 8, 8, 16, 128)
    from dataclasses import replace
    p = wgrad_plan(32, 64, 64, 32, 32)
    assert not wgrad_plan_ok(replace(p, kblocks=p.tiles + 1))
    assert not wgrad_plan_ok(replace(p, smem=p.smem + 128))


def _ldmatrix_trans(rows):
    """ldmatrix .x4 .trans as the kernel reads it: ``rows`` (4, 8, 8) holds the eight
    16-byte rows the lanes of each matrix point at; returns the four 8 x 8 matrices as
    the fragments see them (matrix i transposed)."""
    return [rows[i].T for i in range(4)]


def _replay_wgrad(x, dy, p):
    """conv3x3_wgrad.cu's bf16 kernel, block by block, warp by warp, K step by K step:
    the halo and dy tiles as the loads fill them, each lane's ldmatrix row address, the
    fragments of mma m16n8k16 (A rows = 16 channels, B columns = 8 of Cout), the
    per-block partials, then their sum in block order."""
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    hc = w + 2
    part = np.zeros((p.kblocks, 9, p.slices * WGRAD_CH, cout), np.float64)
    for block in range(p.grid):
        sl, kb = block % p.slices, block // p.slices
        ci0 = sl * WGRAD_CH
        acc = np.zeros((9, WGRAD_CH, p.nt))
        for tile in range(kb, p.tiles, p.kblocks):
            bb, y0 = tile // p.tiles_y, tile % p.tiles_y * p.tr
            rows = min(p.tr, h - y0)
            tile_px = rows * w
            halo = np.zeros(((p.tr + 2) * hc, WGRAD_CH))
            for px in range((p.tr + 2) * hc):
                iy, ix = y0 - 1 + px // hc, px % hc - 1
                if 0 <= iy < h and 0 <= ix < w:
                    ch = x[bb, iy, ix, ci0:ci0 + WGRAD_CH]
                    halo[px, :len(ch)] = ch
            dys = np.zeros((p.ksteps * 16, p.nt))
            dys[:tile_px, :cout] = dy[bb, y0:y0 + rows].reshape(-1, cout)
            for warp in range(9):
                ky, kx = divmod(warp, 3)
                for s in range(p.ksteps):
                    a_rows = np.zeros((4, 8, 8))
                    b_rows = np.zeros((p.nt // 16, 4, 8, 8))
                    for lane in range(32):
                        mi, mr = lane >> 3, lane & 7
                        k = s * 16 + (mi >> 1) * 8 + mr
                        kk = k if k < tile_px else 0
                        hp = (kk // w + ky) * hc + kk % w + kx
                        a_ch = (mi & 1) * 8
                        a_rows[mi, mr] = halo[hp, a_ch:a_ch + 8]
                        for j2 in range(p.nt // 16):
                            bp, bc = s * 16 + (mi & 1) * 8 + mr, 16 * j2 + (mi >> 1) * 8
                            b_rows[j2, mi, mr] = dys[bp, bc:bc + 8]
                    m0, m1, m2, m3 = _ldmatrix_trans(a_rows)
                    a = np.block([[m0, m2], [m1, m3]])  # A[m = channel][k = pixel]
                    for j2 in range(p.nt // 16):
                        n0, n1, n2, n3 = _ldmatrix_trans(b_rows[j2])
                        for jj, (lo, hi) in enumerate(((n0, n1), (n2, n3))):
                            bm = np.concatenate([lo, hi], axis=1).T  # B[k = pixel][n]
                            n = 16 * j2 + 8 * jj
                            acc[warp, :, n:n + 8] += a @ bm
        part[kb, :, ci0:ci0 + WGRAD_CH] = acc[:, :, :cout]
    return part.sum(axis=0)[:, :cin].reshape(3, 3, cin, cout)


@pytest.mark.parametrize("sig", [(2, 9, 9, 3, 24), (3, 5, 7, 6, 3), (2, 3, 3, 48, 16),
                                 (1, 2, 40, 16, 8)], ids=str)
def test_wgrad_kernel_fragments_replayed_give_the_weight_gradient(sig):
    """The bf16 kernel's data flow, replayed: every lane's halo and dy addresses (the
    tap's shift, image-row ends, the ragged last K step reading pixel 0 against zero dy
    rows, channels past Cin and Cout zero), the transposed fragments and the partials'
    layout give the weight gradient."""
    b, h, w, cin, cout = sig
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, cin))
    dy = rng.normal(size=(b, h, w, cout))
    p = wgrad_plan(*sig)
    got = _replay_wgrad(x, dy, p)
    ref = conv3x3_wgrad_plain(t(x.astype(np.float32)), t(dy.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert WGRAD_HALO_PX % 16 == 0 and p.dy_stride % 16 == 0  # ldmatrix rows 16-byte aligned
