"""The backward kernels of diamond_tpu_torch on the CPU: their plain versions against the
JAX package's VJPs, the autograd Functions' wiring, and the host side of the kernels
(launch plans, and the weight-gradient kernel's fragments replayed), which the card
tests (tests/test_torch_cuda.py) take as given.

  * K2's backward (ops/fused_norms.py ``groupnorm_silu_bwd``) against ``jax.vjp`` of the
    JAX package's ``_gn_silu_ref`` (its custom_vjp backward), f32, within 1e-5 of the
    largest |value| (the same formula, sums in another order), both recomputing the
    moments and given the forward's; in bf16 within 1/64 (one rounding on each side);
  * the plain forward's moments (what the forward kernels save for the backward)
    against the JAX reference's mean and rsqrt(var + eps), f32, within 1e-6 of max(1,
    the largest |value|);
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
from diamond_tpu.ops.fused_norms import GN_EPS
from diamond_tpu_torch.ops import (conv3x3_dgrad_plain, conv3x3_plain, conv3x3_wgrad_plain,
                                   group_moments, groupnorm_silu_bwd_plain,
                                   groupnorm_silu_plain, groupnorm_silu_with_moments)
from diamond_tpu_torch.ops.conv3x3 import Conv3x3Fn, flip_kernel
from diamond_tpu_torch.ops.conv_plan import (SMEM_BLOCK, WGRAD_WGS, wgrad_f32_split, wgrad_plan,
                                             wgrad_plan_ok)
from diamond_tpu_torch.ops.fused_norms import GroupNormSiLU
from diamond_tpu_torch.ops import norm_plan as npl
from diamond_tpu_torch.ops.norm_plan import bwd_plan, bwd_plan_for, bwd_plan_ok

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


def _jax_moments(x, g):
    """The JAX package's group statistics (``_gn_silu_ref``): (B, G, 2) mean and
    rsqrt(var + eps) of x (B, H, W, C), f32."""
    b, h, w, c = x.shape
    xg = jnp.asarray(x, jnp.float32).reshape(b, h, w, g, c // g)
    mean = xg.mean(axis=(1, 2, 4))
    var = (xg * xg).mean(axis=(1, 2, 4)) - mean * mean
    return np.stack([np.asarray(mean), np.asarray(jax.lax.rsqrt(var + GN_EPS))], axis=-1)


@pytest.mark.parametrize("b,h,w,c,g", [(2, 8, 8, 64, 2), (3, 5, 7, 32, 1), (1, 4, 4, 96, 3),
                                       (4, 6, 6, 128, 4)])
def test_plain_forward_moments_match_the_jax_reference(b, h, w, c, g):
    """The moments the plain forward returns (the forward kernels' saved output) equal the
    JAX reference's mean and rsqrt(var + eps) per sample and group, f32, within 1e-6 of
    max(1, the largest |value|) (groups of at most 2,048 values, summed in another
    order), and are the ones it normalized with."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.5).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bi = (0.1 * rng.normal(size=c)).astype(np.float32)
    y, mom = groupnorm_silu_plain(t(x), t(sc), t(bi), g, True, return_moments=True)
    assert mom.shape == (b, g, 2) and mom.dtype == torch.float32
    ref = _jax_moments(x, g)
    assert np.abs(mom.numpy() - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())
    assert torch.equal(y, groupnorm_silu_plain(t(x), t(sc), t(bi), g, True))
    y_m, mom_m = groupnorm_silu_with_moments(t(x), t(sc), t(bi), g)  # a CPU tensor: plain
    assert torch.equal(y_m, y) and torch.equal(mom_m, group_moments(t(x), g))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,g", [(2, 8, 8, 64, 2), (3, 5, 7, 32, 1), (1, 4, 4, 96, 3)])
def test_groupnorm_silu_bwd_plain_given_moments_matches_recompute_and_jax_vjp(b, h, w, c, g,
                                                                              dtype, silu):
    """K2's plain backward given the forward's saved moments equals the form that
    recomputes them (the same numbers, so bit for bit) and jax.vjp of ``_gn_silu_ref``:
    f32 within 1e-5 of the largest |value|; bf16 x and dy within 1/64 (both sides
    compute in f32 from the same bf16 values and round once)."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.5).astype(np.float32)
    sc = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bi = (0.1 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj, dyj = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    _, vjp = jax.vjp(lambda *a: _gn_silu_ref(*a, g, silu), xj, jnp.asarray(sc), jnp.asarray(bi))
    ref = vjp(dyj)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(getattr(torch, dtype))
    dyt = torch.from_numpy(np.asarray(dyj, np.float32)).to(getattr(torch, dtype))
    _, mom = groupnorm_silu_plain(xt, t(sc), t(bi), g, silu, return_moments=True)
    got = groupnorm_silu_bwd_plain(xt, dyt, t(sc), t(bi), g, silu, mom)
    again = groupnorm_silu_bwd_plain(xt, dyt, t(sc), t(bi), g, silu)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    assert got[0].dtype == xt.dtype and got[1].dtype == got[2].dtype == torch.float32
    for a, r in zip(got, ref):
        _rel_close(a.float().numpy(), np.asarray(r, np.float32),
                   1e-5 if dtype == "float32" else 1 / 64)


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
    """The backward's own plan keeps the forward's layout rules (whole pixels per block,
    each thread on its V channels, chunks of whole steps: ``_layout_ok``) with x and dy
    on chip: ``rpx`` pixels of each, the threads' per-channel sums, the ranks' partials
    and the channel sums sent to each rank in the shared memory of four blocks an SM, on
    a portable cluster; it agrees with the kernel's check. In bf16 every shape up to
    32x32 keeps x and dy resident."""
    p = bwd_plan(b, h * h, c, max(1, c // 32), es)
    assert bwd_plan_ok(p) and npl._layout_ok(p)
    assert 1 <= p.n <= 8 and p.blocks == b * p.n and (p.n - 1) * p.ppb < h * h <= p.n * p.ppb
    assert p.threads <= 256 and p.threads % (c // p.vec) == 0 and p.threads >= p.G
    assert p.rpx % p.step_px == 0 or p.rpx == p.ppb
    assert 2 * p.rpx * c * es + 8 * p.threads * p.vec + 8 * p.n * p.G <= p.smem
    assert p.smem <= npl.bwd_budget(npl.BWD_BLOCKS_PER_SM)
    per_block = p.smem + npl.BWD_STATIC + npl.SMEM_RESERVED
    assert npl.BWD_BLOCKS_PER_SM * per_block <= npl.SMEM_SM
    if h <= 32 and es == 2:
        assert p.resident
    if not p.resident:  # the rest of the span is read from device memory
        assert p.rpx < p.ppb
    assert bwd_plan(b, h * h, c, max(1, c // 32), es) is p  # cached: shape and dtype only


def test_bwd_plan_of_a_spilling_sample_and_a_refused_one():
    """f32 64x64x256 keeps part of each block's span on chip; a plan the kernel cannot
    run, or whose shared memory disagrees with its layout, is refused, and so is a
    shape without a plan."""
    p = bwd_plan(1, 64 * 64, 256, 8, 4)
    assert not p.resident and bwd_plan_ok(p) and p.rpx < p.ppb
    from dataclasses import replace
    for bad in (dict(smem=p.smem - 16), dict(smem=p.smem + 16), dict(rpx=p.ppb),
                dict(n=16, ppb=256), dict(threads=512), dict(cpx=p.cpx + 1),
                dict(chunks=p.chunks + 1), dict(resident=1), dict(G=65),
                dict(smem=npl.SMEM_DYNAMIC + 16)):
        assert not bwd_plan_ok(replace(p, **bad)), bad
    small = bwd_plan(32, 64, 64, 2, 2)
    assert small.resident and small.n == 1 and small.chunks == 1
    for c, g, es in [(1024, 128, 2), (36, 1, 2), (66, 1, 4), (64, 16, 2), (96, 3, 3)]:
        with pytest.raises(ValueError):
            bwd_plan(2, 64, c, g, es)
    with pytest.raises(ValueError, match="does not fit"):  # eight blocks an SM at C = 2048
        bwd_plan_for(2, 64 * 64, 2048, 64, 2, 8, 8)


# ---------------------------------------------------------------------------
# K3's weight gradient: the plan, and the kernel's fragments replayed


@pytest.mark.parametrize("sig", AC_CONVS + RAGGED_CONVS, ids=str)
def test_wgrad_plan_fits_the_card_and_covers_every_row_once(sig):
    """The plan agrees with the kernel's check, fits a block's shared memory, covers Cin
    with its channel groups and Cout with its N, and its blocks' tiles cover every dy
    row of every image exactly once, at stride 1 and 2."""
    b, h, w, cin, cout = sig
    for stride in (1, 2):
        p = wgrad_plan(*sig, stride)
        assert wgrad_plan_ok(p) and p.smem <= SMEM_BLOCK
        assert p.ngroups * p.cg >= cin and p.nt >= cout
        assert p.mgroups * WGRAD_WGS * p.mpw * 64 >= 9 * p.cg
        rows = np.zeros((b, p.Ho), int)
        for kb in range(p.kblocks):
            for tile in range(kb, p.tiles, p.kblocks):
                bb, y0 = tile // p.tiles_y, tile % p.tiles_y * p.tr
                rows[bb, y0:y0 + min(p.tr, p.Ho - y0)] += 1
        assert (rows == 1).all()
        splits, per = wgrad_f32_split(b, p.Ho, p.Wo, cin, cout)
        assert per % 16 == 0 and (splits - 1) * per < b * p.Ho * p.Wo <= splits * per


def test_wgrad_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="Cout"):
        wgrad_plan(2, 8, 8, 16, 128)
    with pytest.raises(ValueError, match="stride"):
        wgrad_plan(2, 8, 8, 16, 16, 3)
    from dataclasses import replace
    p = wgrad_plan(32, 64, 64, 32, 32)
    assert not wgrad_plan_ok(replace(p, kblocks=p.tiles + 1))
    assert not wgrad_plan_ok(replace(p, smem=p.smem + 128))
    assert not wgrad_plan_ok(replace(p, mpw=p.mpw - 1))
    kb4 = p.kblocks // 4 * 4  # clusters of 4: measured slower, so no plan makes them
    assert wgrad_plan_ok(replace(p, kblocks=kb4, grid=p.ngroups * kb4 * p.mgroups))
    assert not wgrad_plan_ok(replace(p, cluster=4, kblocks=kb4, grid=p.ngroups * kb4 * p.mgroups))


def _ldmatrix_trans(rows):
    """ldmatrix .x4 .trans as the kernel reads it: ``rows`` (4, 8, 8) holds the eight
    16-byte rows the lanes of each matrix point at; returns the four 8 x 8 matrices as
    the fragments see them (matrix i transposed)."""
    return [rows[i].T for i in range(4)]


def _replay_wgrad(x, dy, p, with_bias=False):
    """conv3x3_wgrad.cu's bf16 kernel, block by block, warpgroup by warpgroup, warp by
    warp, K step by K step, on an emulated shared memory (one float per bf16 element,
    the kernel's byte offsets halved, NaN where nothing was copied), blocks in the
    kernel's order (K split fastest, clusters of neighbouring K splits): the halo and dy
    tiles as the loads fill them (stride 2: even halo columns first; dy in N-major core
    matrices), each lane's
    ldmatrix.trans row address (its M-tile slot's 8-channel chunk, tap shift and pixel),
    the wgmma B operand read through the core-matrix layout, the bias sums as the
    threads take them, each cluster's partial, then their sum in order."""
    b, h, w, cin = x.shape
    cout, s, nt = dy.shape[-1], p.stride, p.nt
    nq, cpt, half = nt // 8, p.cg // 8, (p.hc + 1) // 2
    part = np.zeros((p.kblocks // p.cluster * p.ngroups, p.rows, nt))
    pdb = np.zeros((p.kblocks, nt))
    stage = (p.halo_bytes + p.dy_bytes) // 2
    for block in range(p.grid):
        kb, gm = block % p.kblocks, block // p.kblocks
        g, mg = divmod(gm, p.mgroups)
        c0 = g * p.cg
        acc = np.zeros((p.rows, nt))
        bsum = np.zeros((WGRAD_WGS * 128, 8))
        for it, tile in enumerate(range(kb, p.tiles, p.kblocks)):
            sm = np.full(p.stages * stage, np.nan)
            base = (it % 2 if p.stages == 2 else 0) * stage
            bb, y0 = tile // p.tiles_y, tile % p.tiles_y * p.tr
            tile_px = min(p.tr, p.Ho - y0) * p.Wo
            for hy in range(p.hr):
                for hx in range(p.hc):
                    iy, ix = y0 * s - 1 + hy, hx - 1
                    slot = hx if s == 1 else (hx & 1) * half + (hx >> 1)
                    off = base + ((hy * p.hc + slot) * p.pxb) // 2
                    for ch in range(cpt):
                        c = c0 + ch * 8
                        v = np.zeros(8)
                        if 0 <= iy < h and 0 <= ix < w and c < cin:
                            src = x[bb, iy, ix, c:c + 8]
                            v[:len(src)] = src
                        sm[off + ch * 8:off + ch * 8 + 8] = v
            dbase = base + p.halo_bytes // 2
            rows_dy = dy[bb, y0:y0 + p.tr].reshape(-1, cout)
            for px in range(p.ksteps * 16):
                for q in range(nq):
                    v = np.zeros(8)
                    if px < tile_px and q * 8 < cout:
                        src = rows_dy[px, q * 8:q * 8 + 8]
                        v[:len(src)] = src
                    off = dbase + (((px >> 3) * nq + q) * 128 + (px & 7) * 16) // 2
                    sm[off:off + 8] = v
            for wg in range(WGRAD_WGS):
                for j in range(p.mpw):
                    mt = mg * WGRAD_WGS * p.mpw + wg + WGRAD_WGS * j
                    for warp in range(4):
                        for st in range(p.ksteps):
                            rows = np.zeros((4, 8, 8))
                            for lane in range(32):
                                mi = lane >> 3
                                chunk = mt * 8 + warp * 2 + (mi & 1)
                                chunk = chunk if chunk < 9 * cpt else 0
                                tap, cc = divmod(chunk, cpt)
                                ky, kx = divmod(tap, 3)
                                koff = kx if s == 1 else (0, half, 1)[kx]
                                k = st * 16 + (mi >> 1) * 8 + (lane & 7)
                                k = k if k < tile_px else 0
                                py, pxx = divmod(k, p.Wo)
                                addr = ((py * s * p.hc + pxx) * p.pxb
                                        + (ky * p.hc + koff) * p.pxb + cc * 16)
                                rows[mi, lane & 7] = sm[base + addr // 2:base + addr // 2 + 8]
                            m0, m1, m2, m3 = _ldmatrix_trans(rows)
                            a = np.block([[m0, m2], [m1, m3]])  # A[row][k = pixel]
                            kk = st * 16 + np.arange(16)[:, None]
                            nn = np.arange(nt)[None, :]
                            bmat = sm[dbase + (((kk >> 3) * nq + nn // 8) * 128
                                               + (kk & 7) * 16 + (nn % 8) * 2) // 2]
                            assert not (np.isnan(a).any() or np.isnan(bmat).any())
                            r0 = mt * 64 + warp * 16
                            acc[r0:r0 + 16] += a @ bmat
            if with_bias and g == 0 and mg == 0:
                phases = WGRAD_WGS * 128 // (8 * nq)
                for tid in range(WGRAD_WGS * 128):
                    r8, bq, ph = tid & 7, (tid >> 3) % nq, tid // (8 * nq)
                    for c in range(ph, p.ksteps * 2, phases):
                        off = dbase + ((c * nq + bq) * 128 + r8 * 16) // 2
                        bsum[tid] += sm[off:off + 8]
        # a cluster's blocks sum into one partial; the blocks of an (M-group) fill
        # disjoint rows of it
        part[kb // p.cluster * p.ngroups + g] += acc
        if with_bias and g == 0 and mg == 0:
            phases = WGRAD_WGS * 128 // (8 * nq)
            for n in range(nt):
                q, e = divmod(n, 8)
                pdb[kb, n] = sum(bsum[(f * nq + q) * 8 + r, e] for f in range(phases)
                                 for r in range(8))
    dw = np.zeros((9, cin, cout))
    for ci in range(cin):
        g = ci // p.cg
        for tap in range(9):
            for kc in range(p.kblocks // p.cluster):
                dw[tap, ci] += part[kc * p.ngroups + g, tap * p.cg + ci - g * p.cg, :cout]
    return dw.reshape(3, 3, cin, cout), pdb.sum(axis=0)[:cout]


@pytest.mark.parametrize("sig", [(2, 9, 9, 3, 24, 1), (3, 5, 7, 6, 3, 2), (2, 7, 9, 32, 16, 2),
                                 (1, 3, 20, 48, 8, 1), (1, 3, 5, 80, 8, 2), (2, 6, 5, 15, 64, 1),
                                 (67, 2, 2, 64, 8, 1), (67, 3, 2, 32, 16, 2)], ids=str)
def test_wgrad_kernel_fragments_replayed_give_the_weight_gradient(sig):
    """The bf16 kernel's data flow, replayed: every lane's halo and dy addresses (the
    chunk's tap shift, stride 2 with the even halo columns first, image-row ends, the
    ragged last K step reading pixel 0 against zero dy rows, channels past Cin and Cout
    zero, M-tile slots past the rows reading chunk 0), the transposed fragments, the
    bias sums and the partials' layout give the weight and bias gradients: Cin = 3, 6,
    15, 32 (one M-tile holds several taps), 48 (slots to spare) and 80 (two channel
    groups); the M-tiles shared out over several blocks (few K splits) and held by one
    block's warpgroups (B = 67: enough K splits)."""
    b, h, w, cin, cout, stride = sig
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, cin))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dy = rng.normal(size=(b, ho, wo, cout))
    p = wgrad_plan(b, h, w, cin, cout, stride)
    got, db = _replay_wgrad(x, dy, p, with_bias=True)
    ref, ref_db = conv3x3_wgrad_plain(t(x.astype(np.float32)), t(dy.astype(np.float32)), stride,
                                      with_bias=True)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db, ref_db.numpy(), rtol=1e-4, atol=1e-4)
    assert p.pxb % 16 == 0 and (p.pxb // 16) % 2 == 1  # ldmatrix rows: 16-byte aligned, no bank conflict
