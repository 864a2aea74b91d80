"""K1's backward and K3's stride-2 gradients of diamond_tpu_torch on the CPU, against the
JAX package's VJPs, and the host side of the K1 backward kernel (its launch plan).

Tolerances, each with its reason:
  * ``adagn_silu_bwd_plain`` against ``jax.vjp`` of the JAX package's ``_adagn_silu_ref``
    and of its custom_vjp ``adagn_silu`` (the Pallas kernel in interpret mode forward,
    the same VJP backward), f32: within 1e-5 of each output's largest |value| (the same
    formula, f32 sums in another order);
  * bf16 x (FiLM rows f32 or bf16): both sides compute in f32 from the same bf16 inputs
    and round once, so a value may differ by one bf16 ulp: within 1/64 of the largest
    |value| (two ulps of it); the FiLM gradient comes in the rows' dtype, as JAX's;
  * the plain backward given the moments the forward saved equals the form that
    recomputes them bit for bit (the same numbers), and jax.vjp as above; the plain
    forward's moments equal the JAX reference's mean and rsqrt(var + eps) within 1e-6 of
    max(1, the largest |value|) (groups of at most 2,048 values, summed in another
    order);
  * ``AdaGroupNormSiLU`` on CPU tensors (forward and backward are then the plain
    versions) against autograd of the plain forward: 1e-5 absolute (an explicit VJP
    against autograd's, both in f32);
  * the stride-2 data and weight gradients (the zero-interleave formulation) against
    ``jax.vjp`` of the JAX package's stride-2 conv (``conv3x3_lowered`` in mode ``xla``,
    padding ((1, 1), (1, 1))): within 1e-5 of the largest |value| (f32 sums in another
    order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.ops.conv_lowering import conv3x3_lowered
from diamond_tpu.ops.fused_norms import GN_EPS, _adagn_silu_ref
from diamond_tpu.ops.fused_norms import adagn_silu as j_adagn_silu
from diamond_tpu_torch.ops import (adagn_silu_bwd, adagn_silu_bwd_plain, adagn_silu_plain,
                                   adagn_silu_with_moments, conv3x3_dgrad_plain, conv3x3_plain,
                                   conv3x3_wgrad_plain, group_moments)
from diamond_tpu_torch.ops.conv3x3 import Conv3x3Fn, zero_interleave
from diamond_tpu_torch.ops.fused_norms import AdaGroupNormSiLU
from diamond_tpu_torch.ops import norm_plan as npl
from diamond_tpu_torch.ops.norm_plan import bwd_plan, bwd_plan_ok

from torch_port_util import t

# (B, H, W, C, G): ragged spatial sizes, one and several groups, C = 128 (the decoder's
# skip concatenation)
K1_CASES = [(2, 8, 8, 64, 2), (3, 5, 7, 32, 1), (1, 4, 4, 96, 3), (2, 6, 6, 128, 4)]
# the denoiser step's K1 signatures (B, H, C) at full size
DENOISER_NORMS = [(32, s, c) for s in (64, 32, 16, 8) for c in (64, 128)]


def _rel_close(a, b, share):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    err = np.abs(a - b).max()
    assert err <= share * max(np.abs(b).max(), 1e-30), (err, np.abs(b).max())


def _k1_inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.5).astype(np.float32)
    ss = (0.5 * rng.normal(size=(b, 2 * c))).astype(np.float32)
    dy = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, ss, dy


@pytest.mark.parametrize("b,h,w,c,g", K1_CASES)
def test_adagn_silu_bwd_plain_matches_jax_vjp(b, h, w, c, g):
    x, ss, dy = _k1_inputs(0, b, h, w, c)
    _, vjp = jax.vjp(lambda x_, s_: _adagn_silu_ref(x_, s_, g), x, ss)
    ref = vjp(jnp.asarray(dy))
    got = adagn_silu_bwd_plain(t(x), t(dy), t(ss), g)
    assert got[1].dtype == torch.float32 and got[1].shape == (b, 2 * c)
    for a, r in zip(got, ref):
        _rel_close(a.numpy(), r, 1e-5)


@pytest.mark.parametrize("b,h,w,c,g", K1_CASES[:2])
def test_adagn_silu_bwd_plain_matches_the_interpret_mode_custom_vjp(b, h, w, c, g):
    x, ss, dy = _k1_inputs(1, b, h, w, c)
    _, vjp = jax.vjp(lambda x_, s_: j_adagn_silu(x_, s_, g, True), x, ss)
    ref = vjp(jnp.asarray(dy))
    for a, r in zip(adagn_silu_bwd_plain(t(x), t(dy), t(ss), g), ref):
        _rel_close(a.numpy(), r, 1e-5)


@pytest.mark.parametrize("film_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,g", [K1_CASES[0], K1_CASES[3]])
def test_adagn_silu_bwd_plain_in_bf16_matches_jax_vjp(b, h, w, c, g, film_dtype):
    x, ss, dy = _k1_inputs(2, b, h, w, c)
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    ssj = jnp.asarray(ss, getattr(jnp, film_dtype))
    _, vjp = jax.vjp(lambda x_, s_: _adagn_silu_ref(x_, s_, g), xb, ssj)
    dx_j, dss_j = vjp(dyb)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    ss_p = bf(ssj) if film_dtype == "bfloat16" else t(np.asarray(ssj))
    dx, dss = adagn_silu_bwd_plain(bf(xb), bf(dyb), ss_p, g)
    assert dx.dtype == torch.bfloat16 and dss.dtype == ss_p.dtype
    _rel_close(dx.float().numpy(), np.asarray(dx_j, np.float32), 1 / 64)
    _rel_close(dss.to(ss_p.dtype).float().numpy(), np.asarray(dss_j, np.float32), 1 / 64)


@pytest.mark.parametrize("b,h,w,c,g", K1_CASES)
def test_adagn_plain_forward_moments_match_the_jax_reference(b, h, w, c, g):
    """The moments K1's plain forward returns (what the K1 kernel saves) equal the JAX
    reference's mean and rsqrt(var + eps) of ``_adagn_silu_ref``, f32."""
    x, ss, _ = _k1_inputs(3, b, h, w, c)
    y, mom = adagn_silu_plain(t(x), t(ss), g, return_moments=True)
    xg = jnp.asarray(x).reshape(b, h, w, g, c // g)
    mean = xg.mean(axis=(1, 2, 4))
    inv = jax.lax.rsqrt((xg * xg).mean(axis=(1, 2, 4)) - mean * mean + GN_EPS)
    ref = np.stack([np.asarray(mean), np.asarray(inv)], axis=-1)
    assert mom.shape == (b, g, 2) and mom.dtype == torch.float32
    assert np.abs(mom.numpy() - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())
    assert torch.equal(y, adagn_silu_plain(t(x), t(ss), g))
    y_m, mom_m = adagn_silu_with_moments(t(x), t(ss), g)  # a CPU tensor: the plain version
    assert torch.equal(y_m, y) and torch.equal(mom_m, group_moments(t(x), g))


@pytest.mark.parametrize("film_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c,g", [K1_CASES[0], K1_CASES[1], K1_CASES[3]])
def test_adagn_silu_bwd_plain_given_moments_matches_recompute_and_jax_vjp(b, h, w, c, g,
                                                                          x_dtype, film_dtype):
    """K1's plain backward given the saved moments: the recomputing form's bits, and
    jax.vjp of ``_adagn_silu_ref`` within 1e-5 (f32) or 1/64 (bf16 x or rows)."""
    x, ss, dy = _k1_inputs(4, b, h, w, c)
    xj, dyj = jnp.asarray(x, getattr(jnp, x_dtype)), jnp.asarray(dy, getattr(jnp, x_dtype))
    ssj = jnp.asarray(ss, getattr(jnp, film_dtype))
    _, vjp = jax.vjp(lambda x_, s_: _adagn_silu_ref(x_, s_, g), xj, ssj)
    ref = vjp(dyj)
    to = lambda a, dt: torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dt))  # noqa: E731
    xt, dyt, sst = to(xj, x_dtype), to(dyj, x_dtype), to(ssj, film_dtype)
    _, mom = adagn_silu_plain(xt, sst, g, return_moments=True)
    got = adagn_silu_bwd_plain(xt, dyt, sst, g, True, mom)
    assert all(torch.equal(a, r) for a, r in zip(got, adagn_silu_bwd_plain(xt, dyt, sst, g)))
    assert got[0].dtype == xt.dtype and got[1].dtype == sst.dtype
    tol = 1e-5 if x_dtype == film_dtype == "float32" else 1 / 64
    for a, r in zip(got, ref):
        _rel_close(a.float().numpy(), np.asarray(r, np.float32), tol)


@pytest.mark.parametrize("silu", [True, False])
def test_adagn_function_on_cpu_matches_autograd_of_the_plain_version(silu):
    torch.manual_seed(0)
    x = (torch.randn(2, 6, 5, 64) * 2 + 0.5).requires_grad_()
    ss = (0.5 * torch.randn(2, 128)).requires_grad_()
    dy = torch.randn(2, 6, 5, 64)
    ref = torch.autograd.grad(adagn_silu_plain(x, ss, 2, silu), (x, ss), dy)
    got = torch.autograd.grad(AdaGroupNormSiLU.apply(x, ss, 2, silu), (x, ss), dy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-5)
    # the wrapper on a CPU tensor is the plain version
    for a, r in zip(adagn_silu_bwd(x.detach(), dy, ss.detach(), 2, silu),
                    adagn_silu_bwd_plain(x.detach(), dy, ss.detach(), 2, silu)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("b,h,c", DENOISER_NORMS)
@pytest.mark.parametrize("es", [2, 4])
def test_k1_bwd_plan_at_the_denoiser_signatures(b, h, c, es):
    """K1's backward runs on the backward's own plan: 8 blocks per sample at 64x64 and
    32x32 (a portable cluster), fewer at 8x8 and 16x16 where a block holds at most 16 KB
    of x and dy; bf16 keeps x and dy of every signature up to 32x32x64 on chip, 64x64
    keeps a part (the rest is read from device memory), all in four blocks' shared
    memory an SM."""
    p = bwd_plan(b, h * h, c, c // 32, es)
    assert bwd_plan_ok(p) and p.n <= 8
    assert p.n == min(8, max(1, 2 * h * h * c * es // npl.BWD_BLOCK_BYTES))
    assert p.smem <= npl.bwd_budget(npl.BWD_BLOCKS_PER_SM)
    if es == 2 and (h < 32 or (h, c) == (32, 64)):
        assert p.resident
    if h == 64:
        assert not p.resident and p.n == 8 and p.rpx % p.step_px == 0


def _j_conv_s2(x, k, b):
    y = conv3x3_lowered(x, k, 2, "xla")
    return y if b is None else y + b


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 8), (1, 7, 9, 3, 6), (2, 9, 6, 8, 3)])
def test_stride2_gradients_match_jax_vjp(b, h, w, cin, cout, bias):
    """Even and odd H and W: dx, dW (and the bias's) of the stride-2 conv, through the
    zero interleave, against jax.vjp of the JAX package's stride-2 conv."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / (3 * cin ** 0.5)).astype(np.float32)
    bb = (0.1 * rng.normal(size=cout)).astype(np.float32) if bias else None
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    dy = rng.normal(size=(b, ho, wo, cout)).astype(np.float32)
    if bias:
        y_j, vjp = jax.vjp(_j_conv_s2, x, k, bb)
        dx_j, dk_j, db_j = vjp(jnp.asarray(dy))
    else:
        y_j, vjp = jax.vjp(lambda x_, k_: _j_conv_s2(x_, k_, None), x, k)
        dx_j, dk_j = vjp(jnp.asarray(dy))
    assert y_j.shape == dy.shape
    _rel_close(conv3x3_dgrad_plain(t(dy), t(k), 2, (h, w)).numpy(), dx_j, 1e-5)
    _rel_close(conv3x3_wgrad_plain(t(x), t(dy), 2).numpy(), dk_j, 1e-5)
    # the autograd Function on CPU tensors: the same gradients, the bias's a sum of dy
    xs, ks = t(x).requires_grad_(), t(k).requires_grad_()
    args = (xs, ks) + ((t(bb).requires_grad_(),) if bias else ())
    y = Conv3x3Fn.apply(xs, ks, args[2] if bias else None, 2)
    _rel_close(y.detach().numpy(), y_j, 1e-5)
    got = torch.autograd.grad(y, args, t(dy))
    _rel_close(got[0].numpy(), dx_j, 1e-5)
    _rel_close(got[1].numpy(), dk_j, 1e-5)
    if bias:
        _rel_close(got[2].numpy(), db_j, 1e-5)


def test_zero_interleave_places_dy_at_even_positions_and_checks_the_shape():
    dy = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    dyz = zero_interleave(dy, (5, 4), 2)
    assert dyz.shape == (2, 5, 4, 4)
    assert torch.equal(dyz[:, ::2, ::2], dy)
    dyz[:, ::2, ::2] = 0
    assert not dyz.any()
    assert zero_interleave(dy, (3, 2), 1) is dy
    with pytest.raises(ValueError, match="stride-2 output"):
        zero_interleave(dy, (7, 4), 2)
    # the stride-2 conv is the stride-1 conv read at even positions
    x, k = torch.randn(1, 7, 6, 3), torch.randn(3, 3, 3, 5)
    assert torch.allclose(conv3x3_plain(x, k, None, 2), conv3x3_plain(x, k)[:, ::2, ::2],
                          atol=1e-6)
