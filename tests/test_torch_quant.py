"""diamond_tpu_torch's static int8 ops against diamond_tpu's: the calibration helpers of
ops/quant.py, the quantizing norm K4 (its plain versions, against the Pallas kernel in
interpret mode as tests/test_ops.py runs it, and against K1/K2), and the int8 conv K5
and matmul (plain versions) against the JAX functions, on the same numpy inputs.

Tolerances: the int8 sums are exact on both sides, and every f32 step is the same IEEE
operation, so weight codes are equal and scales agree to rtol 1e-6; conv and matmul
outputs agree to 1e-5 of max |y| in f32 and exactly in bf16. The per-sample K4 computes
SiLU as y / (1 + e^-y) where Pallas takes y * sigmoid(y): codes within 1 of each other
in at most 0.1 % of the elements, scales to rtol 1e-5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.ops import fused_q8 as jq8
from diamond_tpu.ops import quant as jquant
from diamond_tpu_torch.ops import (QTensor, adagn_silu, adagn_silu_q8, adagn_silu_q8_plain,
                                   conv3x3_int8, conv3x3_int8_plain, conv3x3_qtensor,
                                   group_stats_channels, groupnorm_silu, groupnorm_silu_q8,
                                   groupnorm_silu_q8_plain, norm_affine_silu_q8,
                                   norm_affine_silu_q8_plain, quant, quantize_static)

from torch_port_util import close, t


def _spread(rng, shape):
    """Random activations whose channels span 1000x in range, as after real norms."""
    x = rng.normal(size=shape).astype(np.float32)
    return x * np.logspace(-2, 1, shape[-1], dtype=np.float32)


def _act_max(x):
    return np.abs(x).reshape(-1, x.shape[-1]).max(axis=0)


@pytest.mark.parametrize("spec", ["all", None, "conv3x3,conv1x1", " conv3x3 , lstm ",
                                  ("dense", "lstm")])
def test_parse_sites_matches_jax(spec):
    assert quant.parse_sites(spec) == jquant.parse_sites(spec)


@pytest.mark.parametrize("bad", ["convXL", "", "conv3x3,bogus"])
def test_parse_sites_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        jquant.parse_sites(bad)
    with pytest.raises(ValueError):
        quant.parse_sites(bad)


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (3, 3, 128, 64), (48, 24)])
def test_fold_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    act_max = np.abs(_spread(rng, (4, shape[-2]))).max(axis=0)
    act_max[0] = 0.0  # the 1e-8 floor
    assert quant.ACT_SCALE_HEADROOM == jquant.ACT_SCALE_HEADROOM
    wq_j, sw_j = jquant.fold_quantize_weight(jnp.asarray(w), jnp.asarray(act_max))
    wq_p, sw_p = quant.fold_quantize_weight(t(w), t(act_max))
    assert wq_p.dtype == torch.int8 and sw_p.dtype == torch.float32
    np.testing.assert_array_equal(wq_p.numpy(), np.asarray(wq_j))
    close(sw_p, sw_j, 1e-6, 0)


def test_registry_to_collection_matches_jax():
    """The same registry on both sides (a conv3x3 and a conv1x1 site with weights, an
    LSTM site without): the same nested keys, w_q equal, scales to rtol 1e-6; the site
    filter drops the kinds it does not name."""
    rng = np.random.default_rng(1)
    arrays = {("enc", "conv", "act_scale"): ("conv3x3", (16,), (3, 3, 16, 8)),
              ("attn", "qkv_proj", "act_scale"): ("conv1x1", (8,), (8, 24)),
              ("lstm", "cell", "act_scale"): ("lstm", (32,), None)}
    reg_j, reg_p = {}, {}
    for path, (kind, n, wshape) in arrays.items():
        am = np.abs(_spread(rng, (4, *n))).max(axis=0)
        w = None if wshape is None else (rng.normal(size=wshape) * 0.1).astype(np.float32)
        reg_j[path] = (kind, jnp.asarray(am), None if w is None else jnp.asarray(w))
        reg_p[path] = (kind, t(am), None if w is None else t(w))
    for sites in (None, frozenset({"conv3x3", "conv1x1"})):
        cj = jquant.registry_to_collection(reg_j, sites)
        cp = quant.registry_to_collection(reg_p, sites)
        lj = jax.tree_util.tree_leaves_with_path(cj)
        lp = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, cp))
        assert [p for p, _ in lj] == [p for p, _ in lp]
        for (path, a), (_, b) in zip(lj, lp):
            if "w_q" in str(path):
                assert b.dtype == np.int8
                np.testing.assert_array_equal(b, np.asarray(a))
            else:
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=0)
        assert ("lstm" in cp) == (sites is None)


@pytest.mark.parametrize("c,dtype", [(32, np.float32), (64, np.float32), (64, jnp.bfloat16)])
def test_norm_affine_silu_q8_plain_matches_pallas(c, dtype):
    """K4 per-sample (the Pallas contract), bf16 x included."""
    rng = np.random.default_rng(2)
    b, g = 3, max(1, c // 32)
    x = jnp.asarray((rng.normal(size=(b, 8, 8, c)) * 3 + 0.5).astype(np.float32)).astype(dtype)
    gamma = jnp.asarray(rng.normal(size=(b, c)).astype(np.float32))
    beta = jnp.asarray(rng.normal(size=(b, c)).astype(np.float32))
    mean_c, inv_c = jq8.group_stats_channels(x, g)
    ref = jq8.norm_affine_silu_q8(x, mean_c, inv_c, gamma, beta, interpret=True)
    xp = t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16 if dtype == jnp.bfloat16
                                                 else torch.float32)
    mp, ip = group_stats_channels(xp, g)
    close(mp, mean_c, 1e-5, 1e-5)
    close(ip, inv_c, 1e-5, 1e-5)
    qt = norm_affine_silu_q8(xp, t(np.asarray(mean_c)), t(np.asarray(inv_c)), t(gamma), t(beta))
    assert qt.q.dtype == torch.int8 and qt.scale.shape == (b, 1)
    close(qt.scale, ref.scale, 1e-5, 0)
    d = np.abs(qt.q.numpy().astype(np.int32) - np.asarray(ref.q).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_quantizing_norms_equal_quantized_k1_k2(dtype):
    """K4 static (plain) is quantize(K1/K2 with SiLU, in x's dtype), code for code."""
    rng = np.random.default_rng(3)
    c = 64
    x = t((rng.normal(size=(2, 8, 8, c)) * 2 + 0.5).astype(np.float32)).to(dtype)
    ss = t(rng.normal(size=(2, 2 * c)).astype(np.float32))
    sc, bi = t((1 + 0.3 * rng.normal(size=c)).astype(np.float32)), t(rng.normal(size=c).astype(np.float32))
    am = t(np.abs(rng.normal(size=c)).astype(np.float32) + 0.1)
    q = adagn_silu_q8(x, ss, 2, am)
    assert q.dtype == torch.int8
    assert torch.equal(q, quantize_static(adagn_silu(x, ss, 2), am))
    assert torch.equal(groupnorm_silu_q8(x, sc, bi, 2, am),
                       quantize_static(groupnorm_silu(x, sc, bi, 2), am))
    assert (q.abs() == 127).any() and (q == 0).any()  # clipping and zero both exercised


@pytest.mark.parametrize("stride,cin,h", [(1, 16, 8), (2, 16, 8), (1, 128, 8), (2, 128, 9),
                                          (1, 6, 8)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_conv3x3_q8_static_plain_matches_jax(stride, cin, h, out_dtype):
    """K5 against quant.conv3x3_q8_static, then the module's cast and bias in
    ``out_dtype`` (blocks.py:202, :210), with the calibration-time fold and without it;
    an int8 x of the same codes gives the same result."""
    rng = np.random.default_rng(4)
    x = _spread(rng, (2, h, h, cin))
    w = (rng.normal(size=(3, 3, cin, 24)) * 0.1).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    act_max = _act_max(x) * 0.9  # some inputs clip
    jdt, pdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    wq, sw = jquant.fold_quantize_weight(jnp.asarray(w), jnp.asarray(act_max))
    ref = np.asarray((jquant.conv3x3_q8_static(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(act_max), stride)
                      .astype(jdt) + jnp.asarray(b).astype(jdt)).astype(jnp.float32))
    ys = [quant.conv3x3_q8_static(t(x), t(w), t(act_max), stride, bias=t(b), out_dtype=pdt),
          quant.conv3x3_q8_static(t(x), t(w), t(act_max), stride, t(np.asarray(wq)),
                                  t(np.asarray(sw)), t(b), pdt),
          quant.conv3x3_q8_static(quantize_static(t(x), t(act_max)), t(w), t(act_max), stride,
                                  bias=t(b), out_dtype=pdt)]
    for y in ys:
        assert y.dtype == pdt and y.shape == ref.shape
        if pdt == torch.bfloat16:
            np.testing.assert_array_equal(y.float().numpy(), ref)
        else:
            assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(40, 16), (2, 8, 8, 16), (3, 5)])
def test_matmul_q8_static_matches_jax(shape):
    rng = np.random.default_rng(5)
    x = _spread(rng, shape)
    w = (rng.normal(size=(shape[-1], 24)) * 0.1).astype(np.float32)
    act_max = _act_max(x)
    ref = np.asarray(jquant.matmul_q8_static(jnp.asarray(x), jnp.asarray(w), jnp.asarray(act_max)))
    y = quant.matmul_q8_static(t(x), t(w), t(act_max))
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("stride,cin", [(1, 16), (2, 16), (1, 128)])
def test_conv3x3_qtensor_matches_jax(stride, cin):
    """The QTensor conv (per-sample factor in K5's epilogue) on the Pallas kernel's
    QTensor."""
    rng = np.random.default_rng(6)
    x = jnp.asarray((rng.normal(size=(2, 8, 8, cin)) * 3).astype(np.float32))
    mean_c, inv_c = jq8.group_stats_channels(x, max(1, cin // 32))
    gamma = jnp.asarray(rng.normal(size=(2, cin)).astype(np.float32))
    beta = jnp.asarray(rng.normal(size=(2, cin)).astype(np.float32))
    qj = jq8.norm_affine_silu_q8(x, mean_c, inv_c, gamma, beta, interpret=True)
    w = (rng.normal(size=(3, 3, cin, 8)) * 0.1).astype(np.float32)
    ref = np.asarray(jq8.conv3x3_qtensor(qj, jnp.asarray(w), stride))
    y = conv3x3_qtensor(QTensor(t(np.asarray(qj.q)), t(np.asarray(qj.scale))), t(w), stride)
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_int8_wrappers_take_the_plain_versions_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(2, 8, 8, 32)).astype(np.float32))
    am = t(np.abs(rng.normal(size=32)).astype(np.float32) + 0.1)
    wq = torch.randint(-127, 128, (3, 3, 32, 16), dtype=torch.int8)
    ws = torch.rand(16) / 100
    rows = [t(rng.normal(size=(2, 32)).astype(np.float32)) for _ in range(4)]
    fns = (conv3x3_int8, norm_affine_silu_q8, adagn_silu_q8, groupnorm_silu_q8)
    counts = [f.launches for f in fns]
    assert torch.equal(conv3x3_int8(x, wq, ws, am, None, 2),
                       conv3x3_int8_plain(x, wq, ws, am, None, 2))
    assert torch.equal(norm_affine_silu_q8(x, *rows).q, norm_affine_silu_q8_plain(x, *rows).q)
    ss = t(rng.normal(size=(2, 64)).astype(np.float32))
    assert torch.equal(adagn_silu_q8(x, ss, 1, am), adagn_silu_q8_plain(x, ss, 1, am))
    one, zero = torch.ones(32), torch.zeros(32)
    assert torch.equal(groupnorm_silu_q8(x, one, zero, 1, am),
                       groupnorm_silu_q8_plain(x, one, zero, 1, am))
    assert [f.launches for f in fns] == counts
    if not torch.cuda.is_available():
        assert counts == [0, 0, 0, 0]


def test_int8_modules_import_and_run_on_cpu_without_nvcc(tmp_path):
    """Importing the int8 modules builds nothing; CPU calls need no CUDA toolkit."""
    code = ("import torch, diamond_tpu_torch.kernels as k\n"
            "from diamond_tpu_torch.ops import quant, adagn_silu_q8\n"
            "x = torch.randn(1, 4, 4, 32); am = torch.ones(32)\n"
            "quant.conv3x3_q8_static(x, torch.randn(3, 3, 32, 8), am)\n"
            "quant.matmul_q8_static(x, torch.randn(32, 8), am)\n"
            "adagn_silu_q8(x, torch.randn(1, 64), 1, am)\n"
            "assert k._lib is None\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
