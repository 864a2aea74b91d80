"""diamond_tpu_torch's int8 matmul sites (K6, ops/matmul_q8.py, and quant.matmul_q8_static
with the bias and dtype of its sites) and the dynamic-scale int8 conv (K7,
quant.conv3x3_q8) against diamond_tpu.ops.quant on the CPU, where the wrappers take their
plain versions, on the same numpy inputs.

Tolerances: codes are equal (the same true IEEE division and round half to even on both
sides) and the int8 sums exact, so bf16 outputs are equal and f32 ones within 1e-5 of
the largest |value| (XLA may fuse the rescale and the bias into one operation). K7's sx
is equal to the JAX function's run op by op, as tests/test_ops.py runs it; under jit XLA
turns its division by 127 into a multiply by 1/127 (one ulp apart), which the port does
not follow: it keeps the function's formula."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.models import blocks as jb
from diamond_tpu.models.lstm import LSTMCell as JLSTMCell
from diamond_tpu.ops import quant as jquant
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import blocks as tb
from diamond_tpu_torch.models.lstm import LSTMCell
from diamond_tpu_torch.ops import (absmax_quantize_q8, absmax_quantize_q8_plain, kmajor_2d,
                                   matmul_int8, matmul_int8_plain, quant, quantize_static)

from torch_port_util import jax_and_port, t


def _spread(rng, shape):
    """Random activations whose channels span 1000x in range, as after real norms."""
    x = rng.normal(size=shape).astype(np.float32)
    return x * np.logspace(-2, 1, shape[-1], dtype=np.float32)


def _act_max(x):
    return np.abs(x).reshape(-1, x.shape[-1]).max(axis=0)


# x's shape, N: a 1x1 conv's 4-D input, a dense layer's rows, one row, K = 15 and N = 5
# (no multiple of 8), and the mid attention's qkv width N = 192
MATMUL_CASES = {"conv1x1": ((2, 8, 8, 32), 48), "dense": ((20, 32), 24), "m1": ((1, 32), 16),
                "k15_n5": ((7, 15), 5), "n192": ((2, 4, 4, 64), 192)}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("folded", [False, True])
def test_matmul_q8_static_with_bias_and_dtype_matches_jax(case, out_dtype, folded):
    """quant.matmul_q8_static with the site's bias and dtype (added in K6's epilogue)
    against ``jquant.matmul_q8_static(...).astype(dt) + b.astype(dt)`` (blocks.py:104,
    :109), with the calibration-time fold and without it."""
    shape, n = MATMUL_CASES[case]
    rng = np.random.default_rng(31)
    x = _spread(rng, shape)
    w = (rng.normal(size=(shape[-1], n)) * 0.1).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    act_max = _act_max(x) * 0.9  # some values clip
    jdt, pdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    wq, sw = jquant.fold_quantize_weight(jnp.asarray(w), jnp.asarray(act_max))
    ref = np.asarray((jquant.matmul_q8_static(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(act_max))
                      .astype(jdt) + jnp.asarray(b).astype(jdt)).astype(jnp.float32))
    fold = (t(np.asarray(wq)), t(np.asarray(sw))) if folded else (None, None)
    y = quant.matmul_q8_static(t(x), t(w), t(act_max), *fold, bias=t(b), out_dtype=pdt)
    assert y.dtype == pdt and y.shape == ref.shape
    if pdt == torch.bfloat16:
        np.testing.assert_array_equal(y.float().numpy(), ref)
    else:
        assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_matmul_codes_equal_jax(case):
    """The codes K6's plain version multiplies equal the JAX function's xq."""
    shape, _ = MATMUL_CASES[case]
    rng = np.random.default_rng(32)
    x = _spread(rng, shape)
    act_max = _act_max(x) * 0.8
    s_c = jnp.maximum(jnp.asarray(act_max), 1e-8) * jquant.ACT_SCALE_HEADROOM / 127.0
    ref = jnp.clip(jnp.round(jnp.asarray(x) / s_c), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(quantize_static(t(x), t(act_max)).numpy(), np.asarray(ref))


def test_matmul_int8_plain_takes_codes_strides_and_f32_or_bf16():
    """matmul_int8 on the CPU is its plain version: int8 codes are refused (as on the
    card), a row-strided x (a time step of a sequence) gives the contiguous one's result,
    and a bf16 output the f32 one rounded with the bias added in bf16; the K-major copy is
    w_q's columns, zero-padded to 32."""
    rng = np.random.default_rng(33)
    seq = t(_spread(rng, (3, 5, 40)))
    x = seq[:, 2]
    am = x.abs().amax(dim=0) * 0.9
    wq = torch.randint(-127, 128, (40, 12), dtype=torch.int8)
    ws = torch.rand(12) / 100
    b = torch.randn(12)
    y = matmul_int8(x, wq, ws, am, b)
    assert torch.equal(y, matmul_int8_plain(x.contiguous(), wq, ws, am, b))
    with pytest.raises(ValueError):
        matmul_int8(quantize_static(x, am), wq, ws, am, b)
    ybf = matmul_int8(x, wq, ws, am, b, torch.bfloat16)
    nob = matmul_int8(x, wq, ws, am)
    assert torch.equal(ybf, nob.to(torch.bfloat16) + b.to(torch.bfloat16))
    wk = kmajor_2d(wq)
    assert wk.shape == (12, 64) and wk.is_contiguous()
    assert torch.equal(wk[:, :40].t(), wq) and not wk[:, 40:].any()


def test_matmul_q8_static_folds_a_1x1_conv_kernel_as_its_matrix():
    """A 1x1 conv hands its (1, 1, Cin, Cout) kernel as it is: folded here, it gives the
    (Cin, Cout) matrix's result."""
    rng = np.random.default_rng(36)
    x = t(_spread(rng, (2, 4, 4, 24)))
    w = t((rng.normal(size=(1, 1, 24, 10)) * 0.1).astype(np.float32))
    am, b = x.abs().reshape(-1, 24).amax(dim=0), t(rng.normal(size=(10,)).astype(np.float32))
    y = quant.matmul_q8_static(x, w, am, bias=b, out_dtype=torch.bfloat16)
    assert torch.equal(y, quant.matmul_q8_static(x, w[0, 0], am, bias=b,
                                                 out_dtype=torch.bfloat16))


@pytest.mark.parametrize("name", ["matmul_int8", "conv3x3_int8"])
def test_chip_smoke_bound_reads_the_weight_once(name):
    """chip_smoke's bound for K6 and K5 counts x, w_q, the scales, act_max and the bias
    once and y once, and never the K-major copy of w_q that the kernels read instead."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from diamond_tpu_torch.ops import kmajor_weights

    k, n = 128, 64
    am, ws, b = torch.ones(k), torch.ones(n), torch.ones(n)
    if name == "matmul_int8":
        x, wq = torch.zeros(4, k, dtype=torch.bfloat16), torch.zeros(k, n, dtype=torch.int8)
        args = (x, wq, ws, am, b, torch.bfloat16, kmajor_2d(wq))
        y_bytes = 4 * n * 2
    else:
        x = torch.zeros(2, 8, 8, k, dtype=torch.bfloat16)
        wq = torch.zeros(3, 3, k, n, dtype=torch.int8)
        args = (x, wq, ws, am, b, 1, torch.bfloat16, None, kmajor_weights(wq))
        y_bytes = 2 * 8 * 8 * n * 2
    need = x.numel() * 2 + wq.numel() + 4 * (n + k + n) + y_bytes
    for given in (args, cs.plain_args(name, args)):
        t_bytes, _ = cs.bound(name, given)
        assert t_bytes == pytest.approx(need / cs.HBM_BYTES_S * 1e3, rel=1e-12)


def jax_tree_np(tree):
    return {k: jax_tree_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _bf16_site(name):
    rng = np.random.default_rng(34)
    if name == "conv1x1":
        return (jb.Conv1x1(48, jnp.bfloat16), tb.Conv1x1(32, 48, torch.bfloat16),
                _spread(rng, (2, 8, 8, 32)) * 2)
    return (jb.QDense(24, jnp.bfloat16), tb.QDense(32, 24, torch.bfloat16),
            _spread(rng, (20, 32)) * 2)


@pytest.mark.parametrize("name", ["conv1x1", "dense"])
def test_bf16_site_modules_match_jax_with_the_bias_in_the_epilogue(name):
    """The bf16 Conv1x1 and QDense int8 branches (one K6 call each, the bias added in
    bf16 in its epilogue) equal their flax twins' with the same "quant" collection bit
    for bit; the calibrated collection matches JAX's."""
    jm, pm, x = _bf16_site(name)
    v, m = jax_and_port(jm, pm, 5, x)
    registry = {}
    with jquant.int8_rollout_scope(True), jquant.calibration_scope(registry):
        jm.apply(v, x)
    coll_j = jquant.registry_to_collection(registry)
    reg_p = {}
    with torch.no_grad(), quant.int8_scope(True), quant.calibration_scope(reg_p, m):
        m(t(x))
    coll_p = quant.registry_to_collection(reg_p)
    np.testing.assert_array_equal(coll_p["w_q"].numpy(), np.asarray(coll_j["w_q"]))
    load_variables(m, dict(v, quant=jax_tree_np(coll_j)))
    with jquant.int8_rollout_scope(True):
        y_j = np.asarray(jm.apply(dict(v, quant=coll_j), x).astype(jnp.float32))
    with torch.no_grad(), quant.int8_scope(True):
        y_p = m(t(x))
    assert y_p.dtype == torch.bfloat16
    assert m.w_k is not None and torch.equal(m.w_k, kmajor_2d(m.w_q))
    np.testing.assert_array_equal(y_p.float().numpy(), y_j)


def _lstm(seed=35, in_features=20, hidden=12):
    jm, pm = JLSTMCell(hidden), LSTMCell(in_features, hidden)
    rng = np.random.default_rng(seed)
    x = _spread(rng, (3, in_features)) * 2
    carry = ((rng.normal(size=(3, hidden)) * 0.25).astype(np.float32),
             rng.normal(size=(3, hidden)).astype(np.float32))
    v, m = jax_and_port(jm, pm, seed, carry, x)
    return jm, m, v, x, carry


def test_lstm_cell_int8_matches_jax_at_ragged_widths():
    """The LSTM cell's int8 branch (two K6 products in f32, summed with the biases in
    f32, as lstm.py:75-77 does) against the flax cell at K = 20 and 12, N = 48: within
    1e-5 of the largest |value|."""
    jm, m, v, x, carry = _lstm()
    am = _act_max(x) * 0.9
    vq = dict(v, quant={"act_scale": am})
    load_variables(m, vq)
    with jquant.int8_rollout_scope(True):
        (hj, cj), _ = jm.apply(vq, carry, x)
    with torch.no_grad(), quant.int8_scope(True):
        (hp, cp), _ = m((t(carry[0]), t(carry[1])), t(x))
    (hf, _), _ = jm.apply(v, carry, x)
    assert not np.array_equal(np.asarray(hj), np.asarray(hf))
    for p, j in ((hp, hj), (cp, cj)):
        assert np.abs(p.numpy() - np.asarray(j)).max() <= 1e-5 * np.abs(np.asarray(j)).max()


def test_lstm_fold_is_made_once_at_install_and_equals_the_per_call_fold():
    """``install`` folds both LSTM weights (the input side with act_scale, the hidden
    side with ones) into buffers that are no part of the collection: their codes and
    scales equal ``fold_quantize_weight`` of the weights by construction, the cell's
    output equals the per-call fold's, ``strip`` drops them, and a weight updated after
    the install shows in ``folded_from_current_weights``."""
    _, m, _, x, carry = _lstm(36)
    am = t(_act_max(x))
    quant.install(m, {"act_scale": am})
    for wq, ws, wk, w, a in ((m.ih_q, m.ih_scale, m.ih_k, m.weight_ih, am),
                             (m.hh_q, m.hh_scale, m.hh_k, m.weight_hh, torch.ones(12))):
        ref_q, ref_s = quant.fold_quantize_weight(w, a)
        assert torch.equal(wq, ref_q) and torch.equal(ws, ref_s)
        assert torch.equal(wk, kmajor_2d(ref_q)) and not wq.requires_grad
    assert torch.equal(m.hh_max, torch.ones(12))
    assert set(quant.collection(m)[""]) == {"act_scale"}  # (the cell is the root)
    assert quant.folded_from_current_weights(m)
    hx, cx = t(carry[0]), t(carry[1])
    with torch.no_grad(), quant.int8_scope(True):
        (h, c), _ = m((hx, cx), t(x))
        gates = (quant.matmul_q8_static(t(x), m.weight_ih, am)
                 + quant.matmul_q8_static(hx, m.weight_hh, torch.ones(12))
                 + (m.bias_ih + m.bias_hh))
        i, f, g, o = gates.chunk(4, dim=-1)
        c_ref = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
    assert torch.equal(c, c_ref)
    assert torch.equal(h, torch.sigmoid(o) * torch.tanh(c_ref))
    with torch.no_grad():
        m.weight_hh.mul_(1.5)
    assert not quant.folded_from_current_weights(m)
    quant.strip(m)
    assert all(getattr(m, k) is None for k in quant.LSTM_DERIVED)


@pytest.mark.parametrize("stride,cin", [(1, 15), (2, 15), (1, 64), (2, 64)])
def test_conv3x3_q8_matches_jax(stride, cin):
    """quant.conv3x3_q8 (K7's quantize, then K5 with sx * sw in its epilogue) against
    jquant.conv3x3_q8 run op by op: codes and sx equal, the output within 1e-5 relative."""
    rng = np.random.default_rng(37 + cin + stride)
    x = (rng.normal(size=(2, 9, 9, cin)) * 2.5).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, 16)) * 0.1).astype(np.float32)
    xf = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / 127.0  # quant.py:226-227
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    qt = absmax_quantize_q8(t(x))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(xq))
    assert qt.scale.shape == (2, 1) and (qt.scale.numpy() == np.asarray(sx)).all()
    ref = np.asarray(jquant.conv3x3_q8(xf, jnp.asarray(w), stride))
    y = quant.conv3x3_q8(t(x), t(w), stride)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_absmax_quantize_plain_of_bf16_and_zero_input():
    """A bf16 x is quantized from its f32 values; an all-zero x gets sx = 1e-12 / 127 and
    code 0 everywhere."""
    x = torch.randn(2, 4, 4, 8).to(torch.bfloat16)
    assert torch.equal(absmax_quantize_q8(x).q, absmax_quantize_q8_plain(x.float()).q)
    z = absmax_quantize_q8(torch.zeros(3, 2, 2, 4))
    assert not z.q.any() and (z.scale == torch.tensor(1e-12) / torch.tensor(127.0)).all()
