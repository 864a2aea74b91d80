"""diamond_tpu_torch's CUDA kernels on a card: each against its plain PyTorch version
on the same inputs, at shapes of the rollout. Skips where there is no GPU.

This file imports no jax, so it also runs where the JAX package cannot be imported
(the GPU machine has no jax): ``python3 -m pytest tests/test_torch_cuda.py -q
--noconftest`` from the repo root (tests/conftest.py imports jax)."""

import pytest
import torch

from diamond_tpu_torch.ops import (QTensor, adagn_silu, adagn_silu_plain, adagn_silu_q8,
                                   adagn_silu_q8_plain, conv3x3, conv3x3_int8,
                                   conv3x3_int8_plain, conv3x3_plain, conv3x3_qtensor,
                                   groupnorm_silu, groupnorm_silu_plain, groupnorm_silu_q8,
                                   groupnorm_silu_q8_plain, norm_affine_silu_q8,
                                   norm_affine_silu_q8_plain, quant, quantize_static)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: each kernel against its plain version on the same inputs, at shapes of
    the rollout. f32 with TF32 off: 1e-3 of the largest |value| (sums of up to 1152
    terms in another order); bf16: 1/64 of it (both round once to bf16, which can differ
    by one bf16 ulp = 1/128 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-3 if dt == torch.float32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(0)

    def check(a, b):
        torch.cuda.synchronize()
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale

    for b, h, cin, cout, s, bias in [(4, 64, 64, 64, 1, True), (4, 64, 3, 64, 1, False),
                                     (4, 64, 12, 64, 1, False), (4, 64, 64, 64, 2, True),
                                     (4, 16, 128, 64, 1, True), (4, 64, 64, 3, 1, True)]:
        x = torch.randn(b, h, h, cin, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        bb = torch.randn(cout, device="cuda", generator=g) if bias else None
        check(conv3x3(x, k, bb, s), conv3x3_plain(x, k, bb, s))
    for b, h, c in [(4, 64, 64), (4, 8, 128), (4, 32, 32), (2, 16, 96), (2, 8, 512)]:
        x = (torch.randn(b, h, h, c, device="cuda", generator=g) * 2 + 0.5).to(dt)
        ss = torch.randn(b, 2 * c, device="cuda", generator=g)
        sc, bi = ss[0, :c] + 1, ss[1, c:]
        for silu in (True, False):
            check(adagn_silu(x, ss, c // 32, silu), adagn_silu_plain(x, ss, c // 32, silu))
            check(groupnorm_silu(x, sc, bi, c // 32, silu),
                  groupnorm_silu_plain(x, sc, bi, c // 32, silu))


@pytest.mark.cuda
def test_model_on_the_card_goes_through_the_kernels_and_matches_the_cpu():
    """A small InnerModel (all three kernels on its path) in f32 on the card, against the
    same model on the CPU (plain versions): the launch counters rise, and outputs agree
    to 1e-3 (f32 sums in other orders, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.config import InnerModelConfig
    from diamond_tpu_torch.models.blocks import init_weights
    from diamond_tpu_torch.models.inner_model import InnerModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = InnerModelConfig(cond_channels=32, depths=[1, 1], channels=[32, 64],
                           attn_depths=[0, 1], num_actions=4)
    g = torch.Generator().manual_seed(0)
    cpu = InnerModel(cfg)
    init_weights(cpu, g)
    with torch.no_grad():
        for p in cpu.parameters():  # no zero-init leaves: every layer shapes the output
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu = InnerModel(cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    args = (torch.randn(2, 16, 16, 3, generator=g), torch.randn(2, generator=g),
            torch.rand(2, 16, 16, 12, generator=g) * 2 - 1, torch.randint(0, 4, (2, 4), generator=g))
    before = (conv3x3.launches, adagn_silu.launches, groupnorm_silu.launches)
    with torch.no_grad():
        y_gpu = gpu(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        y_cpu = cpu(*args)
    after = (conv3x3.launches, adagn_silu.launches, groupnorm_silu.launches)
    assert all(a > b for a, b in zip(after, before))
    assert (y_gpu.cpu() - y_cpu).abs().max().item() <= 1e-3 * max(1.0, y_cpu.abs().max().item())


def _codes_close(a, b, share=1e-3):
    """int8 codes at most 1 apart, in at most ``share`` of the elements (one f32 ulp
    apart, a value can round to the neighbouring code)."""
    d = (a.int() - b.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() <= share


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_kernels_match_plain_versions(dtype):
    """On the card: K4's static epilogue equals quantize(K1/K2 kernel output) code for
    code, and its plain version within one code in 0.1 % of the elements (the kernels
    fuse a multiply-add the plain versions round twice); K4's per-sample epilogue within
    one code in 0.1 %, scales to rtol 1e-5; K5 equals its plain version exactly (int8
    sums are exact and every f32 step is the same IEEE operation), from int8, bf16 and
    f32 inputs, every Cin and Cout class of the rollout, stride 1 and 2, with and
    without bias, and with a QTensor's per-sample scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    for b, h, c in [(4, 64, 64), (4, 8, 128), (4, 32, 32), (2, 16, 96)]:
        x = (rnd(b, h, h, c) * 2 + 0.5).to(dt)
        ss, am = rnd(b, 2 * c), rnd(c).abs() + 0.2
        sc, bi = ss[0, :c] + 1, ss[1, c:]
        q = adagn_silu_q8(x, ss, c // 32, am)
        torch.cuda.synchronize()
        assert torch.equal(q, quantize_static(adagn_silu(x, ss, c // 32), am))
        _codes_close(q, adagn_silu_q8_plain(x, ss, c // 32, am))
        q = groupnorm_silu_q8(x, sc, bi, c // 32, am)
        assert torch.equal(q, quantize_static(groupnorm_silu(x, sc, bi, c // 32), am))
        _codes_close(q, groupnorm_silu_q8_plain(x, sc, bi, c // 32, am))
        rows = [rnd(b, c), rnd(b, c).abs() + 0.5, rnd(b, c), rnd(b, c)]
        qt, ref = norm_affine_silu_q8(x, *rows), norm_affine_silu_q8_plain(x, *rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(qt.scale, ref.scale, rtol=1e-5, atol=0)
        _codes_close(qt.q, ref.q)

    for b, h, cin, cout, s, bias in [(4, 64, 64, 64, 1, True), (4, 64, 6, 32, 1, True),
                                     (4, 64, 64, 64, 2, True), (4, 16, 128, 64, 1, True),
                                     (4, 64, 64, 3, 1, True), (4, 8, 32, 32, 2, False),
                                     (2, 9, 16, 24, 2, True)]:
        x = rnd(b, h, h, cin).to(dt)
        am = x.float().abs().amax(dim=(0, 1, 2)) * 0.9
        w = rnd(3, 3, cin, cout) / (9 * cin) ** 0.5
        wq, ws = quant.fold_quantize_weight(w, am)
        bb = rnd(cout) if bias else None
        for xin in (x, quantize_static(x, am)):
            y = conv3x3_int8(xin, wq, ws, am, bb, s, dt)
            torch.cuda.synchronize()
            assert y.dtype == dt and torch.equal(y, conv3x3_int8_plain(xin, wq, ws, am, bb, s, dt))
        qx = QTensor(quantize_static(x, am), rnd(b, 1).abs())
        y, ref = conv3x3_qtensor(qx, w, s), conv3x3_qtensor(QTensor(qx.q.cpu(), qx.scale.cpu()),
                                                            w.cpu(), s)
        assert torch.equal(y.cpu(), ref)


@pytest.mark.cuda
def test_int8_matmul_routes_agree_on_the_card():
    """matmul_q8_static: torch._int_mm (shapes it takes) and the float64 route give the
    same result; both are exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in [(2048, 32, 96), (32, 2048, 2048), (32, 512, 5), (8, 64, 64)]:
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
        am = x.abs().amax(dim=0)
        assert torch.equal(quant.matmul_q8_static(x, w, am).cpu(),
                           quant.matmul_q8_static(x.cpu(), w.cpu(), am.cpu()))


@pytest.mark.cuda
def test_agent_defaults_to_the_card():
    """``Agent(cfg)`` without a device puts every model on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.config import AgentConfig
    from diamond_tpu_torch.models import Agent

    agent = Agent(AgentConfig(), generator=torch.Generator().manual_seed(0))
    for net in agent.nets.values():
        assert all(p.is_cuda for p in net.parameters())
