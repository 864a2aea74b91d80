"""diamond_tpu_torch's CUDA kernels on a card: each against its plain PyTorch version
on the same inputs, at shapes of the rollout. Skips where there is no GPU.

This file imports no jax, so it also runs where the JAX package cannot be imported
(the GPU machine has no jax): ``python3 -m pytest tests/test_torch_cuda.py -q
--noconftest`` from the repo root (tests/conftest.py imports jax)."""

import pytest
import torch

from diamond_tpu_torch.ops import (adagn_silu, adagn_silu_plain, conv3x3, conv3x3_plain,
                                   groupnorm_silu, groupnorm_silu_plain)


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
