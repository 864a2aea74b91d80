"""The plain reference (benchmarks/reference) against the program at a small size on the
CPU, with the same weights, in float32; and the benchmark's counts of operations and
bytes against counts by hand.

    python -m pytest benchmarks/tests -q
"""

import math
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import work  # noqa: E402
from reference import models as ref  # noqa: E402
from reference.optim import AdamW  # noqa: E402

INNER = dict(img_channels=3, num_steps_conditioning=2, cond_channels=16, depths=[1, 1],
             channels=[8, 8], attn_depths=[0, 1], num_actions=4)
REW_END = dict(lstm_dim=16, img_channels=3, img_size=16, cond_channels=8, depths=[1, 1],
               channels=[8, 8], attn_depths=[0, 0], num_actions=4)
AC = dict(lstm_dim=16, img_channels=3, img_size=16, channels=[8, 8], down=[1, 1],
          num_actions=4)


def weights(model, cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return ref.make_weights(ref.param_specs(model, cfg), g, "cpu")


def close(a, b, tol=1e-4):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_inner_model_matches_the_program():
    from diamond_tpu_torch.config import InnerModelConfig
    from diamond_tpu_torch.models.inner_model import InnerModel

    cfg = dict(INNER, num_steps_conditioning=2)
    net = InnerModel(InnerModelConfig(**cfg), torch.float32)
    W = weights("denoiser", dict(inner_model=cfg))
    net.load_state_dict(W, strict=True)
    g = torch.Generator().manual_seed(1)
    n = cfg["num_steps_conditioning"]
    noisy = torch.randn((3, 16, 16, 3), generator=g)
    obs = torch.randn((3, 16, 16, 3 * n), generator=g)
    c_noise = torch.randn((3,), generator=g)
    act = torch.randint(0, 4, (3, n), generator=g)
    with torch.no_grad():
        assert close(net(noisy, c_noise, obs, act),
                     ref.inner_model(ref.Ctx(), W, cfg, noisy, c_noise, obs, act))


def test_denoiser_loss_and_sampling_match_the_program():
    from diamond_tpu_torch.config import (DenoiserConfig, DiffusionSamplerConfig,
                                          InnerModelConfig, SigmaDistributionConfig)
    from diamond_tpu_torch.models.denoiser import Denoiser, DenoiserDraws
    from diamond_tpu_torch.models.diffusion_sampler import DiffusionSampler

    den = Denoiser(DenoiserConfig(inner_model=InnerModelConfig(**INNER)), torch.float32)
    dcfg = dict(inner_model=INNER, sigma_data=0.5, sigma_offset_noise=0.3)
    W = weights("denoiser", dcfg)
    den.inner_model.load_state_dict(W, strict=True)
    g = torch.Generator().manual_seed(2)
    obs = torch.randint(0, 256, (3, 4, 16, 16, 3), generator=g).float() / 255 * 2 - 1
    act = torch.randint(0, 4, (3, 4), generator=g)
    mask = torch.ones((3, 4), dtype=torch.bool)
    mask[0, 2] = False
    draws = (torch.randn((2, 3), generator=g), torch.randn((2, 3, 1, 1, 3), generator=g),
             torch.randn((2, 3, 16, 16, 3), generator=g))
    scfg = dict(loc=-0.4, scale=1.2, sigma_min=0.002, sigma_max=20.0)
    with torch.no_grad():
        loss, _ = den.loss(obs, act, mask, SigmaDistributionConfig(**scfg), DenoiserDraws(*draws))
        assert close(loss, ref.denoiser_loss(ref.Ctx(), W, dcfg, scfg, obs, act, mask, draws))
        sc = dict(num_steps_denoising=3, sigma_min=0.002, sigma_max=5.0, rho=7, order=1,
                  s_churn=0.0)
        x0 = torch.randn((3, 16, 16, 3), generator=g)
        a = DiffusionSampler(den, DiffusionSamplerConfig(**sc)).sample(obs[:, :2], act[:, :2],
                                                                       x_init=x0)
        b = ref.sample_frame(ref.Ctx(), W, dcfg, sc, obs[:, :2], act[:, :2], x0)
        assert float((a - b).abs().max()) * 127.5 <= 1.0 + 1e-4  # a grid level at most


def test_rew_end_model_and_loss_match_the_program():
    from diamond_tpu_torch.config import RewEndModelConfig
    from diamond_tpu_torch.models.rew_end_model import RewEndModel

    m = RewEndModel(RewEndModelConfig(**REW_END), torch.float32)
    W = weights("rew_end_model", REW_END)
    m.net.load_state_dict(W, strict=True)
    g = torch.Generator().manual_seed(5)
    obs = torch.randint(0, 256, (3, 5, 16, 16, 3), generator=g).float() / 255 * 2 - 1
    act = torch.randint(0, 4, (3, 5), generator=g)
    rew = torch.tensor([[0, 1, 0, -1, 3]] * 3).float()
    end = torch.zeros((3, 5), dtype=torch.long)
    end[1, 2] = 1
    mask = torch.ones((3, 5), dtype=torch.bool)
    mask[1, 3:] = False
    final = torch.rand((3, 16, 16, 3), generator=g) * 2 - 1
    has = torch.tensor([False, True, False])
    with torch.no_grad():
        loss, mets = m.loss(obs, act, rew, end, mask, final, has)
        lr_, le_ = ref.rew_end_loss(ref.Ctx(), W, REW_END, obs, act, rew, end, mask, final, has)
        assert close(mets["loss_rew"], lr_) and close(mets["loss_end"], le_)


def test_actor_critic_matches_the_program():
    from diamond_tpu_torch.config import ActorCriticConfig
    from diamond_tpu_torch.models.actor_critic import ActorCritic

    ac = ActorCritic(ActorCriticConfig(**AC), torch.float32)
    W = weights("actor_critic", AC)
    ac.net.load_state_dict(W, strict=True)
    g = torch.Generator().manual_seed(6)
    obs = torch.rand((3, 16, 16, 3), generator=g) * 2 - 1
    carry = (torch.randn((3, 16), generator=g), torch.randn((3, 16), generator=g))
    with torch.no_grad():
        out = ac.head(ac.encode(obs), carry)
        logits, val, (h, c) = ref.ac_head(ref.Ctx(), W, ref.ac_encode(ref.Ctx(), W, AC, obs),
                                          carry)
        assert close(out.logits_act, logits) and close(out.val, val)
        assert close(out.carry[0], h) and close(out.carry[1], c)


def test_int8_sites_match_the_programs_plain_int8():
    from diamond_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 8, 8, 16), generator=g)
    w = torch.randn((3, 3, 16, 8), generator=g) / 12
    act_max = x.abs().amax(dim=(0, 1, 2))
    W = {"c.kernel": w, "c.bias": torch.zeros(8), "d.kernel": w[0, 0], "d.bias": torch.zeros(8)}
    ctx = ref.Ctx(quant={"c": act_max, "d": act_max[:16]}, kinds=("conv3x3", "dense"))
    with torch.no_grad():
        a = quant.conv3x3_q8_static(x, w, act_max)
        b = ref.conv3x3(ctx, W, "c", x)
        wq, sw = quant.fold_quantize_weight(w, act_max)
        assert close(a, b, 1e-5)
        a = quant.matmul_q8_static(x, w[0, 0], act_max)
        b = ref.dense(ctx, W, "d", x)
        assert close(a, b, 1e-5)


def test_optimizer_matches_the_program():
    from diamond_tpu_torch.models.agent import configure_opt

    g = torch.Generator().manual_seed(8)
    net = torch.nn.Module()
    net.kernel = torch.nn.Parameter(torch.randn((4, 3), generator=g))
    net.bias = torch.nn.Parameter(torch.randn((3,), generator=g))
    W = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = configure_opt(1e-2, 0.1, 1e-8, 1.0, 2)
    opt = tx.init(net)
    mine = AdamW(1e-2, 0.1, 1e-8, 1.0, 2)
    for i in range(3):
        grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in W.items()}
        for k, p in net.named_parameters():
            p.grad = grads[k].clone()
        tx.update(opt, i)
        W = mine.step(W, mine.clip(grads))
    for k, p in net.named_parameters():
        assert close(p.detach(), W[k], 1e-6)


def test_work_counts_against_counts_by_hand():
    ops = []
    ctx = ref.Ctx(ops=ops, trained=True)
    x = torch.empty((2, 8, 8, 4), device="meta", requires_grad=True)
    W = {"c.kernel": torch.empty((3, 3, 4, 6), device="meta", requires_grad=True),
         "c.bias": torch.empty((6,), device="meta", requires_grad=True)}
    ref.conv3x3(ctx, W, "c", x)
    ref.conv3x3(ctx, W, "c", x, stride=2)
    a, b = ops
    assert a["flops"] == 2 * 2 * 8 * 8 * 9 * 4 * 6
    assert b["flops"] == 2 * 2 * 4 * 4 * 9 * 4 * 6
    assert a["bytes"] == 2 * (2 * 8 * 8 * 4 + 9 * 4 * 6 + 2 * 8 * 8 * 6)
    assert work.passes(a) == 3 and a["trained"] and a["needs_dx"]
    least = max(a["bytes"] / 3.35e12, a["flops"] / 989e12)
    assert math.isclose(work.least_s(a), 3 * least)
    assert math.isclose(work.flops_s([a]), 3 * a["flops"] / 989e12)
    q = dict(a, int8=True, trained=False, needs_dx=False)
    assert math.isclose(work.least_s(q), max(q["bytes"] / 3.35e12, q["flops"] / 1979e12))
    # a small U-Net forward: conv_in, conv_out, two convs in each of 8 ResBlocks, one
    # down and one up
    ops.clear()
    dcfg = dict(inner_model=dict(INNER, attn_depths=[0, 0]), sigma_data=0.5,
                sigma_offset_noise=0.3)
    Wm = {k: torch.empty(s[0], device="meta")
          for k, s in ref.param_specs("denoiser", dcfg).items()}
    meta = dict(device="meta")
    ref.inner_model(ctx, Wm, dcfg["inner_model"], torch.empty((2, 16, 16, 3), **meta),
                    torch.empty((2,), **meta), torch.empty((2, 16, 16, 6), **meta),
                    torch.empty((2, 2), dtype=torch.long, **meta))
    convs = [o for o in ops if o["kind"] == "conv3x3"]
    assert len(convs) == 2 + 2 * 8 + 2
    assert convs[0]["flops"] == 2 * 2 * 16 * 16 * 9 * 9 * 8 and not convs[0]["needs_dx"]
