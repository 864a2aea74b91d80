"""diamond_tpu_torch modules against their flax counterparts in diamond_tpu, with the same
weights (random, through the weight bridge) and the same numpy
inputs, float32 on the CPU.

Tolerances: the two frameworks sum convolutions, matmuls and norm moments in different
orders, so outputs differ by f32 rounding that grows with depth: 1e-4 (rtol and atol)
for single blocks, 5e-4 for whole networks. Denoised frames sit on the 256-level grid,
where a last-ulp difference can move a value across a floor; those are compared in grid
levels: at most one level apart, in at most 1% of the values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.models import blocks as jb
from diamond_tpu.models import (ActorCritic as JActorCritic, ActorCriticConfig as JACConfig,
                                Denoiser as JDenoiser, DenoiserConfig as JDenoiserConfig,
                                DiffusionSampler as JSampler,
                                DiffusionSamplerConfig as JSamplerConfig,
                                InnerModelConfig as JInnerConfig, RewEndModel as JRewEnd,
                                RewEndModelConfig as JRewEndConfig)
from diamond_tpu_torch.config import (ActorCriticConfig, DenoiserConfig, DiffusionSamplerConfig,
                                      InnerModelConfig, RewEndModelConfig)
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import blocks as tb
from diamond_tpu_torch.models import ActorCritic, Denoiser, DiffusionSampler, RewEndModel

from torch_port_util import close, jax_and_port, random_variables, t

N, S = 2, 8  # batch, spatial size


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("fuse_silu", [True, False])
def test_groupnorm(fuse_silu):
    (x,) = _inputs(0, (N, S, S, 64))
    v, m = jax_and_port(jb.GroupNorm(fuse_silu=fuse_silu), tb.GroupNorm(64, fuse_silu=fuse_silu),
                        0, jnp.asarray(x))
    close(m(t(x)), jb.GroupNorm(fuse_silu=fuse_silu).apply(v, x), 1e-4, 1e-4)


@pytest.mark.parametrize("fuse_silu", [True, False])
def test_ada_groupnorm(fuse_silu):
    x, cond = _inputs(1, (N, S, S, 64), (N, 16))
    j = jb.AdaGroupNorm(fuse_silu=fuse_silu)
    v, m = jax_and_port(j, tb.AdaGroupNorm(64, 16, fuse_silu=fuse_silu), 1, x, cond)
    close(m(t(x), t(cond)), j.apply(v, x, cond), 1e-4, 1e-4)


@pytest.mark.parametrize("strides,cin", [(1, 3), (1, 64), (2, 32)])
def test_conv3x3(strides, cin):
    (x,) = _inputs(2, (N, S, S, cin))
    j = jb.Conv3x3(16, jnp.float32, strides=strides)
    v, m = jax_and_port(j, tb.Conv3x3(cin, 16, strides=strides), 2, x)
    close(m(t(x)), j.apply(v, x), 1e-4, 1e-4)


def test_self_attention():
    (x,) = _inputs(3, (N, S, S, 32))
    j = jb.SelfAttention2d()
    v, m = jax_and_port(j, tb.SelfAttention2d(32), 3, x)
    close(m(t(x)), j.apply(v, x), 1e-4, 1e-4)


@pytest.mark.parametrize("cin,attn", [(32, True), (16, False)])
def test_resblock(cin, attn):
    x, cond = _inputs(4, (N, S, S, cin), (N, 16))
    j = jb.ResBlock(32, attn)
    v, m = jax_and_port(j, tb.ResBlock(cin, 32, 16, attn), 4, x, cond)
    close(m(t(x), t(cond)), j.apply(v, x, cond), 1e-4, 1e-4)


@pytest.mark.parametrize("cin", [32, 16])
def test_small_resblock(cin):
    (x,) = _inputs(5, (N, S, S, cin))
    j = jb.SmallResBlock(32)
    v, m = jax_and_port(j, tb.SmallResBlock(cin, 32), 5, x)
    close(m(t(x)), j.apply(v, x), 1e-4, 1e-4)


def test_unet():
    """Two levels with attention at the second, odd spatial size (pad/crop path)."""
    x, cond = _inputs(6, (N, 7, 7, 16), (N, 16))
    j = jb.UNet([1, 1], [16, 32], [0, 1])
    v, m = jax_and_port(j, tb.UNet(16, 16, [1, 1], [16, 32], [0, 1]), 6, x, cond)
    close(m(t(x), t(cond)), jax.jit(j.apply)(v, x, cond), 5e-4, 5e-4)


# ---------------------------------------------------------------------------
# The three models

IMG, C, NC, NA = 16, 3, 4, 3
INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
             channels=[32, 32], attn_depths=[0, 1], num_actions=NA)


@pytest.fixture(scope="module")
def denoisers():
    j = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**INNER), sigma_data=0.5,
                                  sigma_offset_noise=0.3))
    v = random_variables(j.init, img_size=IMG, seed=7)
    p = Denoiser(DenoiserConfig(inner_model=InnerModelConfig(**INNER), sigma_data=0.5,
                                sigma_offset_noise=0.3))
    load_variables(p.inner_model, v)
    return j, v, p


def _den_inputs(seed, b=N):
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(b, IMG, IMG, C)).astype(np.float32)
    obs = rng.uniform(-1, 1, (b, IMG, IMG, NC * C)).astype(np.float32)
    act = rng.integers(0, NA, (b, NC)).astype(np.int32)
    return noisy, obs, act


def _grid_levels(x):
    return np.round((np.asarray(x, np.float64) + 1) / 2 * 255)


def assert_frames_close(port, ref, max_share=0.01):
    """At most one grid level apart, in at most ``max_share`` of the values."""
    d = np.abs(_grid_levels(port) - _grid_levels(ref))
    assert d.max() <= 1 and (d > 0).mean() <= max_share, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("with_obs_features", [False, True])
def test_inner_model(denoisers, with_obs_features):
    j, v, p = denoisers
    noisy, obs, act = _den_inputs(9)
    c_noise = np.array([0.3, -0.4], np.float32)
    feats_j = feats_p = None
    if with_obs_features:
        feats_j = j.inner_model.apply(v, obs, method="compute_obs_features")
        feats_p = p.inner_model.compute_obs_features(t(obs))
        close(feats_p, feats_j, 1e-4, 1e-4)
    with torch.no_grad():
        y = p.inner_model(t(noisy), t(c_noise), t(obs), t(act), feats_p)
    close(y, jax.jit(j.inner_model.apply)(v, noisy, c_noise, obs, act, feats_j), 5e-4, 5e-4)


def test_denoise(denoisers):
    j, v, p = denoisers
    noisy, obs, act = _den_inputs(10)
    with torch.no_grad():
        y = p.denoise(t(noisy), 1.7, t(obs), t(act))
    assert_frames_close(y.numpy(), j.denoise(v, noisy, 1.7, obs, act))


@pytest.mark.parametrize("order,s_churn", [(1, 0.0), (2, 0.0), (1, 1.0)])
def test_sampler(denoisers, order, s_churn):
    """Euler, Heun and churn with injected draws: x_init, and the churn noise rebuilt from
    the JAX sampler's own key splits (diffusion_sampler.py:113-124)."""
    j, v, p = denoisers
    kw = dict(num_steps_denoising=3, order=order, s_churn=s_churn)
    js = JSampler(j, JSamplerConfig(**kw))
    ps = DiffusionSampler(p, DiffusionSamplerConfig(**kw))
    rng = np.random.default_rng(11)
    prev_obs = rng.uniform(-1, 1, (N, NC, IMG, IMG, C)).astype(np.float32)
    prev_act = rng.integers(0, NA, (N, NC)).astype(np.int32)
    x_init = rng.normal(size=(N, IMG, IMG, C)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    churn = []
    k, _ = jax.random.split(key)
    for _ in range(ps.num_churn_draws()):
        k, k_eps = jax.random.split(k)
        churn.append(t(jax.random.normal(k_eps, x_init.shape)))
    assert (len(churn) > 0) == (s_churn > 0)
    x_j, _ = js.sample(v, key, prev_obs, prev_act, x_init=jnp.asarray(x_init))
    with torch.no_grad():
        x_p = ps.sample(t(prev_obs), t(prev_act), x_init=t(x_init), churn_noise=churn)
    assert_frames_close(x_p.numpy(), x_j)


REW = dict(lstm_dim=32, img_channels=C, img_size=IMG, cond_channels=8, depths=[1, 1],
           channels=[32, 32], attn_depths=[0, 0], num_actions=NA)


def test_rew_end_predict_with_carry():
    j = JRewEnd(JRewEndConfig(**REW))
    v = random_variables(j.init, seed=13)
    p = RewEndModel(RewEndModelConfig(**REW))
    load_variables(p.net, v)
    rng = np.random.default_rng(15)
    obs = rng.uniform(-1, 1, (N, 3, IMG, IMG, C)).astype(np.float32)
    nxt = rng.uniform(-1, 1, (N, 3, IMG, IMG, C)).astype(np.float32)
    act = rng.integers(0, NA, (N, 3)).astype(np.int32)
    hx, cx = (rng.normal(size=(N, 32)).astype(np.float32) for _ in range(2))
    rj, ej, (hj, cj) = jax.jit(j.predict_rew_end)(v, obs, act, nxt, (hx, cx))
    with torch.no_grad():
        rp, ep, (hp, cp) = p.predict_rew_end(t(obs), t(act), t(nxt), (t(hx), t(cx)))
    for a, b in ((rp, rj), (ep, ej), (hp, hj), (cp, cj)):
        close(a, b, 5e-4, 5e-4)


AC = dict(lstm_dim=32, img_channels=C, img_size=IMG, channels=[16, 32], down=[1, 1],
          num_actions=NA)


def test_actor_critic_encode_and_head():
    j = JActorCritic(JACConfig(**AC))
    v = random_variables(j.init, seed=16)
    p = ActorCritic(ActorCriticConfig(**AC))
    load_variables(p.net, v)
    rng = np.random.default_rng(18)
    obs = rng.uniform(-1, 1, (N, IMG, IMG, C)).astype(np.float32)
    hx, cx = (rng.normal(size=(N, 32)).astype(np.float32) for _ in range(2))
    fj = jax.jit(j.encode)(v, obs)
    with torch.no_grad():
        fp = p.encode(t(obs))
        close(fp, fj, 1e-4, 1e-4)
        oj = jax.jit(j.head)(v, fj, (hx, cx))
        op = p.head(t(np.asarray(fj)), (t(hx), t(cx)))
    for a, b in ((op.logits_act, oj.logits_act), (op.val, oj.val),
                 (op.carry[0], oj.carry[0]), (op.carry[1], oj.carry[1])):
        close(a, b, 1e-4, 1e-4)
