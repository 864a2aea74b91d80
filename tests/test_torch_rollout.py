"""The slice as a whole: diamond_tpu_torch's imagination rollout against the real JAX
``ImaginationEngine.rollout`` at a tiny size (B=4, 4 steps, both ICPool.feats
branches), float32 on the CPU, same weights and same random draws.

The JAX rollout's draws are rebuilt from its own key splits (world_model_env.py:164,
262, 311; diffusion_sampler.py:113-115) and categorical(k, logits) is
argmax(logits + gumbel(k, logits.shape)), so the port gets them as ``RolloutDraws``.

What is compared and how closely:
  * actions, rewards, ends, truncations, deaths, pool pointer, episode lengths: exactly;
  * logits, values, LSTM states: rtol = atol = 1e-3 (f32 rounding through the U-Net,
    both encoders and the LSTMs, compounded over 4 steps);
  * frames: in uint8 grid levels, at most 1 level apart in at most 1% of the pixels (a
    last-ulp difference can move a value across the floor of quantize_to_uint8_grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import (ActorCritic as JActorCritic, ActorCriticConfig as JACConfig,
                                Denoiser as JDenoiser, DenoiserConfig as JDenoiserConfig,
                                DiffusionSamplerConfig as JSamplerConfig,
                                InnerModelConfig as JInnerConfig, RewEndModel as JRewEnd,
                                RewEndModelConfig as JRewEndConfig)
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine, RolloutDraws,
                                                    encode_pool_feats, make_ic_preparer)
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import ActorCritic, Denoiser, RewEndModel

from torch_port_util import close, random_variables, t

IMG, C, NC, NA, D = 16, 3, 4, 3, 32
B, T, HORIZON, POOL = 4, 4, 3, 16
INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
             channels=[32, 32], attn_depths=[0, 0], num_actions=NA)
REW = dict(lstm_dim=D, img_channels=C, img_size=IMG, cond_channels=8, depths=[1, 1],
           channels=[32, 32], attn_depths=[0, 0], num_actions=NA)
AC = dict(lstm_dim=D, img_channels=C, img_size=IMG, channels=[16, 32], down=[1, 1],
          num_actions=NA)
SAMPLER = dict(num_steps_denoising=3)


@pytest.fixture(scope="module")
def engines():
    jd = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**INNER), sigma_data=0.5,
                                   sigma_offset_noise=0.3))
    jr, ja = JRewEnd(JRewEndConfig(**REW)), JActorCritic(JACConfig(**AC))
    d_vars = random_variables(jd.init, img_size=IMG, seed=1)
    r_vars = random_variables(jr.init, seed=2)
    ac_vars = random_variables(ja.init, seed=3)
    j_engine = jwm.ImaginationEngine(jd, jr, ja, jwm.WorldModelEnvConfig(
        horizon=HORIZON, num_batches_to_preload=1,
        diffusion_sampler=JSamplerConfig(**SAMPLER)))

    pd = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**INNER)))
    pr, pa = RewEndModel(tc.RewEndModelConfig(**REW)), ActorCritic(tc.ActorCriticConfig(**AC))
    load_variables(pd.inner_model, d_vars)
    load_variables(pr.net, r_vars)
    load_variables(pa.net, ac_vars)
    p_engine = ImaginationEngine(pd, pr, pa, tc.WorldModelEnvConfig(
        horizon=HORIZON, diffusion_sampler=tc.DiffusionSamplerConfig(**SAMPLER)))

    rng = np.random.default_rng(4)
    obs_u8 = rng.integers(0, 256, (POOL, NC, IMG, IMG, C), dtype=np.uint8)
    act = rng.integers(0, NA, (POOL, NC)).astype(np.int32)
    hx_j, cx_j = jwm.make_ic_preparer(jr, chunk=8)(r_vars, jnp.asarray(obs_u8),
                                                    jnp.asarray(act))
    hx_p, cx_p = make_ic_preparer(pr, chunk=8)(t(obs_u8), t(act))
    return dict(j=j_engine, p=p_engine, vars=(ac_vars, d_vars, r_vars), obs=obs_u8, act=act,
                hx_j=hx_j, cx_j=cx_j, hx_p=hx_p, cx_p=cx_p)


def test_ic_burn_in(engines):
    e = engines
    close(e["hx_p"], e["hx_j"], 1e-3, 1e-3)
    close(e["cx_p"], e["cx_j"], 1e-3, 1e-3)


def jax_draws(key, num_steps):
    """The JAX rollout's random numbers, rebuilt from its key splits."""
    x_init, g_act, g_rew, g_end = [], [], [], []
    for step_rng in jax.random.split(key, num_steps):
        k_act, k_wm = jax.random.split(step_rng)
        k_sample, k_rew, k_end = jax.random.split(k_wm, 3)
        _, rng_init = jax.random.split(k_sample)
        x_init.append(jax.random.normal(rng_init, (B, IMG, IMG, C)))
        g_act.append(jax.random.gumbel(k_act, (B, NA), jnp.float32))
        g_rew.append(jax.random.gumbel(k_rew, (B, 3), jnp.float32))
        g_end.append(jax.random.gumbel(k_end, (B, 2), jnp.float32))
    return RolloutDraws(*(t(np.stack(z)) for z in (x_init, g_act, g_rew, g_end)))


def _levels(u8):
    return np.asarray(u8).astype(np.int64)


@pytest.mark.parametrize("pool_feats", [False, True])
def test_rollout_matches_jax(engines, pool_feats):
    e = engines
    ac_vars, d_vars, r_vars = e["vars"]
    j_pool = jwm.ICPool(obs=jnp.asarray(e["obs"]), act=jnp.asarray(e["act"]), hx=e["hx_j"],
                        cx=e["cx_j"], ptr=jnp.asarray(0, jnp.int32))
    p_pool = ICPool(obs=t(e["obs"]), act=t(e["act"]), hx=e["hx_p"], cx=e["cx_p"],
                    ptr=torch.tensor(0))
    if pool_feats:
        feats_j = jwm.encode_pool_feats(e["j"].actor_critic, ac_vars, j_pool.obs)
        feats_p = encode_pool_feats(e["p"].actor_critic, p_pool.obs)
        close(feats_p, feats_j, 1e-4, 1e-4)
        j_pool = j_pool.replace(feats=feats_j)
        p_pool.feats = feats_p

    st_j, j_pool = e["j"].initial_state(j_pool, B)
    st_p, p_pool = e["p"].initial_state(p_pool, B)
    key = jax.random.PRNGKey(5)
    traj_j, st_j, j_pool = jax.jit(e["j"].rollout, static_argnums=(6,))(
        ac_vars, d_vars, r_vars, st_j, j_pool, key, T)
    traj_p, st_p, p_pool = e["p"].rollout(st_p, p_pool, T, draws=jax_draws(key, T))

    dead = np.asarray(traj_j["dead"])
    assert 0 < dead.sum() < dead.size, "resets and survivors must both occur"
    for k in ("act", "rew", "end", "trunc", "dead"):
        np.testing.assert_array_equal(traj_p[k].numpy(), np.asarray(traj_j[k]), err_msg=k)
    for k in ("logits_act", "val", "val_final", "val_bootstrap"):
        close(traj_p[k], traj_j[k], 1e-3, 1e-3)
    assert int(p_pool.ptr) == int(j_pool.ptr) == B + dead.sum()
    np.testing.assert_array_equal(st_p.ep_len.numpy(), np.asarray(st_j.ep_len))
    np.testing.assert_array_equal(st_p.act_buffer.numpy(), np.asarray(st_j.act_buffer))
    for a, b in ((st_p.re_hx, st_j.re_hx), (st_p.re_cx, st_j.re_cx), (st_p.ac_hx, st_j.ac_hx),
                 (st_p.ac_cx, st_j.ac_cx)):
        close(a, b, 1e-3, 1e-3)
    assert st_p.obs_buffer.dtype == torch.uint8
    d = np.abs(_levels(st_p.obs_buffer) - _levels(st_j.obs_buffer))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())


def test_wm_transition_matches_jax(engines):
    """One world-model step, frame by frame: the sampled next frame in grid levels, the
    reward/end draws exactly, horizon truncation."""
    e = engines
    ac_vars, d_vars, r_vars = e["vars"]
    idx = np.arange(B)
    st_j = jwm.ImagState(obs_buffer=jnp.asarray(e["obs"][idx]),
                         act_buffer=jnp.asarray(e["act"][idx]), re_hx=e["hx_j"][idx],
                         re_cx=e["cx_j"][idx], ac_hx=jnp.zeros((B, D)), ac_cx=jnp.zeros((B, D)),
                         ep_len=jnp.asarray([HORIZON - 1, 0, 1, HORIZON - 1], jnp.int32))
    st_p, _ = e["p"].initial_state(ICPool(obs=t(e["obs"]), act=t(e["act"]), hx=e["hx_p"],
                                          cx=e["cx_p"], ptr=torch.tensor(0)), B)
    st_p.ep_len = t(np.asarray(st_j.ep_len))
    act = np.array([0, 1, 2, 1], np.int32)
    key = jax.random.PRNGKey(6)
    _, n_j, rew_j, end_j, trunc_j = jax.jit(e["j"]._wm_transition)(
        d_vars, r_vars, st_j, jnp.asarray(act), key)
    k_sample, k_rew, k_end = jax.random.split(key, 3)
    x_init = t(jax.random.normal(jax.random.split(k_sample)[1], (B, IMG, IMG, C)))
    st2, n_p, rew_p, end_p, trunc_p = e["p"]._wm_transition(
        st_p, t(act), x_init, t(jax.random.gumbel(k_rew, (B, 3), jnp.float32)),
        t(jax.random.gumbel(k_end, (B, 2), jnp.float32)))
    d = np.abs(np.round((n_p.numpy() + 1) * 127.5) - np.round((np.asarray(n_j) + 1) * 127.5))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    np.testing.assert_array_equal(rew_p.numpy(), np.asarray(rew_j))
    np.testing.assert_array_equal(end_p.numpy(), np.asarray(end_j))
    np.testing.assert_array_equal(trunc_p.numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(trunc_p.numpy(), np.asarray(trunc_j))
    assert st2.obs_buffer.dtype == torch.uint8 and st2.obs_buffer.shape == (B, NC, IMG, IMG, C)
