"""The two-stage (csgo) world model of diamond_tpu_torch against the JAX package, on the
CPU in float32 at a tiny size: factor 2, full-resolution frames 16x16, low-res 8x8; the
dynamics denoiser and the upsampler channels [8, 8], depths [1, 1], cond 16 (the mid
blocks' attention included); the rew/end model channels [8, 8] at 8x8. The same weights
go through the weight bridge, and the JAX draws are rebuilt from its key splits and
injected into the port.

  * ``downsample_avg``, ``upsample_frame`` (bilinear, half-pixel centres, a 16 -> 64
    upsample at factor 4 too) and ``_two_stage_obs``;
  * the upsampler's InnerModel forward, fused and with the split conv_in;
  * ``TwoStageSampler`` against JAX's ``low_sampler.sample`` and ``up_sampler.sample``
    with x_init, and ``return_trajectory``;
  * the stateful env (envs/wm_env_stateful.py) step by step, with deaths and refills,
    against JAX's ``engine._wm_transition`` composed with ``up_sampler.sample`` and the
    JAX env's own IC downsample, on the same draws; the dataset IC provider;
  * a tiny wm_only trainer run on a static dataset: its snapshot loads in both packages
    and its resume equals the saved state.
The upsampler's loss and the train steps are in tests/test_torch_two_stage_training.py.

Tolerances, each with its reason:
  * the area downsample and ``_two_stage_obs``: exactly against the JAX functions run op
    by op (the port sums a window in the order XLA's mean does on the CPU; a last-ulp
    difference would flip the floor onto the grid, where the mean of grid values often
    lies exactly on a level). Under jit XLA's fusion reorders that arithmetic and the
    JAX package disagrees with itself by one level in most pixels (its jitted train
    steps against its eager env): held here at one level. So the JAX IC provider runs
    under ``jax.disable_jit()``, op by op, as the JAX env's own resolution change runs.
    The bilinear upsample 1e-6 absolute (interpolation weights in another order);
  * forward outputs and sampled latents: rtol = atol = 1e-4 (f32 through the U-Net in
    other orders);
  * sampled frames: in uint8 grid levels, at most one level apart (the floor onto the
    grid can flip on a last ulp);
  * the env: actions, rewards, ends and truncations exactly, frames within one level;
  * snapshots and resume: exactly.
"""

import copy
import glob
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diamond_tpu.config import load_config as j_load_config
from diamond_tpu.data import Dataset as JDataset, Episode as JEpisode
from diamond_tpu.data import SegmentId as JSegmentId
from diamond_tpu.envs import wm_env_stateful as jws
from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import (Agent as JAgent, AgentConfig as JAgentConfig,
                                Denoiser as JDenoiser, DenoiserConfig as JDenoiserConfig,
                                DiffusionSampler as JSampler,
                                DiffusionSamplerConfig as JSamplerConfig,
                                InnerModelConfig as JInnerConfig, RewEndModel as JRewEnd,
                                RewEndModelConfig as JRewEndConfig,
                                SigmaDistributionConfig as JSigmaConfig,
                                TwoStageSampler as JTwoStageSampler)
from diamond_tpu.models import denoiser as jden
from diamond_tpu.training import _two_stage_obs as j_two_stage_obs
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.config import load_config
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.episode import obs_to_float
from diamond_tpu_torch.data.segment import SegmentId
from diamond_tpu_torch.envs.wm_env_stateful import (StepDraws, WorldModelEnv,
                                                    make_dataset_ic_provider, to_low_res)
from diamond_tpu_torch.envs.world_model_env import ImaginationEngine
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import (Agent, Denoiser, DiffusionSampler, RewEndModel,
                                      TwoStageSampler, downsample_avg, upsample_frame)
from diamond_tpu_torch.trainer import Trainer
from diamond_tpu_torch.training import _two_stage_obs
from diamond_tpu_torch.utils import get_path_agent_ckpt

from test_torch_denoiser_training import _grid_levels
from test_torch_trainer import states_equal
from torch_port_util import close, random_variables, t

F_UP, HIGH, LOW, C, NC, NA, D = 2, 16, 8, 3, 2, 3, 16
LOW_INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
                 channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
UP_INNER = dict(img_channels=C, num_steps_conditioning=1, cond_channels=16, depths=[1, 1],
                channels=[8, 8], attn_depths=[0, 0])
REW = dict(lstm_dim=D, img_channels=C, img_size=LOW, cond_channels=8, depths=[1, 1],
           channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
SAMPLER = dict(num_steps_denoising=3)
SIGMA = tc.SigmaDistributionConfig()
J_SIGMA = JSigmaConfig(**asdict(SIGMA))


@pytest.fixture(scope="module")
def models():
    jd = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**LOW_INNER), sigma_data=0.5,
                                   sigma_offset_noise=0.3))
    ju = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**UP_INNER), sigma_data=0.5,
                                   sigma_offset_noise=0.3, upsampling_factor=F_UP))
    jr = JRewEnd(JRewEndConfig(**REW))
    d_vars = random_variables(jd.init, img_size=LOW, seed=1)
    u_vars = random_variables(ju.init, img_size=HIGH, seed=2)
    r_vars = random_variables(jr.init, seed=3)
    pd = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**LOW_INNER)))
    pu = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**UP_INNER),
                                    upsampling_factor=F_UP))
    pr = RewEndModel(tc.RewEndModelConfig(**REW))
    return dict(jd=jd, ju=ju, jr=jr, d_vars=d_vars, u_vars=u_vars, r_vars=r_vars, pd=pd, pu=pu,
                pr=pr)


@pytest.fixture
def fresh(models):
    """The models with the port's starting weights restored (a step updates them)."""
    m = models
    load_variables(m["pd"].inner_model, m["d_vars"])
    load_variables(m["pu"].inner_model, m["u_vars"])
    load_variables(m["pr"].net, m["r_vars"])
    return m


def frames_close(port, jax_out, levels=1):
    d = np.abs(_grid_levels(port.detach().numpy() if isinstance(port, torch.Tensor) else port)
               - _grid_levels(jax_out))
    assert d.max() <= levels, d.max()


def u8_close(port_u8, jax_u8, levels=1):
    d = np.abs(np.asarray(port_u8, np.int32) - np.asarray(jax_u8, np.int32))
    assert d.max() <= levels, d.max()


# ---------------------------------------------------------------------------
# Resolution changes


def test_resolution_changes_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 3, HIGH, HIGH, C)).astype(np.float32)
    for f in (2, 4):
        np.testing.assert_array_equal(downsample_avg(t(x), f).numpy(),
                                      np.asarray(jden.downsample_avg(jnp.asarray(x), f)))
    assert downsample_avg(t(x), 1) is not None and torch.equal(downsample_avg(t(x), 1), t(x))
    low = rng.uniform(-1, 1, (2, 3, LOW, LOW, C)).astype(np.float32)
    close(upsample_frame(t(low), F_UP), jden.upsample_frame(jnp.asarray(low), F_UP), 0, 1e-6)
    # 16 -> 64 at factor 4, the full-size upsampler's: bilinear with half-pixel centres;
    # align_corners=True or a nearest resize is far from it
    big = rng.uniform(-1, 1, (2, 16, 16, C)).astype(np.float32)
    ref = np.asarray(jden.upsample_frame(jnp.asarray(big), 4))
    close(upsample_frame(t(big), 4), ref, 0, 1e-6)
    nchw = t(big).permute(0, 3, 1, 2)
    for wrong in (F.interpolate(nchw, scale_factor=4, mode="bilinear", align_corners=True),
                  F.interpolate(nchw, scale_factor=4, mode="nearest")):
        assert np.abs(wrong.permute(0, 2, 3, 1).numpy() - ref).max() > 1e-2
    with pytest.raises(ValueError):
        downsample_avg(t(x[..., :HIGH - 1, :, :]), F_UP)


def test_two_stage_obs_matches_jax():
    obs_u8 = np.random.default_rng(6).integers(0, 256, (2, 4, HIGH, HIGH, C), dtype=np.uint8)
    got = _two_stage_obs(t(obs_u8), F_UP)
    want = np.asarray(j_two_stage_obs(jnp.asarray(obs_u8), F_UP))
    assert got.shape == (2, 4, LOW, LOW, C)
    np.testing.assert_array_equal(got.numpy(), want)
    jitted = np.asarray(jax.jit(j_two_stage_obs, static_argnums=1)(jnp.asarray(obs_u8), F_UP))
    d = np.abs(_grid_levels(got.numpy()) - _grid_levels(jitted))
    assert d.max() <= 1, d.max()
    assert torch.equal(_two_stage_obs(t(obs_u8), 1), obs_to_float(t(obs_u8)))
    assert torch.equal(to_low_res(t(obs_u8), F_UP),
                       torch.round((got + 1) * 127.5).to(torch.uint8))


# ---------------------------------------------------------------------------
# The upsampler


def test_upsampler_inner_model_matches_jax(fresh):
    m = fresh
    ju, u_vars, pu = m["ju"], m["u_vars"], m["pu"]
    assert not hasattr(pu.inner_model, "act_emb")
    assert not any("act_emb" in k for k in pu.inner_model.state_dict())
    assert pu.inner_model.conv_in.kernel.shape[2] == 2 * C
    rng = np.random.default_rng(7)
    noisy = rng.normal(size=(2, HIGH, HIGH, C)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, HIGH, HIGH, C)).astype(np.float32)
    sigma = np.float32(0.8)
    want = ju.denoise(u_vars, jnp.asarray(noisy), sigma, jnp.asarray(cond), None)
    with torch.no_grad():
        got = pu.denoise(t(noisy), float(sigma), t(cond), None)
        feats = pu.compute_obs_features(t(cond))
        split = pu.denoise(t(noisy), float(sigma), t(cond), None, feats)
    close(got, want, 1e-4, 1e-4)
    close(split, want, 1e-4, 1e-4)
    feats_j = ju.compute_obs_features(u_vars, jnp.asarray(cond))
    close(feats, feats_j, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# Sampling


def test_two_stage_sampler_matches_jax(fresh):
    m = fresh
    scfg, jscfg = tc.DiffusionSamplerConfig(**SAMPLER), JSamplerConfig(**SAMPLER)
    j_cascade = JTwoStageSampler(JSampler(m["jd"], jscfg), m["ju"], jscfg)
    p_cascade = TwoStageSampler(DiffusionSampler(m["pd"], scfg), m["pu"], scfg)
    assert p_cascade.factor == j_cascade.factor == F_UP
    rng = np.random.default_rng(10)
    prev = rng.integers(0, 256, (2, NC, LOW, LOW, C), dtype=np.uint8)
    prev_f = np.asarray(prev, np.float32) / 255.0 * 2.0 - 1.0
    act = rng.integers(0, NA, (2, NC)).astype(np.int32)
    x_low = rng.normal(size=(2, LOW, LOW, C)).astype(np.float32)
    x_high = rng.normal(size=(2, HIGH, HIGH, C)).astype(np.float32)
    key = jax.random.PRNGKey(0)  # unused: x_init is given and Euler draws no churn
    low_j, _ = j_cascade.low_sampler.sample(m["d_vars"], key, jnp.asarray(prev_f), act,
                                             x_init=jnp.asarray(x_low))
    cond_j = jden.upsample_frame(low_j, F_UP)
    high_j, _ = j_cascade.up_sampler.sample(m["u_vars"], key, cond_j[:, None], None,
                                            x_init=jnp.asarray(x_high))
    with torch.no_grad():
        low, high = p_cascade.sample(t(prev_f), t(act), x_init_low=t(x_low),
                                     x_init_high=t(x_high))
    assert low.shape == (2, LOW, LOW, C) and high.shape == (2, HIGH, HIGH, C)
    frames_close(low, low_j)
    frames_close(high, high_j)
    with pytest.raises(ValueError, match="upsampler"):
        TwoStageSampler(DiffusionSampler(m["pd"], scfg), m["pd"], scfg)


def test_return_trajectory_matches_jax(fresh):
    m = fresh
    rng = np.random.default_rng(11)
    prev_f = rng.uniform(-1, 1, (2, NC, LOW, LOW, C)).astype(np.float32)
    act = rng.integers(0, NA, (2, NC)).astype(np.int32)
    x0 = rng.normal(size=(2, LOW, LOW, C)).astype(np.float32)
    _, traj_j = JSampler(m["jd"], JSamplerConfig(**SAMPLER)).sample(
        m["d_vars"], jax.random.PRNGKey(0), jnp.asarray(prev_f), act, return_trajectory=True,
        x_init=jnp.asarray(x0))
    sampler = DiffusionSampler(m["pd"], tc.DiffusionSamplerConfig(**SAMPLER))
    with torch.no_grad():
        x, traj = sampler.sample(t(prev_f), t(act), x_init=t(x0), return_trajectory=True)
        plain = sampler.sample(t(prev_f), t(act), x_init=t(x0))
    assert len(traj) == len(traj_j) == SAMPLER["num_steps_denoising"] + 1
    assert torch.equal(traj[0], t(x0)) and torch.equal(traj[-1], x) and torch.equal(x, plain)
    for a, b in zip(traj, traj_j):
        close(a, b, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# The stateful env


B_ENV, HORIZON, STEPS = 2, 3, 7


def ic_stream(seed, n):
    """n initial conditions at full resolution, handed out in order by ``take``."""
    rng = np.random.default_rng(seed)
    ics = (rng.integers(0, 256, (n, NC, HIGH, HIGH, C), dtype=np.uint8),
           rng.integers(0, NA, (n, NC)).astype(np.int32),
           (0.1 * rng.normal(size=(n, D))).astype(np.float32),
           (0.1 * rng.normal(size=(n, D))).astype(np.float32))
    pos = [0]

    def take(k):
        out = tuple(a[pos[0]:pos[0] + k] for a in ics)
        pos[0] += k
        return out

    return take


def test_stateful_env_matches_jax_composition(fresh):
    """The port's WorldModelEnv (two-stage, B = 2, horizon 3) over 7 steps against the JAX
    package's own pieces on the same draws: ``_wm_transition`` (the JAX key's splits give
    the port's latent and Gumbel noise), ``up_sampler.sample`` with the same upsampler
    latent, and on death the JAX env's ``_ics_to_buffer`` of the same fresh ICs."""
    m = fresh
    scfg, jscfg = tc.DiffusionSamplerConfig(**SAMPLER), JSamplerConfig(**SAMPLER)
    j_engine = jwm.ImaginationEngine(m["jd"], m["jr"], None, jwm.WorldModelEnvConfig(
        horizon=HORIZON, num_batches_to_preload=1, diffusion_sampler=jscfg))
    j_take = ic_stream(12, 64)
    j_env = jws.WorldModelEnv(j_engine, lambda: m["d_vars"], lambda: m["r_vars"], j_take,
                              B_ENV, upsampler=m["ju"], u_vars_getter=lambda: m["u_vars"])
    j_up = JSampler(m["ju"], jscfg)
    p_engine = ImaginationEngine(m["pd"], m["pr"], None, tc.WorldModelEnvConfig(
        horizon=HORIZON, diffusion_sampler=scfg))
    env = WorldModelEnv(p_engine, ic_stream(12, 64), B_ENV, upsampler=m["pu"])

    obs, info = env.reset()
    obs_j, act_j, hx_j, cx_j = j_take(B_ENV)
    np.testing.assert_array_equal(obs, obs_j[:, -1])  # the full-res originals
    st = jwm.ImagState(obs_buffer=j_env._ics_to_buffer(jnp.asarray(obs_j)),
                       act_buffer=jnp.asarray(act_j), re_hx=jnp.asarray(hx_j),
                       re_cx=jnp.asarray(cx_j), ac_hx=jnp.zeros((B_ENV, D)),
                       ac_cx=jnp.zeros((B_ENV, D)), ep_len=jnp.zeros((B_ENV,), jnp.int32))
    u8_close(env._st.obs_buffer.numpy(), st.obs_buffer, 0)
    rng = np.random.default_rng(13)
    display = obs_j[:, -1].copy()
    deaths = 0
    for i in range(STEPS):
        act = rng.integers(0, NA, B_ENV).astype(np.int32)
        key = jax.random.PRNGKey(100 + i)
        x_high = rng.normal(size=(B_ENV, HIGH, HIGH, C)).astype(np.float32)
        st, next_obs, rew, end, trunc = j_engine._wm_transition(
            m["d_vars"], m["r_vars"], st, jnp.asarray(act), key)
        high, _ = j_up.sample(m["u_vars"], jax.random.PRNGKey(0),
                              jden.upsample_frame(next_obs, F_UP)[:, None], None,
                              x_init=jnp.asarray(x_high))
        # the port's draws from the JAX transition's key splits
        k_sample, k_rew, k_end = jax.random.split(key, 3)
        k_init = jax.random.split(k_sample)[1]
        draws = StepDraws(t(np.asarray(jax.random.normal(k_init, (B_ENV, LOW, LOW, C)))),
                          t(np.asarray(jax.random.gumbel(k_rew, (B_ENV, 3)))),
                          t(np.asarray(jax.random.gumbel(k_end, (B_ENV, 2)))), t(x_high))
        p_obs, p_rew, p_end, p_trunc, p_info = env.step(act, draws)

        rew, end, trunc = np.asarray(rew), np.asarray(end).astype(bool), \
            np.asarray(trunc).astype(bool)
        np.testing.assert_array_equal(p_rew, rew)
        np.testing.assert_array_equal(p_end, end)
        np.testing.assert_array_equal(p_trunc, trunc)
        high_u8 = np.round((np.clip(np.asarray(high), -1, 1) + 1) / 2 * 255).astype(np.uint8)
        low_u8 = np.round((np.clip(np.asarray(next_obs), -1, 1) + 1) / 2 * 255).astype(np.uint8)
        u8_close(p_info["low_res_obs"], low_u8)
        display = high_u8.copy()
        dead = end | trunc
        if dead.any():
            deaths += int(dead.sum())
            u8_close(p_info["final_observation"], high_u8[dead])
            obs_ic, act_ic, hx_ic, cx_ic = j_take(int(dead.sum()))
            idx = jnp.asarray(np.nonzero(dead)[0])
            st = st.replace(
                obs_buffer=st.obs_buffer.at[idx].set(j_env._ics_to_buffer(jnp.asarray(obs_ic))),
                act_buffer=st.act_buffer.at[idx].set(jnp.asarray(act_ic)),
                re_hx=st.re_hx.at[idx].set(jnp.asarray(hx_ic)),
                re_cx=st.re_cx.at[idx].set(jnp.asarray(cx_ic)),
                ep_len=st.ep_len.at[idx].set(0))
            u8_close(p_info["burnin_obs"], np.asarray(st.obs_buffer)[dead][:, :-1])
            display[dead] = obs_ic[:, -1]
        else:
            assert "final_observation" not in p_info
        u8_close(p_obs, display)
        assert p_obs.dtype == np.uint8 and p_obs.shape == (B_ENV, HIGH, HIGH, C)
        np.testing.assert_array_equal(env._st.act_buffer.numpy(), np.asarray(st.act_buffer))
        np.testing.assert_array_equal(env._st.ep_len.numpy(), np.asarray(st.ep_len))
        close(env._st.re_hx, st.re_hx, 1e-4, 1e-4)
        u8_close(env._st.obs_buffer.numpy(), st.obs_buffer)
    assert deaths >= 2 * B_ENV  # the horizon truncates every env twice


def test_env_trajectory_and_single_stage(fresh):
    """``denoising_trajectory``: the sampler's latents of the step, the last one the
    low-res frame; without an upsampler the env shows the low-res frames."""
    m = fresh
    scfg = tc.DiffusionSamplerConfig(**SAMPLER)
    p_engine = ImaginationEngine(m["pd"], m["pr"], None, tc.WorldModelEnvConfig(
        horizon=HORIZON, diffusion_sampler=scfg))

    def low_ics(k, take=ic_stream(14, 32)):
        obs, *rest = take(k)
        return (to_low_res(t(obs), F_UP).numpy(), *rest)

    env = WorldModelEnv(p_engine, low_ics, B_ENV, seed=3, return_denoising_trajectory=True)
    obs, _ = env.reset()
    assert obs.shape == (B_ENV, LOW, LOW, C)
    died = np.zeros(B_ENV, bool)
    for i in range(HORIZON):
        buf = env._st.obs_buffer.clone()
        obs, rew, end, trunc, info = env.step(np.full(B_ENV, i % NA))
        died |= end | trunc
        traj = info["denoising_trajectory"]
        assert traj.shape == (B_ENV, SAMPLER["num_steps_denoising"] + 1, LOW, LOW, C)
        assert "low_res_obs" not in info
        last = np.round((np.clip(traj[:, -1], -1, 1) + 1) / 2 * 255).astype(np.uint8)
        alive = ~(end | trunc)
        np.testing.assert_array_equal(obs[alive], last[alive])
        if not alive.all():
            np.testing.assert_array_equal(info["final_observation"], last[~alive])
    assert died.all() and not torch.equal(buf, env._st.obs_buffer)
    # the env's generator: the same seed (and ICs) gives the same steps
    fixed = low_ics(B_ENV)
    env = WorldModelEnv(p_engine, lambda k: tuple(a[:k] for a in fixed), B_ENV)
    outs = []
    for _ in range(2):
        env.reset(seed=5)
        outs.append(env.step([0, 1]))
    for a, b in zip(outs[0][:4], outs[1][:4]):
        np.testing.assert_array_equal(a, b)


def test_dataset_ic_provider_matches_jax(fresh, tmp_path):
    """Segments of a dataset written by the JAX package: the full-res frames as they
    are, the rew/end LSTM burned in over their low-res rendition, as the JAX provider."""
    m = fresh
    rng = np.random.default_rng(15)
    ds = JDataset(tmp_path / "train", "train_dataset")
    for _ in range(2):
        n = 10
        ds.add_episode(JEpisode(obs=rng.integers(0, 256, (n, HIGH, HIGH, C), dtype=np.uint8),
                                act=rng.integers(0, NA, n).astype(np.int32),
                                rew=np.zeros(n, np.float32), end=np.zeros(n, np.uint8),
                                trunc=np.zeros(n, np.uint8), info={}))
    ds.save_to_default_path()
    pds = Dataset(tmp_path / "train", "train_dataset")
    pds.load_from_default_path()
    spans = [(0, 0, NC), (1, 3, 3 + NC), (0, 5, 5 + NC)]

    class Fixed:
        def __init__(self, cls):
            self.ids = [cls(*s) for s in spans]

        def sample(self):
            return self.ids

    j_prov = jws.make_dataset_ic_provider(ds, Fixed(JSegmentId), m["jr"], lambda: m["r_vars"],
                                          downsample_factor=F_UP)
    p_prov = make_dataset_ic_provider(pds, Fixed(SegmentId), m["pr"], downsample_factor=F_UP)
    with jax.disable_jit():
        want = j_prov(3)
    got = p_prov(3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (3, NC, HIGH, HIGH, C)
    np.testing.assert_array_equal(got[1], want[1])
    close(torch.from_numpy(got[2]), want[2], 1e-4, 1e-4)
    close(torch.from_numpy(got[3]), want[3], 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# Agent snapshots and the wm_only trainer

TRAINER_OVERRIDES = [
    "agent=csgo", "env=fake", f"env.train.size={HIGH}", "common.seed=3",
    "tpu.compute_dtype=float32", "training.wm_only=True", "training.num_final_epochs=2",
    "evaluation.every=1", f"agent.upsampler.upsampling_factor={F_UP}",
    "agent.upsampler.inner_model.cond_channels=16", "agent.upsampler.inner_model.depths=[1]",
    "agent.upsampler.inner_model.channels=[8]", "agent.upsampler.inner_model.attn_depths=[0]",
    "agent.denoiser.inner_model.cond_channels=16", "agent.denoiser.inner_model.depths=[1,1]",
    "agent.denoiser.inner_model.channels=[8,8]", "agent.denoiser.inner_model.attn_depths=[0,0]",
    "agent.rew_end_model.lstm_dim=32", "agent.rew_end_model.cond_channels=8",
    "agent.rew_end_model.depths=[1,1]", "agent.rew_end_model.channels=[8,8]",
    "agent.rew_end_model.attn_depths=[0,0]", "agent.actor_critic.lstm_dim=32",
    "agent.actor_critic.channels=[8,8]", "agent.actor_critic.down=[1,1]",
    "denoiser.training.steps_first_epoch=2", "denoiser.training.steps_per_epoch=2",
    "denoiser.training.batch_size=4", "denoiser.training.lr_warmup_steps=2",
    "upsampler.training.steps_first_epoch=2", "upsampler.training.steps_per_epoch=2",
    "upsampler.training.batch_size=2", "upsampler.training.seq_length=2",
    "upsampler.training.lr_warmup_steps=2",
]


def write_static_dataset(root):
    """A static dataset written by the JAX package (tests/test_upsampler.py's)."""
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        ds = JDataset(root / split, f"{split}_dataset")
        for _ in range(4):
            n = 24
            end = np.zeros(n, np.uint8)
            end[-1] = 1
            ds.add_episode(JEpisode(
                obs=rng.integers(0, 255, (n, HIGH, HIGH, C), dtype=np.uint8),
                act=rng.integers(0, 3, n).astype(np.int32),
                rew=rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
                end=end, trunc=np.zeros(n, np.uint8),
                info={"final_observation": rng.integers(0, 255, (HIGH, HIGH, C),
                                                        dtype=np.uint8)}))
        ds.save_to_default_path()


@pytest.fixture(scope="module")
def wm_only_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_stage")
    write_static_dataset(root / "static")
    overrides = TRAINER_OVERRIDES + [f"static_dataset.path={root / 'static'}"]
    run_dir = root / "run"
    run_dir.mkdir()
    trainer = Trainer(load_config(overrides), run_dir, run_dir=run_dir, device="cpu")
    saved = []
    save = trainer.save_checkpoint

    def save_and_keep():
        save()
        saved.append(copy.deepcopy(trainer.state_dict()))
    trainer.save_checkpoint = save_and_keep
    trainer.run()
    return trainer, run_dir, overrides, saved


def test_wm_only_trainer_runs_on_a_static_dataset(wm_only_run):
    trainer, run_dir, _, _ = wm_only_run
    assert trainer.epoch == 2 and trainer._ds_factor == F_UP
    assert trainer.model_names == ("denoiser", "rew_end_model", "actor_critic", "upsampler")
    lines = (run_dir / "metrics.jsonl").read_text()
    for k in ("upsampler/train/loss_denoising", "denoiser/train/loss_denoising",
              "upsampler/test/loss_denoising", "denoiser/test/loss_denoising"):
        assert k in lines, k
    assert "rew_end_model/" not in lines and "actor_critic/" not in lines
    assert trainer.train_states["upsampler"].step == 4
    assert trainer.train_states["denoiser"].step == 4
    assert trainer.train_states["rew_end_model"].step == 0
    assert not trainer.calibrations  # int8 is calibrated for imagination only


def test_wm_only_snapshot_loads_in_both_packages(wm_only_run, tmp_path):
    trainer, run_dir, overrides, _ = wm_only_run
    snaps = sorted(glob.glob(str(run_dir / "checkpoints" / "agent_versions" / "*.npz")))
    z = np.load(snaps[-1])
    assert any(k.startswith("upsampler/params/") for k in z.files)
    assert not any("act_emb" in k for k in z.files if k.startswith("upsampler/"))
    # the JAX package reads the port's snapshot
    jcfg = j_load_config("trainer", overrides=overrides)
    ja = JAgent(JAgentConfig.from_cfg(jcfg.agent, trainer.agent.cfg.num_actions))
    ja.load(get_path_agent_ckpt(run_dir / "checkpoints", -1))
    sd = trainer.agent.state_dict()
    assert set(ja.variables) == set(sd) == set(trainer.model_names)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, ja.variables), sd)
    # the port reads the JAX package's (the upsampler's weights doubled)
    ja.variables["upsampler"] = jax.tree_util.tree_map(lambda x: np.asarray(x) * 2,
                                                       ja.variables["upsampler"])
    ja.save(tmp_path / "jax.npz")
    pb = Agent(trainer.agent.cfg, device="cpu")
    pb.load(tmp_path / "jax.npz")
    jax.tree_util.tree_map(np.testing.assert_array_equal, pb.state_dict()["upsampler"],
                           jax.tree_util.tree_map(np.asarray, ja.variables["upsampler"]))
    pc = Agent(trainer.agent.cfg, device="cpu")  # the JAX variables through the bridge
    pc.load_state_dict(jax.tree_util.tree_map(np.asarray, ja.variables))
    jax.tree_util.tree_map(np.testing.assert_array_equal, pc.state_dict(),
                           jax.tree_util.tree_map(np.asarray, ja.variables))
    # an upsampler-free load leaves the upsampler as it was
    pd = Agent(trainer.agent.cfg, device="cpu")
    before = copy.deepcopy(pd.state_dict()["upsampler"])
    pd.load(tmp_path / "jax.npz", load_upsampler=False)
    jax.tree_util.tree_map(np.testing.assert_array_equal, pd.state_dict()["upsampler"], before)


def test_wm_only_resume_equals_the_saved_state(wm_only_run):
    trainer, run_dir, overrides, saved = wm_only_run
    resumed = Trainer(load_config(overrides + ["common.resume=True"]), run_dir, run_dir=run_dir,
                      device="cpu")
    states_equal(saved[-1], resumed.state_dict())
    assert set(saved[-1]["train_states"]) == set(trainer.model_names)


def test_two_stage_refusals(tmp_path):
    """The JAX trainer's two refusals, in its words: two-stage without a static dataset,
    and imagination RL with an upsampler."""
    with pytest.raises(ValueError, match="set static_dataset.path"):
        Trainer(load_config(TRAINER_OVERRIDES), tmp_path, run_dir=tmp_path / "run1",
                device="cpu")
    write_static_dataset(tmp_path / "static")
    cfg = load_config([o for o in TRAINER_OVERRIDES if o != "training.wm_only=True"]
                      + [f"static_dataset.path={tmp_path / 'static'}"])
    trainer = Trainer(cfg, tmp_path, run_dir=tmp_path / "run2", device="cpu")
    with pytest.raises(ValueError, match="imagination RL with a two-stage world model"):
        trainer.ac_train_step()
