"""The play app of diamond_tpu_torch (play.py, game/) against the JAX package's, on the
CPU in float32 at a tiny size: 16x16 frames, the actor-critic channels [8, 8], LSTM 32,
3 actions (tests/test_play_stack.py's); a two-stage agent's policy at 8x8 (factor 2).
The same weights go through the weight bridge; the JAX policy's Gumbel draws are rebuilt
from its key splits and injected into the port.

  * PlayEnv's policy over the port's FakeEnv, single-stage and two-stage: the logits and
    the carry of every step, the actions exactly, the carry's resets at episode ends;
  * recording in human control: both packages record the same actions, the ``rec_*``
    datasets are equal array for array and each package loads the other's;
  * DatasetEnv under one key sequence: the same frames, rewards, ends and header lines;
  * keymap: the same chords and names for ``fake``, the FakeALE double and a game of the
    static table;
  * Game.run headless (``SDL_VIDEODRIVER=dummy``) over the port's PlayEnv;
  * play.py: the builder on the CPU from tiny run dirs of the port (single- and two-stage,
    f32 compute, --int8, --record, the horizon keys, env cycling, then --dataset-mode),
    from a JAX run's snapshot, with --pretrained through a stub ``huggingface_hub`` (the
    published config's bf16 compute); ``main`` without CUDA; a run dir with only a
    ``trainer.yaml``.

Tolerances, each with its reason:
  * logits and carry: atol 1e-5 (f32 through the conv trunk and the LSTM in other
    orders); actions, frames, rewards, ends, truncations and datasets exactly;
  * the two-stage policy's input: the JAX policy step runs under ``jax.disable_jit()``
    (jitted, XLA reorders the area mean's sum and lands one grid level away from its own
    eager result in many values, a third of a FakeEnv frame's at factor 4); the port
    equals the eager result bit for bit.
"""

import copy
import sys
import types
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.data import Dataset as JDataset
from diamond_tpu.data.episode import obs_to_float as j_obs_to_float
from diamond_tpu.game import keymap as jkeymap
from diamond_tpu.game.dataset_env import DatasetEnv as JDatasetEnv
from diamond_tpu.game.play_env import NamedEnv as JNamedEnv, PlayEnv as JPlayEnv
from diamond_tpu.models import ActorCritic as JActorCritic
from diamond_tpu.models import ActorCriticConfig as JActorCriticConfig
from diamond_tpu.models.denoiser import downsample_avg as j_downsample_avg
from diamond_tpu.models.denoiser import quantize_to_uint8_grid as j_quantize
from diamond_tpu_torch import config as tc
from diamond_tpu_torch import play
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.envs.fake_env import FakeEnv
from diamond_tpu_torch.game import keymap
from diamond_tpu_torch.game.dataset_env import DatasetEnv
from diamond_tpu_torch.game.play_env import NamedEnv, PlayEnv
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import ActorCritic, Agent
from diamond_tpu_torch.ops import quant

from torch_port_util import random_variables

LOGIT_ATOL = 1e-5
IMG, C, NA, D = 16, 3, 3, 32
EPISODE_STEPS = 10  # FakeEnv's max_episode_steps here: an end every 10 steps at most
STEPS = 25

TINY = ["env=fake", f"env.train.size={IMG}", "env.train.max_episode_steps=30",
        "tpu.compute_dtype=float32",
        "agent.denoiser.inner_model.cond_channels=16", "agent.denoiser.inner_model.depths=[1,1]",
        "agent.denoiser.inner_model.channels=[8,8]", "agent.denoiser.inner_model.attn_depths=[0,0]",
        f"agent.rew_end_model.lstm_dim={D}", "agent.rew_end_model.cond_channels=8",
        "agent.rew_end_model.depths=[1,1]", "agent.rew_end_model.channels=[8,8]",
        "agent.rew_end_model.attn_depths=[0,0]", f"agent.actor_critic.lstm_dim={D}",
        "agent.actor_critic.channels=[8,8]", "agent.actor_critic.down=[1,1]"]
TWO_STAGE = ["agent=csgo", "agent.upsampler.upsampling_factor=2",
             "agent.upsampler.inner_model.cond_channels=16",
             "agent.upsampler.inner_model.depths=[1]", "agent.upsampler.inner_model.channels=[8]",
             "agent.upsampler.inner_model.attn_depths=[0]"]


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the play path makes thousands of tiny ops, and
    with a thread pool per op they crawl when other test processes hold the cores (an
    app test took 168 s instead of 2 beside five busy processes, 11 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Logged:
    """An env that keeps the actions it is stepped with."""

    def __init__(self, env):
        self.env, self.actions = env, []

    def reset(self, *a, **k):
        return self.env.reset(*a, **k)

    def step(self, act):
        self.actions.append(int(np.asarray(act).reshape(-1)[0]))
        return self.env.step(act)


def _policies(factor: int, seed: int = 5):
    """The JAX and the port agents' stand-ins: the same actor-critic weights, a policy at
    IMG // factor."""
    size = IMG // factor
    jac = JActorCritic(JActorCriticConfig(lstm_dim=D, img_channels=C, img_size=size,
                                          channels=[8, 8], down=[1, 1], num_actions=NA))
    v = random_variables(jac.init, seed=seed)
    pac = ActorCritic(tc.ActorCriticConfig(lstm_dim=D, img_channels=C, img_size=size,
                                           channels=[8, 8], down=[1, 1], num_actions=NA))
    load_variables(pac.net, v)
    up = object() if factor > 1 else None
    j_agent = types.SimpleNamespace(
        actor_critic=jac, variables={"actor_critic": v}, upsampler=up,
        cfg=types.SimpleNamespace(upsampler=types.SimpleNamespace(upsampling_factor=factor)))
    p_agent = types.SimpleNamespace(actor_critic=pac, upsampler=up,
                                    cfg=types.SimpleNamespace(downsample_factor=factor))
    return j_agent, p_agent


def _j_logits(j_agent, factor, obs_u8, carry):
    """JAX's policy output, composed op by op."""
    obs = j_obs_to_float(jnp.asarray(obs_u8))
    if factor > 1:
        obs = j_quantize(j_downsample_avg(obs, factor))
    return j_agent.actor_critic.predict_act_value(j_agent.variables["actor_critic"], obs, carry)


@pytest.mark.parametrize("factor", [1, 2])
def test_policy_play_matches_jax(factor):
    """STEPS frames under policy control over the port's FakeEnv (an end every
    EPISODE_STEPS at most): at each step the logits from the same frame and carry, the
    action (JAX's categorical draw injected as Gumbel noise), the next frame, reward and
    end, and the carry after the step (zero again after each end)."""
    j_agent, p_agent = _policies(factor)
    j_env, p_env = (Logged(FakeEnv(1, size=IMG, max_episode_steps=EPISODE_STEPS))
                    for _ in range(2))
    jp = JPlayEnv(j_agent, [JNamedEnv("real", j_env)], "fake", 15, seed=3)
    pp = PlayEnv(p_agent, [NamedEnv("real", p_env)], "fake", 15)
    with jax.disable_jit():  # the two-stage downsample as the JAX env's eager path runs it
        j_obs, _ = jp.reset()
        p_obs, _ = pp.reset()
        np.testing.assert_array_equal(p_obs, j_obs)
        jp.human = pp.human = False
        resets = 0
        for i in range(STEPS):
            j_out = _j_logits(j_agent, factor, jp._obs, jp._carry)
            _, p_out = pp.policy_step(pp._obs, pp._carry, torch.zeros(1, NA))
            np.testing.assert_allclose(p_out.logits_act.numpy(), np.asarray(j_out.logits_act),
                                       rtol=0, atol=LOGIT_ATOL)
            np.testing.assert_allclose(p_out.val.numpy(), np.asarray(j_out.val), rtol=0,
                                       atol=LOGIT_ATOL)
            _, k = jax.random.split(jp._rng)  # the key JAX's step draws with
            g = torch.from_numpy(np.asarray(jax.random.gumbel(k, (1, NA))))
            j_step = jp.step(0)
            p_step = pp.step(0, gumbel_noise=g)
            assert p_env.actions[-1] == j_env.actions[-1], f"step {i}: actions differ"
            np.testing.assert_array_equal(p_step[0], j_step[0])
            assert p_step[1:4] == j_step[1:4]
            for a, b in zip(pp._carry, jp._carry):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=LOGIT_ATOL)
            if p_step[2] or p_step[3]:
                resets += 1
                assert not any(t.any() for t in pp._carry), "the carry is not zero after an end"
    assert resets >= 2 and len(set(p_env.actions)) > 1


def test_two_stage_policy_sees_the_eager_downsample():
    """The port's two-stage policy input equals JAX's eager downsample bit for bit; JAX's
    jitted policy step lands on other grid levels (recorded in ROADMAP queue 3): the
    reason the parity test above runs JAX op by op."""
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.models.denoiser import downsample_avg, quantize_to_uint8_grid

    rng = np.random.default_rng(0)
    obs_u8 = rng.integers(0, 256, (1, IMG, IMG, C), dtype=np.uint8)
    with jax.disable_jit():
        eager = np.asarray(j_quantize(j_downsample_avg(j_obs_to_float(jnp.asarray(obs_u8)), 2)))
    jitted = np.asarray(jax.jit(lambda o: j_quantize(j_downsample_avg(j_obs_to_float(o), 2)))(
        jnp.asarray(obs_u8)))
    port = quantize_to_uint8_grid(downsample_avg(obs_to_float(torch.from_numpy(obs_u8)), 2))
    np.testing.assert_array_equal(port.numpy(), eager)
    assert np.abs(jitted - eager).max() <= 2 / 255 + 1e-6  # one grid level


def _record(tmp_path, steps=STEPS):
    """Human play with the same actions over the port's FakeEnv, recorded by both packages.
    Returns the JAX and the port record dirs."""
    j_agent, p_agent = _policies(1)
    dirs = tmp_path / "jax_rec", tmp_path / "port_rec"
    jp = JPlayEnv(j_agent, [JNamedEnv("real", FakeEnv(1, size=IMG,
                                                      max_episode_steps=EPISODE_STEPS))],
                  "fake", 15, record_mode=True, record_dir=dirs[0])
    pp = PlayEnv(p_agent, [NamedEnv("real", FakeEnv(1, size=IMG,
                                                    max_episode_steps=EPISODE_STEPS))],
                 "fake", 15, record_mode=True, record_dir=dirs[1])
    for env in (jp, pp):
        env.reset()
        for i in range(steps):
            env.step((i // 3) % NA)
    return dirs


def _episodes(ds):
    return [ds.load_episode(i) for i in range(ds.num_episodes)]


def test_recordings_are_equal_and_load_in_both_packages(tmp_path):
    j_dir, p_dir = _record(tmp_path)
    name = "rec_real_H"
    loaded = {}
    for who, d in (("jax", j_dir), ("port", p_dir)):
        for pkg, cls in (("jax", JDataset), ("port", Dataset)):
            ds = cls(d / name, name)
            ds.load_from_default_path()
            loaded[who, pkg] = _episodes(ds)
    ref = loaded["jax", "jax"]
    assert len(ref) == STEPS // EPISODE_STEPS
    for key, eps in loaded.items():
        assert len(eps) == len(ref), key
        for a, b in zip(eps, ref):
            for f in ("obs", "act", "rew", "end", "trunc"):
                x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
                assert x.dtype == y.dtype and np.array_equal(x, y), (key, f)
            assert set(a.info) == set(b.info) == {"final_observation"}, key
            np.testing.assert_array_equal(a.info["final_observation"],
                                          b.info["final_observation"])


def test_dataset_browser_matches_jax(tmp_path):
    pygame = pytest.importorskip("pygame")
    j_dir, p_dir = _record(tmp_path)
    # a second dataset for Tab: the same episodes under another name
    _record(tmp_path / "more")
    (p_dir / "rec_more_H").symlink_to(tmp_path / "more" / "port_rec" / "rec_real_H")
    names = ("rec_real_H", "rec_more_H")

    def load(cls):
        out = []
        for n in names:
            ds = cls(p_dir / n, n)
            ds.load_from_default_path()
            out.append(ds)
        return out

    j_env, p_env = JDatasetEnv(load(JDataset)), DatasetEnv(load(Dataset))
    keys = [None, None, pygame.K_RIGHTBRACKET, None, pygame.K_LEFT, None, None,
            pygame.K_PAGEDOWN, None, pygame.K_TAB, None, pygame.K_PAGEUP, None,
            pygame.K_LEFTBRACKET] + [None] * 12
    assert np.array_equal(j_env.reset()[0], p_env.reset()[0])
    for i, key in enumerate(keys):
        if key is not None:
            j_env.key_handler(key)
            p_env.key_handler(key)
        j, p = j_env.step(0), p_env.step(0)
        np.testing.assert_array_equal(p[0], j[0])
        assert p[1:4] == j[1:4], i
        assert p_env.header_lines() == j_env.header_lines(), i


def test_keymaps_match_jax():
    pytest.importorskip("pygame")
    for name in ("fake", "atari/FakeALENoFrameskip-v4", "atari/PongNoFrameskip-v4"):
        assert keymap.get_keymap_and_action_names(name) == \
            jkeymap.get_keymap_and_action_names(name), name
    assert keymap.ATARI_ACTION_NAMES == jkeymap.ATARI_ACTION_NAMES
    assert keymap.STATIC_ACTION_MEANINGS == jkeymap.STATIC_ACTION_MEANINGS


# ---------------------------------------------------------------------------
# play.py


def _run_dir(root: Path, overrides, num_actions=FakeEnv.num_actions, seed=0) -> Path:
    """A run dir as the port's trainer leaves it: config/trainer.json and an agent
    snapshot of seeded random weights."""
    cfg = tc.load_config(overrides)
    tc.save_config(cfg, root / "config" / "trainer.json")
    acfg = copy.deepcopy(cfg.agent)
    acfg.num_actions = num_actions
    acfg.__post_init__()
    agent = Agent(acfg, torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # the zero-init heads and output convs get weights too
        for net in agent.nets.values():
            for p in net.parameters():
                if p.dim() > 1 and not p.any():
                    p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1))
                            * 0.1)
    (root / "checkpoints" / "agent_versions").mkdir(parents=True)
    agent.save(root / "checkpoints" / "agent_versions" / "agent_epoch_00001.npz")
    return root


@pytest.mark.parametrize("two_stage", [False, True])
def test_build_app_plays_records_and_browses(tmp_path, two_stage):
    run = _run_dir(tmp_path, TINY + (TWO_STAGE if two_stage else []))
    args = play.parse_args(["--run-dir", str(run), "-n", "40", "--horizon", "6", "--int8",
                            "-r"])
    app = play.build_app(args, device="cpu")
    agent = app.agent
    nets = [agent.denoiser.inner_model, agent.rew_end_model.net] + (
        [agent.upsampler.inner_model] if two_stage else [])
    assert all(quant.has_collection(n) for n in nets), "--int8 left a model uncalibrated"
    assert [e.name for e in app.envs] == ["world_model", "test", "train"]
    wm = app.env
    assert wm.horizon == 6 and wm._return_traj
    obs, _ = app.reset()
    assert obs.shape == (IMG, IMG, C) and obs.dtype == np.uint8
    lengths, n = [], 0
    for i in range(24):
        if i == 8:
            app.human = False
        if i == 12:
            app.change_horizon(-4)  # horizon 2: the next episodes last at most 2 frames
            assert wm.horizon == 2 and wm.engine.cfg.horizon == 2
        obs, rew, end, trunc, info = app.step(i % NA)
        n += 1
        if end or trunc:
            if i > 14:
                lengths.append(n)
            n = 0
    assert obs.shape == (IMG, IMG, C) and lengths and max(lengths) <= 2, lengths
    app.change_horizon(3)
    assert wm.horizon == 5
    for name in ("test", "train", "world_model"):
        app.cycle_env(1)
        assert app.env_name == name
        for i in range(3):
            obs, *_ = app.step(i % NA)
            assert obs.shape == (IMG, IMG, C)
    recs = sorted(p.name for p in (run / "dataset").iterdir())
    assert recs == ["rec_world_model_H", "rec_world_model_P"], recs
    for name in recs:  # the recordings load in the JAX package
        ds = JDataset(run / "dataset" / name, name)
        ds.load_from_default_path()
        assert ds.num_episodes > 0
    browser = play.build_app(play.parse_args(["--run-dir", str(run), "-d"]))
    assert isinstance(browser, DatasetEnv)
    assert [d.name for d in browser.datasets] == recs
    browser.reset()
    browser.next_episode()
    browser.next_dataset()
    assert browser.ds_idx == 1 and browser.step(0)[0].shape == (IMG, IMG, C)


def test_two_stage_seed_collection_runs_the_policy_at_low_res(tmp_path):
    """The seed collector drives a two-stage agent's policy on the downsampled frames
    (the JAX package's play fails here with a shape error, ROADMAP queue 3): the
    collector's policy gives the PlayEnv policy's logits on the same frame."""
    run = _run_dir(tmp_path, TINY + TWO_STAGE)
    app = play.build_app(play.parse_args(["--run-dir", str(run), "-n", "12"]), device="cpu")
    ac = app.agent.actor_critic
    frame = np.random.default_rng(0).integers(0, 256, (1, IMG, IMG, C), dtype=np.uint8)
    from diamond_tpu_torch.data.episode import obs_to_float

    policy = play.LowResPolicy(ac, 2)
    with torch.no_grad():
        out = policy.head(policy.encode(obs_to_float(torch.from_numpy(frame))), app.initial_carry())
    _, ref = app.policy_step(frame, app.initial_carry(), torch.zeros(1, NA))
    assert torch.equal(out.logits_act, ref.logits_act)


def test_build_app_plays_from_a_jax_run_snapshot(tmp_path):
    """A JAX run's agent snapshot plays once the run's config is given as trainer.json."""
    from diamond_tpu.config import load_config as j_load_config
    from diamond_tpu.models import Agent as JAgent, AgentConfig as JAgentConfig

    jcfg = j_load_config("trainer", overrides=TINY)
    jagent = JAgent(JAgentConfig.from_cfg(jcfg.agent, FakeEnv.num_actions))
    jagent.variables = {  # random values in the trees of Agent.init (traced, not run)
        "denoiser": random_variables(jagent.denoiser.init, seed=4, img_size=IMG),
        "rew_end_model": random_variables(jagent.rew_end_model.init, seed=5),
        "actor_critic": random_variables(jagent.actor_critic.init, seed=6)}
    (tmp_path / "checkpoints" / "agent_versions").mkdir(parents=True)
    jagent.save(tmp_path / "checkpoints" / "agent_versions" / "agent_epoch_00003.npz")
    tc.save_config(tc.load_config(TINY), tmp_path / "config" / "trainer.json")
    app = play.build_app(play.parse_args(["--run-dir", str(tmp_path), "-n", "12",
                                          "--horizon", "4"]), device="cpu")
    got = app.agent.state_dict()
    ref = jax.tree_util.tree_map(np.asarray, jagent.variables)
    for name in ("denoiser", "rew_end_model", "actor_critic"):
        for (kp, a), (kr, b) in zip(jax.tree_util.tree_flatten_with_path(got[name])[0],
                                    jax.tree_util.tree_flatten_with_path(ref[name])[0]):
            assert kp == kr and np.array_equal(a, b), (name, kp)
    app.reset()
    app.human = False
    for i in range(5):
        assert app.step(0)[0].shape == (IMG, IMG, C)


AGENT_YAML = f"""\
_target_: agent.AgentConfig
denoiser:
  _target_: models.diffusion.DenoiserConfig
  sigma_data: 0.5
  sigma_offset_noise: 0.3
  inner_model:
    _target_: models.diffusion.InnerModelConfig
    img_channels: 3
    num_steps_conditioning: 4
    cond_channels: 16
    depths: [1, 1]
    channels: [8, 8]
    attn_depths: [0, 0]
rew_end_model:
  _target_: models.rew_end_model.RewEndModelConfig
  lstm_dim: {D}
  img_channels: ${{agent.denoiser.inner_model.img_channels}}
  img_size: ${{env.train.size}}
  cond_channels: 8
  depths: [1, 1]
  channels: [8, 8]
  attn_depths: [0, 0]
actor_critic:
  _target_: models.actor_critic.ActorCriticConfig
  lstm_dim: {D}
  img_channels: ${{agent.denoiser.inner_model.img_channels}}
  img_size: ${{env.train.size}}
  channels: [8, 8]
  down: [1, 1]
"""
ENV_YAML = f"""\
train:
  id: BreakoutNoFrameskip-v4
  done_on_life_loss: True
  size: {IMG}
  max_episode_steps: 60
test:
  id: ${{..train.id}}
  done_on_life_loss: False
  size: ${{..train.size}}
  max_episode_steps: 60
keymap: atari/${{.train.id}}
"""


def test_pretrained_through_a_stub_hub(tmp_path, monkeypatch):
    """--pretrained with ``huggingface_hub`` replaced by a stub that serves local files:
    a DIAMOND-format checkpoint of tests/torch_twin.py's modules and the published
    config groups in their YAML form (``_target_`` keys, ``${...}`` interpolations). The
    composed config equals the JAX package's on every agent and env key, the agent holds
    the converted weights, and the app plays the FakeALE double."""
    pytest.importorskip("yaml")
    from torch_twin import TActorCritic, TInnerModel, TRewEndModel
    from diamond_tpu.play import compose_pretrained_config as j_compose
    from diamond_tpu_torch.interop.reference_ckpt import convert_reference_state_dict

    torch.manual_seed(0)
    flat = {f"denoiser.inner_model.{k}": v for k, v in
            TInnerModel(C, 4, 16, [1, 1], [8, 8], [0, 0], 4).state_dict_ref_format().items()}
    flat.update({f"rew_end_model.{k}": v for k, v in
                 TRewEndModel(D, C, IMG, 8, [1, 1], [8, 8], [0, 0], 4).state_dict().items()})
    flat.update({f"actor_critic.{k}": v for k, v in
                 TActorCritic(D, C, IMG, [8, 8], [1, 1], 4).state_dict().items()})
    files = {"atari_100k/models/FakeALE.pt": tmp_path / "FakeALE.pt",
             "atari_100k/config/agent/default.yaml": tmp_path / "default.yaml",
             "atari_100k/config/env/atari.yaml": tmp_path / "atari.yaml"}
    torch.save(flat, files["atari_100k/models/FakeALE.pt"])
    files["atari_100k/config/agent/default.yaml"].write_text(AGENT_YAML)
    files["atari_100k/config/env/atari.yaml"].write_text(ENV_YAML)
    asked = []

    def hf_hub_download(repo_id, filename):
        asked.append((repo_id, filename))
        return str(files[filename])

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=hf_hub_download))

    cfg, jcfg = play.compose_pretrained_config("FakeALE"), j_compose("FakeALE")
    for section in ("denoiser", "rew_end_model", "actor_critic"):
        for k, v in asdict(getattr(cfg.agent, section)).items():
            if k in ("inner_model",):
                for kk, vv in v.items():
                    if kk not in ("num_actions", "is_upsampler"):
                        assert vv == jcfg.agent[section].inner_model[kk], (section, kk)
            elif k != "num_actions":  # (the JAX config leaves out a None upsampling_factor)
                assert v == jcfg.agent[section].get(k, None), (section, k)
    for split in ("train", "test"):
        assert asdict(getattr(cfg.env, split)) == dict(jcfg.env[split]), split
    assert cfg.env.keymap == jcfg.env.keymap == "atari/FakeALENoFrameskip-v4"

    run = tmp_path / "run"
    run.mkdir()  # no local config and no checkpoint
    app = play.build_app(play.parse_args(["--run-dir", str(run), "--pretrained", "--game",
                                          "FakeALE", "-n", "20", "--horizon", "4"]),
                         device="cpu")
    assert ("eloialonso/diamond", "atari_100k/models/FakeALE.pt") in asked
    ref = convert_reference_state_dict({k: v.numpy() for k, v in flat.items()}, img_size=IMG,
                                       ac_down=[1, 1])
    got = app.agent.state_dict()
    for name in ref:
        for coll in ref[name]:
            for (kp, a), (kr, b) in zip(
                    jax.tree_util.tree_flatten_with_path(got[name][coll])[0],
                    jax.tree_util.tree_flatten_with_path(ref[name][coll])[0]):
                assert kp == kr and np.array_equal(a, b), (name, kp)
    app.reset()
    app.human = False
    for _ in range(4):
        obs, *_ = app.step(0)
    assert obs.shape == (IMG, IMG, C)


def test_game_loop_headless(tmp_path, monkeypatch):
    pytest.importorskip("pygame")
    from diamond_tpu_torch.game.game import Game

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    run = _run_dir(tmp_path, TINY)
    app = play.build_app(play.parse_args(["--run-dir", str(run), "-n", "20", "--horizon",
                                          "4", "-r"]), device="cpu")
    Game(app, size=(64, 64), fps=1000).run(max_steps=12)
    app.human = False  # the policy's path
    Game(app, size=(64, 64), fps=1000).run(max_steps=12)
    assert (run / "dataset" / "rec_world_model_H").is_dir()
    assert (run / "dataset" / "rec_world_model_P").is_dir()


def test_main_needs_cuda_and_a_json_config(tmp_path, capsys):
    run = _run_dir(tmp_path, TINY)
    if not torch.cuda.is_available():
        assert play.main(["--run-dir", str(run)]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        with pytest.raises(RuntimeError, match="no CUDA device"):
            play.build_app(play.parse_args(["--run-dir", str(run)]))
    jax_run = tmp_path / "jax_run"
    (jax_run / "config").mkdir(parents=True)
    (jax_run / "config" / "trainer.yaml").write_text("defaults: []\n")
    with pytest.raises(ValueError, match="trainer.yaml"):
        play.build_app(play.parse_args(["--run-dir", str(jax_run)]), device="cpu")
    with pytest.raises(ValueError, match="trainer.yaml"):
        play.build_app(play.parse_args(["--run-dir", str(jax_run), "-d"]))
