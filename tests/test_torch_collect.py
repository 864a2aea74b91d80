"""The port's collection path (diamond_tpu_torch/coroutines, data/prefetch.py) against the
JAX package's: the same actor-critic weights through the bridge, the same env seeds, and
the JAX loop's draws rebuilt from its key splits (fold_in(key, step) split in 3: the
categorical's Gumbel, the random action, the epsilon uniform) and injected into the port.

Tolerance: actions, rewards, ends, truncations, frames, reset masks and episodes
exactly; logits, values and bootstraps rtol = atol = 1e-4 (f32 through a two-level
conv trunk and an LSTM, over 30 steps)."""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.coroutines import Collector as JCollector, EnvLoop as JEnvLoop
from diamond_tpu.coroutines import NumToCollect as JNumToCollect
from diamond_tpu.data import Dataset as JDataset
from diamond_tpu.envs import FakeEnv as JFakeEnv
from diamond_tpu.models import ActorCritic as JActorCritic, ActorCriticConfig as JACConfig
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.coroutines import Collector, EnvLoop, NumToCollect
from diamond_tpu_torch.data.batch_sampler import BatchSampler
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.prefetch import BatchPrefetcher
from diamond_tpu_torch.data.segment import collate_segments_to_batch
from diamond_tpu_torch.envs.fake_env import FakeEnv
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import ActorCritic

from torch_port_util import close, random_variables

RTOL = ATOL = 1e-4
IMG, NA, D = 16, 3, 32
AC = dict(lstm_dim=D, img_channels=3, img_size=IMG, channels=[16, 32], down=[1, 1],
          num_actions=NA)


@pytest.fixture(scope="module")
def policies():
    jac = JActorCritic(JACConfig(**AC))
    v = random_variables(jac.init, seed=21)
    pac = ActorCritic(tc.ActorCriticConfig(**AC))
    load_variables(pac.net, v)
    return jac, v, pac


def jax_draws(seed, per_env):
    """The JAX EnvLoop's draws of step s: split(fold_in(PRNGKey(seed), s), 3)."""
    key = jax.random.PRNGKey(seed)

    def draw(step, b, a):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, step), 3)
        g = jax.random.gumbel(k1, (b, a), jnp.float32)
        r = jax.random.randint(k2, (b,), 0, a)
        u = jax.random.uniform(k3, (b,) if per_env else ())
        return (torch.from_numpy(np.array(g)), torch.from_numpy(np.array(u)),
                torch.from_numpy(np.array(r)).long())
    return draw


def envs(num_envs=3, max_steps=7, size=IMG):
    return FakeEnv(num_envs, size=size, max_episode_steps=max_steps), \
        JFakeEnv(num_envs, size=size, max_episode_steps=max_steps)


@pytest.mark.parametrize("epsilon,per_env", [(0.0, False), (0.4, False), (0.4, True)])
def test_env_loop_matches_jax(policies, epsilon, per_env):
    """30 steps of a 3-env FakeEnv whose episodes are cut at 7 steps (deaths at several
    steps, the final-obs values included), in two sends."""
    jac, v, pac = policies
    env, jenv = envs()
    loop = EnvLoop(env, pac, epsilon=epsilon, seed=3, epsilon_per_env=per_env)
    loop.draw = jax_draws(3, per_env)
    jloop = JEnvLoop(jenv, jac, lambda: v, epsilon=epsilon, seed=3, epsilon_per_env=per_env)
    deaths = 0
    for n in (18, 12):
        out, jout = loop.send(n), jloop.send(n)
        for i, name in enumerate(("obs", "act", "rew", "end", "trunc")):
            np.testing.assert_array_equal(out[i], jout[i], err_msg=name)
        for i, name in ((5, "logits_act"), (6, "val"), (7, "val_bootstrap")):
            close(out[i], jout[i], RTOL, ATOL)
        np.testing.assert_array_equal(loop.last_extras["reset_mask"],
                                      jloop.last_extras["reset_mask"])
        close(loop.last_extras["hx0"], jloop.last_extras["hx0"], RTOL, ATOL)
        for info, jinfo in zip(out[-1], jout[-1]):
            if "final_observation" in jinfo:
                np.testing.assert_array_equal(info["final_observation"],
                                              jinfo["final_observation"])
        deaths += int(out[3].sum() + out[4].sum())
    assert deaths >= 6


def test_env_loop_without_values_makes_the_same_transitions(policies):
    _, _, pac = policies
    outs = []
    for need_values in (True, False):
        env, _ = envs()
        loop = EnvLoop(env, pac, epsilon=0.2, seed=4)
        loop.draw = jax_draws(4, False)
        out = loop.send(20, need_values=need_values)
        outs.append(out)
    for i in range(5):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])
    assert all(x is None for x in outs[1][5:8])


def test_env_loop_burns_in_world_model_resets(policies):
    """An env whose info carries ``burnin_obs`` (a world-model reset): a dead env's state
    is the policy replayed over those frames from zero."""
    _, _, pac = policies
    rng = np.random.default_rng(5)
    burn = rng.integers(0, 256, (2, 3, IMG, IMG, 3), dtype=np.uint8)

    class BurnEnv(FakeEnv):
        def step(self, actions):
            out = super().step(actions)
            out[-1]["burnin_obs"] = burn
            return out

    env = BurnEnv(2, size=IMG, max_episode_steps=2)
    loop = EnvLoop(env, pac, seed=6)
    loop.send(2)  # both envs die at the second step
    _, hx, cx, dead = loop._state
    assert dead.all()
    carry = (torch.zeros(2, D), torch.zeros(2, D))
    with torch.no_grad():
        for k in range(3):
            carry = loop._act_value(torch.from_numpy(burn[:, k]), carry).carry
    close(hx, carry[0].numpy(), 1e-6, 1e-6)
    close(cx, carry[1].numpy(), 1e-6, 1e-6)


def assert_datasets_equal(ds, jds):
    assert ds.num_episodes == jds.num_episodes and ds.num_steps == jds.num_steps
    assert ds.counts_rew == jds.counts_rew and ds.counts_end == jds.counts_end
    np.testing.assert_array_equal(ds.lengths, jds.lengths)
    for i in range(ds.num_episodes):
        ep, jep = ds.load_episode(i), jds.load_episode(i)
        for name in ("obs", "act", "rew", "end", "trunc"):
            np.testing.assert_array_equal(getattr(ep, name), getattr(jep, name), err_msg=name)
        assert set(ep.info) == set(jep.info)
        for k in ep.info:
            np.testing.assert_array_equal(ep.info[k], jep.info[k])


def test_collector_matches_jax_across_send_boundaries(policies, tmp_path):
    """Train collection in three sends that cut running episodes (stored, then extended,
    no step twice), then test collection (episodes, reset every collect); the datasets
    each package wrote load in the other."""
    jac, v, pac = policies
    env, jenv = envs(num_envs=2, max_steps=9)
    ds, jds = Dataset(tmp_path / "p", "train_dataset"), JDataset(tmp_path / "j", "train_dataset")
    col = Collector(env, pac, ds, epsilon=0.3, seed=8, verbose=False)
    col._reset()
    col.env_loop.draw = jax_draws(8, False)
    jcol = JCollector(jenv, jac, lambda: v, jds, epsilon=0.3, seed=8, verbose=False)
    for steps in (10, 14, 6):
        logs = col.send(NumToCollect(steps=steps))
        jlogs = jcol.send(JNumToCollect(steps=steps))
        assert logs == jlogs
        assert_datasets_equal(ds, jds)
    assert ds.num_steps == 30 and ds.num_episodes >= 3

    tenv, tjenv = envs(num_envs=2, max_steps=9)
    ts, tjs = Dataset(tmp_path / "pt", "test_dataset"), JDataset(tmp_path / "jt", "test_dataset")
    tcol = Collector(tenv, pac, ts, reset_every_collect=True, seed=9, verbose=False)
    tcol._reset()
    tcol.env_loop.draw = jax_draws(9, False)
    tjcol = JCollector(tjenv, jac, lambda: v, tjs, reset_every_collect=True, seed=9,
                       verbose=False)
    assert tcol.send(NumToCollect(episodes=3)) == tjcol.send(JNumToCollect(episodes=3))
    assert_datasets_equal(ts, tjs)

    ds.save_to_default_path()
    jds.save_to_default_path()
    cross_j, cross_p = JDataset(tmp_path / "p", "x"), Dataset(tmp_path / "j", "x")
    cross_j.load_from_default_path()
    cross_p.load_from_default_path()
    assert_datasets_equal(ds, cross_j)
    assert_datasets_equal(cross_p, jds)


def small_dataset(tmp_path):
    rng = np.random.default_rng(10)
    ds = Dataset(tmp_path / "d", "d")
    from diamond_tpu_torch.data.episode import Episode

    for t in (12, 30, 7, 21):
        end = np.zeros(t, np.uint8)
        end[-1] = 1
        ds.add_episode(Episode(obs=rng.integers(0, 256, (t, 8, 8, 3), dtype=np.uint8),
                               act=rng.integers(0, 3, t).astype(np.int32),
                               rew=rng.choice([-1.0, 0.0, 1.0], t).astype(np.float32),
                               end=end, trunc=np.zeros(t, np.uint8),
                               info={"final_observation": rng.integers(
                                   0, 256, (8, 8, 3), dtype=np.uint8)}))
    return ds


SAMPLER_KW = dict(batch_size=5, seq_length=6, sample_weights=[0.5, 0.5],
                  can_sample_beyond_end=True, seed=11)


def check_prefetcher(ds, workers, batches):
    """``batches`` batches of a prefetcher with ``workers`` threads, consumed on a thread
    of their own (joined with a timeout), against the sampler's batches in order."""
    pf = BatchPrefetcher(ds, BatchSampler(ds, 0, 1, **SAMPLER_KW), workers=workers,
                         device="cpu")
    ref = BatchSampler(ds, 0, 1, **SAMPLER_KW)
    got = []
    it = iter(pf)
    consumer = threading.Thread(target=lambda: got.extend(next(it) for _ in range(batches)))
    consumer.start()
    consumer.join(timeout=120)
    pf.stop()
    assert not consumer.is_alive() and len(got) == batches
    for batch in got:
        want = collate_segments_to_batch([ds[s] for s in ref.sample()])
        for name in ("obs", "act", "rew", "end", "trunc", "mask_padding", "final_obs",
                     "has_final_obs"):
            x, y = getattr(batch, name).numpy(), getattr(want, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_prefetcher_yields_the_samplers_batches_in_order(tmp_path, workers):
    check_prefetcher(small_dataset(tmp_path), workers, 8)


def test_prefetcher_keeps_the_order_under_thread_stress(tmp_path):
    """More producer threads than cores, switching every microsecond: the batches still
    come in the sampler's order, none lost or repeated."""
    ds = small_dataset(tmp_path)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        check_prefetcher(ds, (os.cpu_count() or 1) + 2, 40)
    finally:
        sys.setswitchinterval(old)
