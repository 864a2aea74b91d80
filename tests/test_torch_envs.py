"""The port's envs (diamond_tpu_torch/envs/{fake_env,env,fake_ale,atari_preprocessing}.py)
against the JAX package's, step for step on the same seeds and actions: frames, rewards,
ends, truncations and final observations. The FakeALE stack runs the whole Atari path
(AsyncVectorEnv with same-step autoreset, the preprocessing, life loss as an end).

Tolerance: none; everything is compared exactly (numpy on both sides)."""

import numpy as np
import pytest

from diamond_tpu.envs.env import make_atari_env as j_make_atari_env, make_env as j_make_env
from diamond_tpu.envs.fake_ale import FAKE_ALE_ID as J_FAKE_ALE_ID, register_fake_ale
from diamond_tpu_torch.envs.env import make_atari_env, make_env


def assert_steps_equal(a, b, step):
    obs, rew, end, trunc, info = a
    jobs, jrew, jend, jtrunc, jinfo = b
    np.testing.assert_array_equal(obs, jobs, err_msg=f"obs at step {step}")
    np.testing.assert_array_equal(rew, jrew, err_msg=f"rew at step {step}")
    np.testing.assert_array_equal(end, jend, err_msg=f"end at step {step}")
    np.testing.assert_array_equal(trunc, jtrunc, err_msg=f"trunc at step {step}")
    assert ("final_observation" in info) == ("final_observation" in jinfo), step
    if "final_observation" in info:
        np.testing.assert_array_equal(info["final_observation"], jinfo["final_observation"])
    return int(np.sum(np.asarray(end) | np.asarray(trunc)))


@pytest.mark.parametrize("size,max_steps", [(16, 12), (64, 100)])
def test_fake_env_matches_jax_step_for_step(size, max_steps):
    kw = dict(id="Fake-v0", num_envs=3, done_on_life_loss=False, size=size,
              max_episode_steps=max_steps)
    env, jenv = make_env(**kw), j_make_env(**kw)
    assert env.num_actions == jenv.num_actions == 3
    obs, _ = env.reset(seed=[5, 6, 7])
    jobs, _ = jenv.reset(seed=[5, 6, 7])
    np.testing.assert_array_equal(obs, jobs)
    rng = np.random.default_rng(0)
    deaths = ends = 0
    for step in range(250):
        act = rng.integers(0, 3, 3)
        a, b = env.step(act), jenv.step(act)
        deaths += assert_steps_equal(a, b, step)
        ends += int(np.sum(a[2]))
    assert deaths > 0 and (ends > 0 or size == 16)


def test_fake_ale_stack_matches_jax():
    """Life loss as an end (done_on_life_loss), noop reset, frame skip and max-pool, the
    INTER_AREA resize, same-step autoreset with the final observation."""
    register_fake_ale()
    kw = dict(num_envs=2, done_on_life_loss=True, size=16, max_episode_steps=None)
    env = make_atari_env("FakeALENoFrameskip-v4", **kw)
    jenv = j_make_atari_env(J_FAKE_ALE_ID, **kw)
    try:
        assert env.num_actions == jenv.num_actions == 4
        obs, info = env.reset(seed=11)
        jobs, jinfo = jenv.reset(seed=11)
        np.testing.assert_array_equal(obs, jobs)
        np.testing.assert_array_equal(info["frame_number"], jinfo["frame_number"])
        rng = np.random.default_rng(1)
        deaths = 0
        for step in range(60):
            act = rng.integers(0, 4, 2)
            deaths += assert_steps_equal(env.step(act), jenv.step(act), step)
        assert deaths > 0
    finally:
        env.close()
        jenv._venv.close()


def test_env_modules_import_no_gymnasium_or_cv2():
    import subprocess
    import sys

    code = ("import sys\n"
            "import diamond_tpu_torch.envs.env, diamond_tpu_torch.envs.fake_ale\n"
            "import diamond_tpu_torch.envs.atari_preprocessing, diamond_tpu_torch.envs.fake_env\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('gymnasium', 'cv2'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)
