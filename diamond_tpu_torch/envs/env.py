"""Real-env construction and the host-side vector-env contract (diamond_tpu/envs/env.py).

Vector-env contract (FakeEnv, NumpyEnv):
  reset(seed)        -> obs uint8 (B, H, W, C), info
  step(actions (B,)) -> obs, rew float32 (B,), end bool (B,), trunc bool (B,), info
  info['final_observation'] is a uint8 (num_dead, H, W, C) stack when any env died; obs
  for dead envs is already the autoreset frame (same-step autoreset).

The env stays numpy uint8 on the host; the policy step uploads the frames and converts
them on the device. gymnasium (and, through the preprocessing, cv2) is imported only
when an Atari env is made: ``env=fake`` needs neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .fake_env import FakeEnv


def make_env(id: str, num_envs: int, done_on_life_loss: bool, size: int,
             max_episode_steps: Optional[int]):
    """'Fake-v0' -> the synthetic env, else an ALE Atari env."""
    if id == "Fake-v0":
        return FakeEnv(num_envs, size=size, max_episode_steps=max_episode_steps)
    return make_atari_env(id=id, num_envs=num_envs, done_on_life_loss=done_on_life_loss,
                          size=size, max_episode_steps=max_episode_steps)


def make_atari_env(id: str, num_envs: int, done_on_life_loss: bool, size: int,
                   max_episode_steps: Optional[int]) -> "NumpyEnv":
    """An ALE env through AtariPreprocessing in a same-step-autoreset AsyncVectorEnv.
    Real ALE ids need ale-py; 'FakeALE*' ids run the same stack on the scripted ALE
    double (envs/fake_ale.py)."""
    try:
        import gymnasium
        from gymnasium.vector import AsyncVectorEnv, AutoresetMode
    except ImportError as e:  # pragma: no cover
        raise ImportError("Atari environments need gymnasium; use env id 'Fake-v0' for the "
                          "synthetic env.") from e

    is_fake_ale = id.startswith("FakeALE")
    if not is_fake_ale:
        try:
            import ale_py  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise ImportError("Real Atari environments need ale-py; use env id 'Fake-v0' "
                              "(synthetic) or 'FakeALENoFrameskip-v4' (scripted ALE "
                              "double).") from e

    def env_fn():
        from .atari_preprocessing import make_atari_preprocessing

        gym_id = id
        if is_fake_ale:  # registered in this process: env_fn may run in a worker
            from .fake_ale import register_fake_ale
            gym_id = register_fake_ale()
        env = gymnasium.make(gym_id, full_action_space=False, frameskip=1,
                             render_mode="rgb_array", max_episode_steps=max_episode_steps)
        return make_atari_preprocessing(env, noop_max=30, frame_skip=4, screen_size=size)

    env = AsyncVectorEnv([env_fn for _ in range(num_envs)],
                         autoreset_mode=AutoresetMode.SAME_STEP)
    return NumpyEnv(env, done_on_life_loss=done_on_life_loss)


class NumpyEnv:
    """A gymnasium vector env behind the contract above, with life loss turned into an
    end after vectorization, so that autoreset does not hide the later lives."""

    def __init__(self, venv: Any, done_on_life_loss: bool = False) -> None:
        self._venv = venv
        self._done_on_life_loss = done_on_life_loss
        self.num_envs = venv.observation_space.shape[0]
        self.num_actions = int(venv.unwrapped.single_action_space.n)

    def reset(self, seed: Optional[Any] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        obs, info = self._venv.reset(seed=seed)
        return np.asarray(obs, np.uint8), info

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                 np.ndarray, Dict[str, Any]]:
        obs, rew, end, trunc, info = self._venv.step(np.asarray(actions))
        obs = np.asarray(obs, np.uint8)
        rew = np.asarray(rew, np.float32)
        end = np.asarray(end, bool)
        trunc = np.asarray(trunc, bool)

        final_key = "final_obs" if "final_obs" in info else "final_observation"
        if self._done_on_life_loss:
            life_loss = np.asarray(info.get("life_loss", np.zeros(self.num_envs, bool)))
            if life_loss.any():
                # a life loss ends the episode; the current frame is its final one
                end = end | life_loss
                info.setdefault(final_key, np.array([None] * self.num_envs, dtype=object))
                finals = np.asarray(info[final_key], dtype=object)
                for i in np.nonzero(life_loss)[0]:
                    if finals[i] is None:
                        finals[i] = obs[i]
                info[final_key] = finals

        out_info: Dict[str, Any] = {k: v for k, v in info.items()
                                    if k not in (final_key, "final_info", "_final_obs")}
        dead = end | trunc
        if dead.any():
            finals = np.asarray(info[final_key], dtype=object)[dead]
            out_info["final_observation"] = np.stack(
                [np.asarray(f, np.uint8) for f in finals])
        return obs, rew, end, trunc, out_info

    def close(self) -> None:
        self._venv.close()
