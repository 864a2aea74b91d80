"""Machado-style Atari preprocessing (diamond_tpu/envs/atari_preprocessing.py):

  * noop reset (up to ``noop_max`` random NOOPs),
  * frame skip 4 with max-pooling of the last two raw frames,
  * cv2 INTER_AREA resize to ``screen_size`` x ``screen_size`` RGB (not grayscale),
  * ``life_loss`` flag in info (the end on life loss is applied after vectorization,
    envs/env.py),
  * ``original_obs`` passthrough of the pre-resize frame.

gymnasium and cv2 are imported when the wrapper class is first made
(``atari_preprocessing_class``), never when this module is imported.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def atari_preprocessing_class():
    """The AtariPreprocessing class (a gymnasium.Wrapper)."""
    import cv2
    import gymnasium

    class AtariPreprocessing(gymnasium.Wrapper):
        def __init__(self, env: Any, noop_max: int = 30, frame_skip: int = 4,
                     screen_size: int = 64) -> None:
            super().__init__(env)
            assert frame_skip > 0 and screen_size > 0
            assert noop_max >= 0
            if frame_skip > 1:
                assert "NoFrameskip" in env.spec.id or env.spec.kwargs.get("frameskip") == 1, (
                    "disable env frame-skipping when frame_skip > 1")
            self.noop_max = noop_max
            self.frame_skip = frame_skip
            self.screen_size = screen_size

            shape = env.observation_space.shape
            self._raw_buffer = [np.empty(shape, np.uint8), np.empty(shape, np.uint8)]
            self.lives = 0
            self.observation_space = gymnasium.spaces.Box(
                low=0, high=255, shape=(screen_size, screen_size, 3), dtype=np.uint8)

        @property
        def ale(self):
            return self.env.unwrapped.ale

        def reset(self, **kwargs) -> Tuple[np.ndarray, Dict[str, Any]]:
            _, reset_info = self.env.reset(**kwargs)
            noops = self.env.unwrapped.np_random.integers(1, self.noop_max + 1) \
                if self.noop_max > 0 else 0
            for _ in range(noops):
                _, _, terminated, truncated, step_info = self.env.step(0)
                reset_info.update(step_info)
                if terminated or truncated:
                    _, reset_info = self.env.reset(**kwargs)
            self.lives = self.ale.lives()
            self._fill_raw_buffer(0)
            self._raw_buffer[1].fill(0)
            obs = self._resized_obs()
            reset_info["life_loss"] = False
            reset_info["original_obs"] = self._raw_buffer[0].copy()
            return obs, reset_info

        def step(self, action: int) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
            total_reward, terminated, truncated, info = 0.0, False, False, {}
            life_loss = False
            for t in range(self.frame_skip):
                _, reward, terminated, truncated, info = self.env.step(action)
                total_reward += float(reward)
                new_lives = self.ale.lives()
                # any decrease of the lives flags a life loss, the last one included
                life_loss = life_loss or new_lives < self.lives
                self.lives = new_lives
                if terminated or truncated:
                    break
                if t == self.frame_skip - 2:
                    self._fill_raw_buffer(1)
            self._fill_raw_buffer(0)
            info["life_loss"] = life_loss
            np.maximum(self._raw_buffer[0], self._raw_buffer[1], out=self._raw_buffer[0])
            info["original_obs"] = self._raw_buffer[0].copy()
            return self._resized_obs(), total_reward, terminated, truncated, info

        def _fill_raw_buffer(self, i: int) -> None:
            self.ale.getScreenRGB(self._raw_buffer[i])

        def _resized_obs(self) -> np.ndarray:
            return cv2.resize(self._raw_buffer[0], (self.screen_size, self.screen_size),
                              interpolation=cv2.INTER_AREA)

    return AtariPreprocessing


def make_atari_preprocessing(env: Any, noop_max: int = 30, frame_skip: int = 4,
                             screen_size: int = 64):
    return atari_preprocessing_class()(env, noop_max=noop_max, frame_skip=frame_skip,
                                       screen_size=screen_size)
