"""Deterministic synthetic vector env (diamond_tpu/envs/fake_env.py), for tests and runs
without an emulator: the vector-env contract of envs/env.py (uint8 NHWC frames, same-step
autoreset, ``info["final_observation"]`` stacked for the dead envs) with numpy dynamics,
so a seed gives the same frames, rewards and ends as the JAX package's env.

Dynamics: a Pong-like ball bounces around; the agent moves a paddle at the bottom
(actions: 0 noop, 1 left, 2 right). Catching the ball gives +1, missing gives -1 and loses a
life; 3 missed balls end the episode. Frames are 3-channel uint8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class FakeEnv:
    num_actions = 3

    def __init__(self, num_envs: int, size: int = 64,
                 max_episode_steps: Optional[int] = 100) -> None:
        self.num_envs = num_envs
        self.size = size
        self.max_episode_steps = max_episode_steps
        b = num_envs
        self._ball = np.zeros((b, 2), np.int64)   # (y, x)
        self._vel = np.zeros((b, 2), np.int64)
        self._paddle = np.zeros(b, np.int64)      # x of paddle center
        self._lives = np.zeros(b, np.int64)
        self._t = np.zeros(b, np.int64)
        self._rng = np.random.default_rng(0)

    # -- internals -----------------------------------------------------------

    def _reset_idx(self, idx: np.ndarray) -> None:
        n = len(idx)
        s = self.size
        self._ball[idx, 0] = 2
        self._ball[idx, 1] = self._rng.integers(4, s - 4, n)
        self._vel[idx, 0] = 2
        self._vel[idx, 1] = np.where(self._rng.random(n) < 0.5, 2, -2)
        self._paddle[idx] = s // 2
        self._lives[idx] = 3
        self._t[idx] = 0

    def _render(self) -> np.ndarray:
        b, s = self.num_envs, self.size
        frame = np.zeros((b, s, s, 3), np.uint8)
        frame[..., 2] = 40  # background
        ar = np.arange(b)
        by, bx = self._ball[:, 0], self._ball[:, 1]
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                y = np.clip(by + dy, 0, s - 1)
                x = np.clip(bx + dx, 0, s - 1)
                frame[ar, y, x, 0] = 255
        py = s - 4
        for dx in range(-5, 6):
            x = np.clip(self._paddle + dx, 0, s - 1)
            frame[ar, py, x, 1] = 255
            frame[ar, py + 1, x, 1] = 255
        # lives indicator
        for i in range(3):
            on = (self._lives > i).astype(np.uint8) * 255
            frame[:, 1, 2 + 3 * i, :] = on[:, None]
        return frame

    # -- vector env API ------------------------------------------------------

    def reset(self, seed: Optional[Any] = None) -> Tuple[np.ndarray, Dict[str, Any]]:
        if seed is not None:
            seeds = seed if isinstance(seed, (list, tuple, np.ndarray)) else [seed]
            self._rng = np.random.default_rng(int(np.sum(seeds)))
        self._reset_idx(np.arange(self.num_envs))
        return self._render(), {}

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                 np.ndarray, Dict[str, Any]]:
        actions = np.asarray(actions)
        s = self.size
        self._t += 1
        self._paddle += np.where(actions == 1, -3, 0) + np.where(actions == 2, 3, 0)
        self._paddle = np.clip(self._paddle, 5, s - 6)

        self._ball += self._vel
        # bounce off side walls and ceiling
        hit_left = self._ball[:, 1] <= 2
        hit_right = self._ball[:, 1] >= s - 3
        self._vel[:, 1] = np.where(hit_left | hit_right, -self._vel[:, 1], self._vel[:, 1])
        self._ball[:, 1] = np.clip(self._ball[:, 1], 2, s - 3)
        hit_top = self._ball[:, 0] <= 2
        self._vel[:, 0] = np.where(hit_top, -self._vel[:, 0], self._vel[:, 0])
        self._ball[:, 0] = np.clip(self._ball[:, 0], 2, None)

        # paddle plane
        at_paddle = self._ball[:, 0] >= s - 5
        caught = at_paddle & (np.abs(self._ball[:, 1] - self._paddle) <= 6)
        missed = at_paddle & ~caught
        rew = caught.astype(np.float32) - missed.astype(np.float32)

        # ball returns upward on catch; respawn on miss
        self._vel[:, 0] = np.where(caught, -np.abs(self._vel[:, 0]), self._vel[:, 0])
        self._ball[:, 0] = np.where(at_paddle, np.where(caught, s - 6, 2), self._ball[:, 0])
        respawn = missed
        if respawn.any():
            idx = np.nonzero(respawn)[0]
            self._ball[idx, 1] = self._rng.integers(4, s - 4, len(idx))
            self._vel[idx, 0] = 2

        self._lives -= missed.astype(np.int64)
        end = self._lives <= 0
        trunc = np.zeros(self.num_envs, bool)
        if self.max_episode_steps is not None:
            trunc = (~end) & (self._t >= self.max_episode_steps)

        final_frame = self._render()
        dead = end | trunc
        info: Dict[str, Any] = {}
        if dead.any():
            info["final_observation"] = final_frame[dead]
            self._reset_idx(np.nonzero(dead)[0])  # autoreset, like gymnasium vector envs

        obs = self._render() if dead.any() else final_frame
        return obs, rew, end, trunc, info
