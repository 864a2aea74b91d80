"""A gymnasium-contract ALE double (diamond_tpu/envs/fake_ale.py), to run the Atari code
path without ale-py: ``env.unwrapped.ale`` with ``lives()`` and ``getScreenRGB``, a
210x160x3 uint8 screen, four actions, per-frame stepping, lives lost on a fixed schedule.

The screen is a constant image whose value is the frame counter (mod 251), plus a stripe
that shows the last action. gymnasium is imported when the class is first made
(``fake_ale_class``), never when this module is imported; ``register_fake_ale``
registers it under an id of this package's own, so the JAX package's registration of
the same double is not shared.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np

FAKE_ALE_ID = "DiamondTorch/FakeALENoFrameskip-v4"

_SCREEN_SHAPE = (210, 160, 3)


@functools.lru_cache(maxsize=None)
def fake_ale_class():
    """The FakeALE class (a gymnasium.Env)."""
    import gymnasium

    class _ALEShim:
        """The two methods AtariPreprocessing uses from the ALE interface."""

        def __init__(self, env) -> None:
            self._env = env

        def lives(self) -> int:
            return self._env._lives

        def getScreenRGB(self, buffer: np.ndarray) -> None:
            buffer[:] = self._env._screen()

    class FakeALE(gymnasium.Env):
        """Per raw frame: the counter moves on; reward +1 every ``reward_every`` frames,
        +1 more with action 1 every ``bonus_every``; a life lost every ``life_every``
        frames; the episode ends at 0 lives."""

        metadata = {"render_modes": ["rgb_array"]}

        def __init__(self, render_mode: Optional[str] = None, lives: int = 3,
                     life_every: int = 25, reward_every: int = 10, bonus_every: int = 7,
                     **kwargs: Any) -> None:
            super().__init__()
            self.observation_space = gymnasium.spaces.Box(0, 255, _SCREEN_SHAPE, np.uint8)
            self.action_space = gymnasium.spaces.Discrete(4)
            self.render_mode = render_mode
            self.ale = _ALEShim(self)
            self._start_lives = lives
            self._life_every = life_every
            self._reward_every = reward_every
            self._bonus_every = bonus_every
            self._frame = 0
            self._lives = lives
            self._last_action = 0

        def _screen(self) -> np.ndarray:
            img = np.full(_SCREEN_SHAPE, self._frame % 251, np.uint8)
            img[:8, :, self._last_action % 3] = 255
            return img

        def get_action_meanings(self):
            return ["NOOP", "FIRE", "RIGHT", "LEFT"]

        def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
            super().reset(seed=seed)
            self._frame = 0
            self._lives = self._start_lives
            self._last_action = 0
            return self._screen(), {"frame_number": 0}

        def step(self, action: int):
            self._frame += 1
            self._last_action = int(action)
            rew = float(self._frame % self._reward_every == 0)
            if int(action) == 1 and self._frame % self._bonus_every == 0:
                rew += 1.0
            if self._frame % self._life_every == 0:
                self._lives -= 1
            terminated = self._lives <= 0
            return self._screen(), rew, terminated, False, {"frame_number": self._frame}

    return FakeALE


def make_fake_ale(**kwargs: Any):
    """gymnasium's entry point: a FakeALE env."""
    return fake_ale_class()(**kwargs)


def register_fake_ale(**kwargs: Any) -> str:
    """Register FakeALE with gymnasium once; returns the id to make it by."""
    import gymnasium

    if FAKE_ALE_ID not in gymnasium.registry:
        gymnasium.register(id=FAKE_ALE_ID,
                           entry_point="diamond_tpu_torch.envs.fake_ale:make_fake_ale",
                           kwargs=kwargs)
    return FAKE_ALE_ID
