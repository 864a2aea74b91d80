"""Read-only episode browser with the play env's interface (diamond_tpu/game/dataset_env.py):
step through recorded episodes frame by frame, jump between episodes and datasets, in
the same Game loop. The moves the keys make are methods too (``next_episode``,
``next_dataset``, ``rewind``), so that the browser runs without pygame."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..data.dataset import Dataset


class DatasetEnv:
    def __init__(self, datasets: List[Dataset], keymap_name: str = "fake") -> None:
        assert len(datasets) > 0
        self.datasets = [d for d in datasets if d.num_episodes > 0]
        assert self.datasets, "no non-empty datasets to browse"
        self.ds_idx = 0
        self.ep_idx = 0
        self.t = 0
        self.keymap_name = keymap_name
        self._episode = None

    @property
    def dataset(self) -> Dataset:
        return self.datasets[self.ds_idx]

    def keymap_and_names(self):
        from .keymap import get_keymap_and_action_names
        return get_keymap_and_action_names(self.keymap_name)

    def _load(self) -> None:
        self._episode = self.dataset.load_episode(self.ep_idx)
        self.t = 0

    def reset(self) -> Tuple[np.ndarray, Dict]:
        self._load()
        return self._episode.obs[0], {}

    def step(self, act: int) -> Tuple[np.ndarray, float, bool, bool, Dict[str, Any]]:
        self.t = min(self.t + 1, len(self._episode) - 1)
        ep = self._episode
        i = self.t
        end = bool(ep.end[i]) or i == len(ep) - 1
        return ep.obs[i], float(ep.rew[i]), end, bool(ep.trunc[i]), {}

    def next_episode(self, step: int = 1) -> None:
        """The episode ``step`` after (before, if negative) this one, from its start."""
        self.ep_idx = (self.ep_idx + step) % self.dataset.num_episodes
        self._load()

    def next_dataset(self) -> None:
        self.ds_idx = (self.ds_idx + 1) % len(self.datasets)
        self.ep_idx = 0
        self._load()

    def rewind(self) -> None:
        self.t = max(0, self.t - 2)  # step() advances by one

    def key_handler(self, key: int) -> None:
        import pygame

        if key in (pygame.K_PAGEUP, pygame.K_RIGHTBRACKET):
            self.next_episode(1)
        elif key in (pygame.K_PAGEDOWN, pygame.K_LEFTBRACKET):
            self.next_episode(-1)
        elif key == pygame.K_TAB:
            self.next_dataset()
        elif key == pygame.K_LEFT:
            self.rewind()

    def header_lines(self) -> List[str]:
        ep = self._episode
        return [
            f"dataset: {self.dataset.name} ({self.dataset.num_episodes} episodes) (Tab)",
            f"episode {self.ep_idx}: t={self.t}/{len(ep) - 1} "
            f"return={float(ep.rew.sum()):.1f}",
            "[ ] prev/next episode | Left rewind | . pause | e step | Esc quit",
        ]

    def render_frame(self, obs: np.ndarray) -> np.ndarray:
        return obs
