"""The experience collector (diamond_tpu/coroutines/collector.py): drives the env loop
one step at a time, builds Episodes and writes them to the Dataset.

  * per-env transition buffers become an Episode when the env dies, with its
    ``final_observation`` in the episode's info;
  * in train mode (``reset_every_collect`` off) an episode still running when a
    collection stops is stored too, and extended at the next collection through
    ``dataset.add_episode(ep, episode_id=...)``; its buffer starts empty again, so no
    step is stored twice;
  * ``NumToCollect(steps=...)`` or ``(episodes=...)`` says when to stop;
  * logs: one row per finished episode (its id, return and length) and, at the stop,
    the dataset's size and reward/end counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.dataset import Dataset
from ..data.episode import Episode
from ..utils import Logs
from .env_loop import EnvLoop


@dataclass
class NumToCollect:
    steps: Optional[int] = None
    episodes: Optional[int] = None

    def __post_init__(self) -> None:
        assert (self.steps is None) != (self.episodes is None)

    def can_stop(self, num_steps: int, num_episodes: int) -> bool:
        if self.steps is not None:
            return num_steps >= self.steps
        return num_episodes >= self.episodes


class Collector:
    def __init__(self, env: Any, actor_critic: Any, dataset: Dataset, epsilon: float = 0.0,
                 reset_every_collect: bool = False, seed: Optional[int] = None,
                 verbose: bool = True, epsilon_per_env: bool = False) -> None:
        self.env = env
        self.dataset = dataset
        self.reset_every_collect = reset_every_collect
        self.verbose = verbose
        self._make_env_loop = lambda: EnvLoop(env, actor_critic, epsilon=epsilon, seed=seed,
                                              epsilon_per_env=epsilon_per_env)
        self.env_loop: Optional[EnvLoop] = None
        self._buffer: Dict[int, List] = {}
        self._episode_ids: Dict[int, Optional[int]] = {}

    def _reset(self) -> None:
        self.env_loop = self._make_env_loop()
        self._buffer = {i: [] for i in range(self.env.num_envs)}
        self._episode_ids = {i: None for i in range(self.env.num_envs)}

    def send(self, num_to_collect: NumToCollect) -> Logs:
        if self.env_loop is None:
            self._reset()
        num_envs = self.env.num_envs
        num_steps = 0
        num_episodes = 0
        to_log: Logs = []

        while True:
            obs, act, rew, end, trunc, *_, infos = self.env_loop.send(1, need_values=False)
            info = infos[0]
            num_steps += num_envs

            dead = np.clip(end[:, 0] + trunc[:, 0], None, 1).astype(bool)
            for i in range(num_envs):
                self._buffer[i].append(
                    (obs[i, 0], act[i, 0], rew[i, 0], end[i, 0], trunc[i, 0]))
            num_episodes += int(dead.sum())

            can_stop = num_to_collect.can_stop(num_steps, num_episodes)

            count_dead = 0
            for i in range(num_envs):
                add_to_dataset = dead[i] or (can_stop and not self.reset_every_collect)
                if add_to_dataset and self._buffer[i]:
                    ep_info = {}
                    if dead[i]:
                        ep_info["final_observation"] = info["final_observation"][count_dead]
                    ep = self._build_episode(self._buffer[i], ep_info)
                    if self._episode_ids[i] is not None:
                        ep = self.dataset.load_episode(self._episode_ids[i]) + ep
                    self._episode_ids[i] = self.dataset.add_episode(
                        ep, episode_id=self._episode_ids[i])
                    self._buffer[i] = []

                if dead[i]:
                    m = ep.compute_metrics()
                    to_log.append({f"{self.dataset.name}/episode_id": self._episode_ids[i],
                                   **m})
                    if self.verbose:
                        print(f"  [{self.dataset.name}] episode {self._episode_ids[i]}: "
                              f"return={m['return']:.1f} length={m['length']}")
                    self._buffer[i] = []
                    self._episode_ids[i] = None
                count_dead += int(dead[i])

            if can_stop:
                counts_rew = self.dataset.counts_rew
                counts_end = self.dataset.counts_end
                metrics = {
                    "num_steps": self.dataset.num_steps,
                    "counts/rew_-1": counts_rew[0],
                    "counts/rew__0": counts_rew[1],
                    "counts/rew_+1": counts_rew[2],
                    "counts/end_0": counts_end[0],
                    "counts/end_1": counts_end[1],
                }
                to_log.append({f"{self.dataset.name}/{k}": v for k, v in metrics.items()})
                if self.reset_every_collect:
                    self._reset()
                return to_log

    @staticmethod
    def _build_episode(buffer: List, info: Dict[str, Any]) -> Episode:
        obs, act, rew, end, trunc = (np.stack(x) for x in zip(*buffer))
        return Episode(obs=obs.astype(np.uint8), act=act.astype(np.int32),
                       rew=rew.astype(np.float32), end=end.astype(np.uint8),
                       trunc=trunc.astype(np.uint8), info=info)
