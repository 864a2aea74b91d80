"""The on-disk episode store with resumable counters (diamond_tpu/data/dataset.py).

Episodes live under a three-level decimal-bucket tree keyed by episode id (episode 1234
is ``200/30/4/1234.npz``); the index (episode start offsets and lengths) and the reward
and end class histograms are the resume state, pickled to ``info.pt``. The layout, the
files and the state dict are the JAX package's, so a dataset written by either package
loads in the other.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import load_pickle, save_with_backup
from .episode import Episode
from .segment import Segment, SegmentId, make_segment

_REW_CLASSES = 3  # sign(reward) in {-1, 0, +1}, stored at bins {0, 1, 2}
_END_CLASSES = 2


def _rew_histogram(rew: np.ndarray) -> np.ndarray:
    return np.bincount(np.sign(rew).astype(np.int64) + 1, minlength=_REW_CLASSES)


def _end_histogram(end: np.ndarray) -> np.ndarray:
    return np.bincount(np.asarray(end, dtype=np.int64), minlength=_END_CLASSES)


class Dataset:
    """Episode store. State: the index arrays and the histograms; content: the episode
    files (and, with ``cache_in_ram``, the loaded episodes)."""

    def __init__(self, directory: Path, name: Optional[str] = None,
                 cache_in_ram: bool = False, save_on_disk: bool = True) -> None:
        self._directory = Path(directory).expanduser()
        self._name = name if name is not None else self._directory.stem
        self._cache_in_ram = cache_in_ram
        self._save_on_disk = save_on_disk
        self._default_path = self._directory / "info.pt"
        self._cache: Dict[int, Episode] = {}
        self.is_static = False
        self._reset()

    def _reset(self) -> None:
        self.start_idx = np.empty(0, dtype=np.int64)
        self.lengths = np.empty(0, dtype=np.int64)
        self._rew_hist = np.zeros(_REW_CLASSES, dtype=np.int64)
        self._end_hist = np.zeros(_END_CLASSES, dtype=np.int64)
        self._cache.clear()

    @property
    def num_episodes(self) -> int:
        return len(self.lengths)

    @property
    def num_steps(self) -> int:
        return int(self.lengths.sum())

    @property
    def counts_rew(self) -> List[int]:
        """[count(rew < 0), count(rew == 0), count(rew > 0)]."""
        return self._rew_hist.tolist()

    @property
    def counts_end(self) -> List[int]:
        return self._end_hist.tolist()

    def __len__(self) -> int:
        return self.num_steps

    def __str__(self) -> str:
        return f"{self.name}: {self.num_episodes} episodes, {self.num_steps} steps."

    @property
    def name(self) -> str:
        return self._name

    def __getitem__(self, segment_id: SegmentId) -> Segment:
        return make_segment(self.load_episode(segment_id.episode_id), segment_id,
                            should_pad=True)

    def load_episode(self, episode_id: int) -> Episode:
        cached = self._cache.get(episode_id)
        if cached is not None:
            return cached
        episode = Episode.load(self._get_episode_path(episode_id))
        if self._cache_in_ram:
            self._cache[episode_id] = episode
        return episode

    def add_episode(self, episode: Episode, *, episode_id: Optional[int] = None) -> int:
        """Append a new episode, or swap in a longer version of episode ``episode_id``
        (one still running when a collection ended); the index and the histograms move
        by the difference."""
        self.assert_not_static()
        if episode_id is None:
            episode_id = self._append_index_entry(len(episode))
        else:
            self._update_index_entry(episode_id, episode)
        self._rew_hist += _rew_histogram(np.asarray(episode.rew))
        self._end_hist += _end_histogram(np.asarray(episode.end))

        if self._save_on_disk:
            episode.save(self._get_episode_path(episode_id))
        if self._cache_in_ram:
            self._cache[episode_id] = episode
        return episode_id

    def _append_index_entry(self, length: int) -> int:
        episode_id = self.num_episodes
        self.start_idx = np.append(self.start_idx, self.num_steps)
        self.lengths = np.append(self.lengths, length)
        return episode_id

    def _update_index_entry(self, episode_id: int, episode: Episode) -> None:
        if episode_id >= self.num_episodes:
            raise ValueError(f"Dataset: no episode {episode_id} to extend")
        replaced = self.load_episode(episode_id)
        self._rew_hist -= _rew_histogram(np.asarray(replaced.rew))
        self._end_hist -= _end_histogram(np.asarray(replaced.end))
        growth = len(episode) - len(replaced)
        self.lengths[episode_id] += growth
        self.start_idx[episode_id + 1:] += growth

    def clear(self) -> None:
        self.assert_not_static()
        if self._directory.is_dir():
            shutil.rmtree(self._directory)
        self._reset()

    def assert_not_static(self) -> None:
        if self.is_static:
            raise RuntimeError("Trying to modify a static dataset.")

    def _get_episode_path(self, episode_id: int) -> Path:
        """Decimal buckets over the last three digits of the id: episode 1234 lands in
        200/30/4/1234.npz."""
        h, t, u = f"{episode_id % 1000:03d}"
        return self._directory / f"{h}00" / f"{t}0" / u / f"{episode_id}.npz"

    def state_dict(self) -> Dict[str, Any]:
        return {
            "is_static": self.is_static,
            "start_idx": self.start_idx,
            "lengths": self.lengths,
            "rew_hist": self._rew_hist,
            "end_hist": self._end_hist,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.is_static = sd.get("is_static", False)
        self.start_idx = np.asarray(sd["start_idx"], dtype=np.int64)
        self.lengths = np.asarray(sd["lengths"], dtype=np.int64)
        if "rew_hist" in sd:
            self._rew_hist = np.asarray(sd["rew_hist"], dtype=np.int64)
            self._end_hist = np.asarray(sd["end_hist"], dtype=np.int64)
        else:  # the older state dicts carried Counters of the rewards and ends
            cr, ce = sd["counter_rew"], sd["counter_end"]
            self._rew_hist = np.array([cr.get(r, 0) for r in (-1, 0, 1)], dtype=np.int64)
            self._end_hist = np.array([ce.get(e, 0) for e in (0, 1)], dtype=np.int64)
        self._cache.clear()

    def save_to_default_path(self) -> None:
        self._default_path.parent.mkdir(exist_ok=True, parents=True)
        save_with_backup(self.state_dict(), self._default_path)

    def load_from_default_path(self) -> None:
        if self._default_path.is_file():
            self.load_state_dict(load_pickle(self._default_path))
