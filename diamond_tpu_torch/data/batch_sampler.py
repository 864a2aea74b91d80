"""The weighted segment sampler (diamond_tpu/data/batch_sampler.py), on an explicit
``np.random.Generator``: the same generator state draws the same ``SegmentId``s as the
JAX package's sampler.

  * with fewer episodes than buckets (or no weights), episodes are drawn in proportion
    to their length;
  * otherwise the episode ids split into ``len(sample_weights)`` equal recency buckets
    (the remainder to the newest) and an episode weighs its bucket's weight over the
    bucket's size;
  * rank r of ``world_size`` owns episode ids r, r + world_size, ...;
  * the window is uniform over the windows that hold a uniform timestep: ending at the
    episode's end at the latest (padded before the start only), or anywhere with
    ``can_sample_beyond_end`` (the rew/end model trains on the padding after a death).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .dataset import Dataset
from .segment import SegmentId


def _bucket_weights(num_episodes: int, bucket_w: List[float]) -> np.ndarray:
    """Per-episode weights from the recency buckets' weights."""
    if min(bucket_w) < 0 or max(bucket_w) > 1 or abs(sum(bucket_w) - 1) >= 1e-9:
        raise ValueError(f"BatchSampler: sample weights {bucket_w} are not a distribution")
    n_buckets = len(bucket_w)
    base = num_episodes // n_buckets
    sizes = np.full(n_buckets, base, dtype=np.int64)
    sizes[-1] += num_episodes - base * n_buckets
    return np.repeat(np.asarray(bucket_w) / sizes, sizes)


class BatchSampler:
    def __init__(self, dataset: Dataset, rank: int, world_size: int, batch_size: int,
                 seq_length: int, sample_weights: Optional[List[float]] = None,
                 can_sample_beyond_end: bool = False,
                 seed: Optional[int] = None) -> None:
        self.dataset = dataset
        self.rank = rank
        self.world_size = world_size
        self.sample_weights = sample_weights
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.can_sample_beyond_end = can_sample_beyond_end
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            yield self.sample()

    def _episode_weights(self) -> np.ndarray:
        n = self.dataset.num_episodes
        if self.sample_weights is None or n < len(self.sample_weights):
            return self.dataset.lengths / self.dataset.num_steps
        return _bucket_weights(n, self.sample_weights)

    def _draw_episodes(self) -> np.ndarray:
        """batch_size episode ids of this rank's share, recency-weighted."""
        mine = np.arange(self.rank, self.dataset.num_episodes, self.world_size)
        w = self._episode_weights()[mine]
        return self.rng.choice(mine, size=self.batch_size, p=w / w.sum())

    def _window_bounds(self, ep_len: np.ndarray):
        """(start, stop) arrays of seq_length windows around a uniform timestep each."""
        t = self.rng.integers(0, ep_len)
        offset = self.rng.integers(0, self.seq_length, size=t.shape)
        if self.can_sample_beyond_end:
            starts = t - offset
            return starts, starts + self.seq_length
        stops = np.minimum(ep_len, t + 1 + offset)
        return stops - self.seq_length, stops

    def sample(self) -> List[SegmentId]:
        if self.dataset.num_episodes == 0:
            raise RuntimeError("BatchSampler: cannot sample from an empty dataset")
        eps = self._draw_episodes()
        starts, stops = self._window_bounds(self.dataset.lengths[eps])
        return [SegmentId(int(e), int(a), int(b)) for e, a, b in zip(eps, starts, stops)]
