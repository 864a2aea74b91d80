"""The eval batches (diamond_tpu/data/traverser.py): every episode cut into windows of
``chunk_size`` steps, tails of one step dropped, the windows batched in order."""

from __future__ import annotations

import copy
import math
from typing import Generator

import numpy as np

from .dataset import Dataset
from .segment import Batch, SegmentId, collate_segments_to_batch, make_segment


class DatasetTraverser:
    """``pad_to_batch``: the last batch is filled up to ``batch_num_samples`` with fully
    masked copies of its last window, so every batch has one shape (the losses and
    confusion matrices weigh by the mask, so the copies count for nothing)."""

    def __init__(self, dataset: Dataset, batch_num_samples: int, chunk_size: int,
                 pad_to_batch: bool = False) -> None:
        self.dataset = dataset
        self.batch_num_samples = batch_num_samples
        self.chunk_size = chunk_size
        self.pad_to_batch = pad_to_batch

    def __len__(self) -> int:
        return math.ceil(sum(
            math.ceil(self.dataset.lengths[eid] / self.chunk_size)
            - int(self.dataset.lengths[eid] % self.chunk_size == 1)
            for eid in range(self.dataset.num_episodes)
        ) / self.batch_num_samples)

    def iter_batches_ids(self):
        """(segment_ids, masked_out) per batch: the index form of ``__iter__``, which
        ``DeviceEpisodeStore.make_batch`` takes as it is (``masked_out`` marks the
        ``pad_to_batch`` copies)."""
        cs = self.chunk_size
        chunks = []  # (SegmentId, masked_out)
        for episode_id in range(self.dataset.num_episodes):
            length = int(self.dataset.lengths[episode_id])
            for i in range(math.ceil(length / cs)):
                chunks.append((SegmentId(episode_id, i * cs, (i + 1) * cs), False))
            # drop a one-step tail; `length and` keeps an empty episode from judging the
            # previous episode's last window
            if length and chunks and min(length, chunks[-1][0].stop) - chunks[-1][0].start < 2:
                chunks.pop()
            while len(chunks) >= self.batch_num_samples:
                head = chunks[: self.batch_num_samples]
                chunks = chunks[self.batch_num_samples:]
                yield [c[0] for c in head], [c[1] for c in head]
        if chunks:
            if self.pad_to_batch:
                chunks = chunks + [(chunks[-1][0], True)] * (self.batch_num_samples
                                                             - len(chunks))
            yield [c[0] for c in chunks], [c[1] for c in chunks]

    def __iter__(self) -> Generator[Batch, None, None]:
        for ids, masked in self.iter_batches_ids():
            segments = []
            for sid, is_dummy in zip(ids, masked):
                seg = make_segment(self.dataset.load_episode(sid.episode_id), sid,
                                   should_pad=True)
                if is_dummy:
                    seg = copy.copy(seg)
                    seg.mask_padding = np.zeros_like(seg.mask_padding)
                segments.append(seg)
            yield collate_segments_to_batch(segments)
