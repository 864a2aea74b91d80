"""Segment addressing, padded windows and batches (diamond_tpu/data/segment.py).

A ``Segment`` is a window of an episode, zero-padded where it reaches before the start
or past the end, with ``mask_padding`` False there. ``collate_segments_to_batch``
stacks segments into a numpy ``Batch`` and makes each segment's ``final_observation``
(the true last frame of an episode that died, which the rew/end loss swaps in) a dense
(B, H, W, C) array with a ``has_final_obs`` flag. ``DeviceBatch`` holds the dense
arrays as tensors on one device; frames stay uint8 until the train step converts them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .episode import Episode


@dataclass(frozen=True)
class SegmentId:
    """A window [start, stop) of episode ``episode_id``; start and stop may lie outside
    the episode, where the window is padded and masked."""

    episode_id: int
    start: int
    stop: int


@dataclass
class Segment:
    obs: np.ndarray  # uint8 (T, H, W, C)
    act: np.ndarray
    rew: np.ndarray
    end: np.ndarray
    trunc: np.ndarray
    mask_padding: np.ndarray  # bool (T,)
    info: Dict[str, Any]
    id: SegmentId

    @property
    def effective_size(self) -> int:
        return int(self.mask_padding.sum())


@dataclass
class Batch:
    """Stacked segments in numpy, with ``final_observation`` made dense."""

    obs: np.ndarray            # uint8 (B, T, H, W, C)
    act: np.ndarray            # int32 (B, T)
    rew: np.ndarray            # float32 (B, T)
    end: np.ndarray            # int32 (B, T)
    trunc: np.ndarray          # int32 (B, T)
    mask_padding: np.ndarray   # bool (B, T)
    final_obs: np.ndarray      # uint8 (B, H, W, C); zeros when absent
    has_final_obs: np.ndarray  # bool (B,)
    info: List[Dict[str, Any]] = field(default_factory=list)
    segment_ids: List[SegmentId] = field(default_factory=list)


@dataclass
class DeviceBatch:
    """The dense arrays of a ``Batch`` as tensors on one device (the segments' info and
    ids stay on the host). Under data parallelism a batch holds one rank's rows of the
    global batch, and ``mask_global`` the global batch's whole padding mask (the losses
    divide by its counts); elsewhere it is None."""

    obs: torch.Tensor            # uint8 (B, T, H, W, C)
    act: torch.Tensor            # int32 (B, T)
    rew: torch.Tensor            # float32 (B, T)
    end: torch.Tensor            # int32 (B, T)
    trunc: torch.Tensor          # int32 (B, T)
    mask_padding: torch.Tensor   # bool (B, T): False where the segment was padded
    final_obs: torch.Tensor      # uint8 (B, H, W, C)
    has_final_obs: torch.Tensor  # bool (B,)
    mask_global: Optional[torch.Tensor] = None  # bool (world * B, T)

    @classmethod
    def from_batch(cls, batch: Batch, device: Union[str, torch.device] = "cuda"
                   ) -> "DeviceBatch":
        """The batch's arrays copied to ``device`` (the card unless the caller asks for
        another), dtypes unchanged."""
        return cls(**{name: torch.from_numpy(np.ascontiguousarray(getattr(batch, name)))
                      .to(device) for name in DENSE_FIELDS})


# the dense arrays a Batch and a DeviceBatch share
DENSE_FIELDS = tuple(f.name for f in fields(DeviceBatch) if f.name != "mask_global")


def make_segment(episode: Episode, segment_id: SegmentId, should_pad: bool = True) -> Segment:
    """The window of ``segment_id``, zero-padded outside the episode, with its padding
    mask; the id it carries is clipped to the episode."""
    if not (segment_id.start < len(episode) and segment_id.stop > 0
            and segment_id.start < segment_id.stop):
        raise ValueError(f"make_segment: {segment_id} does not overlap an episode of "
                         f"{len(episode)} steps")
    pad_right = max(0, segment_id.stop - len(episode))
    pad_left = max(0, -segment_id.start)
    if (pad_left or pad_right) and not should_pad:
        raise ValueError(f"make_segment: {segment_id} needs padding")

    start = max(0, segment_id.start)
    stop = min(len(episode), segment_id.stop)

    def pad(x: np.ndarray) -> np.ndarray:
        widths = [(pad_left, pad_right)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x[start:stop], widths)

    mask = np.concatenate([
        np.zeros(pad_left, bool), np.ones(stop - start, bool), np.zeros(pad_right, bool)])

    return Segment(
        obs=pad(episode.obs),
        act=pad(episode.act),
        rew=pad(episode.rew),
        end=pad(episode.end),
        trunc=pad(episode.trunc),
        mask_padding=mask,
        info=episode.info,
        id=SegmentId(segment_id.episode_id, start, stop),
    )


def collate_segments_to_batch(segments: List[Segment]) -> Batch:
    """Stack the segments; ``final_obs`` holds each segment's ``final_observation`` where
    its info has one of the frames' shape (``has_final_obs``), zeros elsewhere."""
    obs = np.stack([s.obs for s in segments])
    h, w, c = obs.shape[2:]
    final_obs = np.zeros((len(segments), h, w, c), np.uint8)
    has_final = np.zeros(len(segments), bool)
    for i, s in enumerate(segments):
        fo = s.info.get("final_observation")
        if fo is not None and np.asarray(fo).shape == (h, w, c):
            final_obs[i] = fo
            has_final[i] = True
    return Batch(
        obs=obs,
        act=np.stack([s.act for s in segments]).astype(np.int32),
        rew=np.stack([s.rew for s in segments]).astype(np.float32),
        end=np.stack([s.end for s in segments]).astype(np.int32),
        trunc=np.stack([s.trunc for s in segments]).astype(np.int32),
        mask_padding=np.stack([s.mask_padding for s in segments]),
        final_obs=final_obs,
        has_final_obs=has_final,
        info=[s.info for s in segments],
        segment_ids=[s.id for s in segments],
    )
