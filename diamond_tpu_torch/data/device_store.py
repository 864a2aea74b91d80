"""A device-resident mirror of the episode store (diamond_tpu/data/device_store.py):
batches assembled by gathers on the card.

The host ``Dataset`` stays the durable record. Its frames cross to the device once,
when an episode is added (``sync``); after that a training batch, or the imagination's
pool of conditioning windows (``gather_ic``), is one upload of its (B, T) indices and
masks, from pinned memory without waiting, and a gather on the device: no host-device
synchronisation. The batches equal ``make_segment`` + ``collate_segments_to_batch``
element for element: positions outside an episode are zeros with ``mask_padding``
False, and each segment's ``final_obs`` / ``has_final_obs`` are those of the host
collate.

Layout: a flat ring of steps (obs, act, rew, end, trunc over ``capacity_steps``) and a
table of each episode's final frame; the episode index (offsets, lengths) stays on the
host in numpy. An episode that grows (one still running when a collection ended) is
appended to in place where it is the ring's tail, else written anew at the tail, its
old region left as waste. When an upload would overflow the ring and waste can be
reclaimed, the live episodes are packed to the front by one gather on the device; if it
still does not fit, ``sync`` raises.

Data parallelism: the ring is replicated, as the JAX package's is on a mesh. Every rank
keeps a whole ring, synced from the same ``Dataset``; ``make_batch(..., dp)`` builds the
global batch's index arrays on every rank (identical, since the samplers share a seed)
and gathers only the rank's rows, with the global padding mask beside them.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import DataParallel
from ..utils import to_device
from .dataset import Dataset
from .segment import DeviceBatch, SegmentId


class DeviceEpisodeStore:
    """Append-mostly mirror of a host ``Dataset`` on ``device`` (the card unless the
    caller asks for another)."""

    def __init__(self, capacity_steps: int, img_size: Tuple[int, int, int],
                 max_episodes: int = 4096,
                 device: Union[str, torch.device] = "cuda") -> None:
        h, w, c = img_size
        self.device = torch.device(device)
        self.capacity = int(capacity_steps)
        self.max_episodes = int(max_episodes)
        dev = dict(device=self.device)
        self.obs = torch.zeros((self.capacity, h, w, c), dtype=torch.uint8, **dev)
        self.act = torch.zeros((self.capacity,), dtype=torch.int32, **dev)
        self.rew = torch.zeros((self.capacity,), dtype=torch.float32, **dev)
        self.end = torch.zeros((self.capacity,), dtype=torch.int32, **dev)
        self.trunc = torch.zeros((self.capacity,), dtype=torch.int32, **dev)
        self.final_obs = torch.zeros((self.max_episodes, h, w, c), dtype=torch.uint8, **dev)

        # the host-side index
        self.ep_offset = np.full(self.max_episodes, -1, np.int64)
        self.ep_len = np.zeros(self.max_episodes, np.int64)
        self.ep_has_final = np.zeros(self.max_episodes, bool)
        self.next_free = 0
        self._lock = threading.Lock()  # a pool built on another thread may sync too
        self.waste_steps = 0        # orphaned by relocations since the last compaction
        self.compactions = 0

    # -- append / sync ---------------------------------------------------------

    def _upload_steps(self, offset: int, obs: np.ndarray, act: np.ndarray, rew: np.ndarray,
                      end: np.ndarray, trunc: np.ndarray) -> None:
        n = len(obs)
        if offset + n > self.capacity:
            raise RuntimeError(f"device episode store overflow ({offset + n} > "
                               f"{self.capacity} steps); give it a larger capacity")
        for ring, x, dt in ((self.obs, obs, np.uint8), (self.act, act, np.int32),
                            (self.rew, rew, np.float32), (self.end, end, np.int32),
                            (self.trunc, trunc, np.int32)):
            ring[offset:offset + n].copy_(torch.from_numpy(np.ascontiguousarray(x, dt)))

    def _ensure_room(self, needed: int, grow_ep: Optional[int] = None) -> None:
        """Compact the ring where an upload of ``needed`` steps would overflow it but
        orphaned regions can be reclaimed: one permutation gather on the device, no
        frames from the host.

        ``grow_ep``: the episode about to be synced again. Where another live episode
        lies above it, its region is orphaned by the relocation that follows, so the pack
        drops it now (and the whole episode is written anew). Where it is the top live
        episode, it is packed last and stays the tail, so only its new steps are
        uploaded."""
        if self.next_free + needed <= self.capacity:
            return
        live = sorted((int(self.ep_offset[e]), e) for e in range(self.max_episodes)
                      if self.ep_offset[e] >= 0 and self.ep_len[e] > 0)
        drop_grow = (grow_ep is not None and live and live[-1][1] != grow_ep
                     and int(self.ep_offset[grow_ep]) >= 0
                     and int(self.ep_len[grow_ep]) > 0)
        reclaimable = self.waste_steps + (int(self.ep_len[grow_ep]) if drop_grow else 0)
        if reclaimable == 0:
            return
        if drop_grow:
            live = [(off, e) for off, e in live if e != grow_ep]
        perm = np.arange(self.capacity, dtype=np.int64)  # the identity on the free tail
        pos = 0
        new_offsets = []
        for off, e in live:
            n = int(self.ep_len[e])
            perm[pos:pos + n] = np.arange(off, off + n)
            new_offsets.append((e, pos))
            pos += n
        if pos < self.next_free:
            perm_d = torch.from_numpy(perm).to(self.device)
            self.obs, self.act, self.rew, self.end, self.trunc = (
                r[perm_d] for r in (self.obs, self.act, self.rew, self.end, self.trunc))
            for e, off in new_offsets:
                self.ep_offset[e] = off
            if drop_grow:
                self.ep_offset[grow_ep] = -1  # its region went in this pack
                self.ep_len[grow_ep] = 0      # the caller uploads the whole episode
            self.next_free = pos
            self.waste_steps = 0
            self.compactions += 1

    def sync(self, dataset: Dataset) -> None:
        """Mirror the dataset's new and extended episodes (nothing to do where nothing
        changed)."""
        with self._lock:
            for ep_id in range(dataset.num_episodes):
                length = int(dataset.lengths[ep_id])
                if ep_id >= self.max_episodes:
                    raise RuntimeError("device episode store: max_episodes exceeded")
                have = int(self.ep_len[ep_id])
                if length == have:
                    continue
                ep = dataset.load_episode(ep_id)
                # at worst the whole episode is uploaded again; a compaction may drop this
                # episode's region (grow_ep), so its state is read again after
                self._ensure_room(length if self.ep_offset[ep_id] < 0
                                  or self.ep_offset[ep_id] + have != self.next_free
                                  else length - have, grow_ep=ep_id)
                have = int(self.ep_len[ep_id])
                if self.ep_offset[ep_id] >= 0 and \
                        self.ep_offset[ep_id] + have == self.next_free:
                    # the tail episode grew: append its new steps only
                    self._upload_steps(self.next_free, ep.obs[have:], ep.act[have:],
                                       ep.rew[have:], ep.end[have:], ep.trunc[have:])
                    self.next_free += length - have
                else:  # a new episode, or one below the tail grew: write it at the tail
                    if self.ep_offset[ep_id] >= 0:
                        self.waste_steps += have  # its old region is orphaned
                    self._upload_steps(self.next_free, ep.obs, ep.act, ep.rew, ep.end,
                                       ep.trunc)
                    self.ep_offset[ep_id] = self.next_free
                    self.next_free += length
                self.ep_len[ep_id] = length

                fo = ep.info.get("final_observation")
                if fo is not None and np.asarray(fo).shape == tuple(self.obs.shape[1:]):
                    self.final_obs[ep_id].copy_(torch.from_numpy(np.asarray(fo, np.uint8)))
                    self.ep_has_final[ep_id] = True
                else:
                    self.ep_has_final[ep_id] = False

    # -- batch assembly --------------------------------------------------------

    def _index_arrays(self, segment_ids: List[SegmentId],
                      masked_out: Optional[List[bool]] = None) -> np.ndarray:
        """One int64 array of B * (2T + 2): the ring index of every window position, its
        padding mask, each segment's episode id and its has_final flag."""
        b = len(segment_ids)
        t = segment_ids[0].stop - segment_ids[0].start
        idx = np.zeros((b, t), np.int64)
        mask = np.zeros((b, t), np.int64)
        ep_idx = np.zeros((b,), np.int64)
        has_final = np.zeros((b,), np.int64)
        for i, sid in enumerate(segment_ids):
            if sid.stop - sid.start != t:
                raise ValueError("DeviceEpisodeStore: the segments of a batch must share a "
                                 "length")
            length = int(self.ep_len[sid.episode_id])
            off = int(self.ep_offset[sid.episode_id])
            if off < 0:
                raise KeyError(f"episode {sid.episode_id} is not in the device store")
            pos = np.arange(sid.start, sid.stop)
            valid = (pos >= 0) & (pos < length)
            if masked_out is not None and masked_out[i]:
                valid = np.zeros_like(valid)  # a pad_to_batch copy counts for nothing
            idx[i] = off + np.clip(pos, 0, max(0, length - 1))
            mask[i] = valid
            ep_idx[i] = sid.episode_id
            has_final[i] = self.ep_has_final[sid.episode_id]
        return np.concatenate([idx.ravel(), mask.ravel(), ep_idx, has_final])

    def make_batch(self, segment_ids: List[SegmentId],
                   masked_out: Optional[List[bool]] = None,
                   dp: Optional[DataParallel] = None) -> DeviceBatch:
        """The ``DeviceBatch`` of the given windows (``[make_segment ...]`` then
        ``collate_segments_to_batch``), gathered on the device; ``masked_out`` marks
        windows whose mask is all False (the traverser's padding copies). With a
        data-parallel ``dp`` that issues collectives, the windows are the global batch:
        this rank's rows of it, and its whole mask as ``mask_global``."""
        b = len(segment_ids)
        t = segment_ids[0].stop - segment_ids[0].start
        with self._lock:
            host = self._index_arrays(segment_ids, masked_out)
            dev = to_device(host, self.device)
            idx, mask, ep_idx, has_final = dev.split([b * t, b * t, b, b])
            mask_global = mask.view(b, t).bool()
            sharded = dp is not None and dp.active
            take = dp.take if sharded else (lambda x: x)
            idx, m = take(idx.view(b, t)), take(mask_global)
            ep_idx, hf = take(ep_idx), take(has_final.bool())
            return DeviceBatch(
                obs=torch.where(m[..., None, None, None], self.obs[idx], 0),
                act=torch.where(m, self.act[idx], 0),
                rew=torch.where(m, self.rew[idx], 0.0),
                end=torch.where(m, self.end[idx], 0),
                trunc=torch.where(m, self.trunc[idx], 0),
                mask_padding=m,
                final_obs=torch.where(hf[:, None, None, None], self.final_obs[ep_idx], 0),
                has_final_obs=hf,
                mask_global=mask_global if sharded else None,
            )

    def gather_ic(self, segment_ids: List[SegmentId]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(obs (B, T, H, W, C) uint8, act (B, T) int32) of conditioning windows that lie
        inside their episodes (the imagination's pool)."""
        db = self.make_batch(segment_ids)
        return db.obs, db.act


class StoreBatchIterator:
    """Batches of the sampler's segment ids, sampled on the host and gathered on the
    device; the gather is queued work, so no thread is needed. ``dp``: this rank's rows
    of each global batch."""

    def __init__(self, store: DeviceEpisodeStore, sampler,
                 dp: Optional[DataParallel] = None) -> None:
        self.store = store
        self.sampler = sampler
        self.dp = dp

    def __iter__(self):
        return self

    def __next__(self) -> DeviceBatch:
        return self.store.make_batch(self.sampler.sample(), dp=self.dp)
