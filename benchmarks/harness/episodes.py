"""The cells' data: a store of synthetic episodes made on the device from the seed, the
way an Atari-100k run leaves its dataset (episode lengths 100 to 999, sparse rewards of
both signs, two episodes in three ending in a death with its true final frame, the
others truncated), and the plain gather of a segment from it, which the reference uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class Episodes:
    """A flat ring of ``steps`` steps and the host index of its episodes."""

    obs: torch.Tensor        # (N, H, W, C) uint8
    act: torch.Tensor        # (N,) int32
    rew: torch.Tensor        # (N,) float32
    end: torch.Tensor        # (N,) int32
    trunc: torch.Tensor      # (N,) int32
    final_obs: torch.Tensor  # (E, H, W, C) uint8, zeros where the episode has none
    offsets: np.ndarray      # (E,) int64
    lengths: np.ndarray      # (E,) int64
    has_final: np.ndarray    # (E,) bool

    # the interface of a dataset that a segment sampler reads
    @property
    def num_episodes(self) -> int:
        return len(self.lengths)

    @property
    def num_steps(self) -> int:
        return int(self.lengths.sum())


def make_episodes(steps: int, frame: Sequence[int], num_actions: int, seed: int,
                  device) -> Episodes:
    """``steps`` steps of synthetic episodes: the index from a numpy generator, the
    frames, actions and rewards from a torch generator on ``device``, both seeded with
    ``seed``."""
    rng = np.random.default_rng(seed)
    lengths: List[int] = []
    while sum(lengths) < steps:
        lengths.append(min(int(rng.integers(100, 1000)), steps - sum(lengths)))
    e = len(lengths)
    lengths_a = np.asarray(lengths, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths_a)[:-1]]).astype(np.int64)
    dies = (np.arange(e) % 3 < 2) & (np.arange(e) < e - 1)   # the last one still runs
    truncated = (np.arange(e) % 3 == 2) & (np.arange(e) < e - 1)
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    h, w, c = frame
    obs = torch.randint(0, 256, (steps, h, w, c), generator=g, device=device,
                        dtype=torch.uint8)
    act = torch.randint(0, num_actions, (steps,), generator=g, device=device,
                        dtype=torch.int32)
    u = torch.rand((steps,), generator=g, device=device)
    rew = torch.where(u < 0.02, -1.0, torch.where(u < 0.92, 0.0, torch.where(u < 0.98, 1.0, 3.0)))
    last = torch.from_numpy(offsets + lengths_a - 1).to(device)
    end = torch.zeros((steps,), dtype=torch.int32, device=device)
    trunc = torch.zeros((steps,), dtype=torch.int32, device=device)
    end[last[torch.from_numpy(dies).to(device)]] = 1
    trunc[last[torch.from_numpy(truncated).to(device)]] = 1
    final = torch.randint(0, 256, (e, h, w, c), generator=g, device=device, dtype=torch.uint8)
    final = final * torch.from_numpy(dies).to(device)[:, None, None, None]
    return Episodes(obs, act, rew.float(), end, trunc, final, offsets, lengths_a,
                    dies.copy())


def fill_store(store, ep: Episodes) -> None:
    """Point a ``DeviceEpisodeStore`` of ``ep.num_steps`` steps at the episodes' device
    tensors and set its host index, as a sync of these episodes would."""
    store.obs, store.act, store.rew, store.end, store.trunc = (ep.obs, ep.act, ep.rew,
                                                                ep.end, ep.trunc)
    e = ep.num_episodes
    store.final_obs[:e].copy_(ep.final_obs)
    store.ep_offset[:e] = ep.offsets
    store.ep_len[:e] = ep.lengths
    store.ep_has_final[:e] = ep.has_final
    store.next_free = ep.num_steps


def gather(ep: Episodes, ids) -> dict:
    """The batch of segments ``ids`` ((episode, start, stop) triples of one length):
    each position's step where it lies in its episode, zeros and a False mask where it
    does not, and each segment's episode's final frame where it has one."""
    b = len(ids)
    t = ids[0][2] - ids[0][1]
    idx = np.zeros((b, t), np.int64)
    valid = np.zeros((b, t), bool)
    eps = np.asarray([i[0] for i in ids], np.int64)
    for r, (e, start, stop) in enumerate(ids):
        pos = np.arange(start, stop)
        n = ep.lengths[e]
        valid[r] = (pos >= 0) & (pos < n)
        idx[r] = ep.offsets[e] + np.clip(pos, 0, n - 1)
    dev = ep.obs.device
    i = torch.from_numpy(idx).to(dev)
    m = torch.from_numpy(valid).to(dev)
    hf = torch.from_numpy(ep.has_final[eps]).to(dev)
    z = lambda x, mm: torch.where(mm, x, torch.zeros_like(x))  # noqa: E731
    return dict(obs=z(ep.obs[i], m[..., None, None, None]), act=z(ep.act[i], m),
                rew=z(ep.rew[i], m), end=z(ep.end[i], m), trunc=z(ep.trunc[i], m), mask=m,
                final_obs=z(ep.final_obs[torch.from_numpy(eps).to(dev)],
                            hf[:, None, None, None]),
                has_final_obs=hf)
