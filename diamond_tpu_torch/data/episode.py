"""On-disk episode record (diamond_tpu/data/episode.py) and the frame conversions.

Frames are uint8 NHWC on disk, in RAM and in the device store; the train steps convert
them to float [-1, 1] on the device (``obs_to_float``). An episode is one ``.npz`` file
with the arrays ``obs``, ``act``, ``rew``, ``end``, ``trunc`` and ``info_<key>``, written
atomically through a ``.tmp.npz`` and a rename: the JAX package's format, so an episode
saved by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


@dataclass
class Episode:
    """Full-episode arrays of one length: obs uint8 (T, H, W, C), act int32 (T,), rew
    float32 (T,), end and trunc uint8 (T,). ``info`` may hold ``final_observation``
    (uint8 (H, W, C)), the true last frame of an episode that died, and other arrays."""

    obs: np.ndarray
    act: np.ndarray
    rew: np.ndarray
    end: np.ndarray
    trunc: np.ndarray
    info: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.obs.dtype != np.uint8:
            raise ValueError("Episode: obs must be uint8 [0, 255]")
        if not len(self.obs) == len(self.act) == len(self.rew) == len(self.end) == len(
                self.trunc):
            raise ValueError("Episode: obs, act, rew, end and trunc must have one length")

    def __len__(self) -> int:
        return len(self.obs)

    @property
    def dead(self) -> np.ndarray:
        return np.clip(self.end + self.trunc, None, 1)

    def __add__(self, other: "Episode") -> "Episode":
        """The concatenation, for an episode that spans two collections; ``self`` must
        not have died."""
        if self.dead.sum() != 0:
            raise ValueError("Episode: cannot extend an episode that has ended")
        return Episode(
            obs=np.concatenate([self.obs, other.obs]),
            act=np.concatenate([self.act, other.act]),
            rew=np.concatenate([self.rew, other.rew]),
            end=np.concatenate([self.end, other.end]),
            trunc=np.concatenate([self.trunc, other.trunc]),
            info=merge_info(self.info, other.info),
        )

    def compute_metrics(self) -> Dict[str, Any]:
        return {"length": len(self), "return": float(self.rew.sum())}

    @classmethod
    def load(cls, path: Path) -> "Episode":
        with np.load(Path(path), allow_pickle=False) as z:
            info = {k[len("info_"):]: z[k] for k in z.files if k.startswith("info_")}
            return cls(obs=z["obs"], act=z["act"], rew=z["rew"], end=z["end"],
                       trunc=z["trunc"], info=info)

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        arrays = {"obs": self.obs, "act": self.act, "rew": self.rew, "end": self.end,
                  "trunc": self.trunc}
        for k, v in self.info.items():
            arrays[f"info_{k}"] = np.asarray(v)
        np.savez(tmp, **arrays)
        tmp.rename(path)


def merge_info(info_a: Dict[str, Any], info_b: Dict[str, Any]) -> Dict[str, Any]:
    """The union of the keys; the arrays of a key both hold are concatenated."""
    keys_a, keys_b = set(info_a), set(info_b)
    common = keys_a & keys_b
    out = {k: info_a[k] for k in keys_a - common}
    out.update({k: info_b[k] for k in keys_b - common})
    out.update({k: np.concatenate([np.asarray(info_a[k]), np.asarray(info_b[k])])
                for k in common})
    return out


def obs_to_float(obs_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return obs_uint8.float() / 255.0 * 2.0 - 1.0


def obs_to_uint8(obs_float: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8, rounding to nearest (half to even): the exact inverse of
    ``obs_to_float`` on the 256-level grid the world model's frames lie on."""
    return torch.round((torch.clamp(obs_float, -1.0, 1.0) + 1) / 2 * 255).to(torch.uint8)
