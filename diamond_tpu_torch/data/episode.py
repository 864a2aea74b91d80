"""Frame conversions (the tensor counterparts of diamond_tpu/data/episode.py:92-112)."""

from __future__ import annotations

import torch


def obs_to_float(obs_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return obs_uint8.float() / 255.0 * 2.0 - 1.0


def obs_to_uint8(obs_float: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8, rounding to nearest (half to even): the exact inverse of
    ``obs_to_float`` on the 256-level grid the world model's frames lie on."""
    return torch.round((torch.clamp(obs_float, -1.0, 1.0) + 1) / 2 * 255).to(torch.uint8)
