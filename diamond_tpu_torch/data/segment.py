"""The device view of a batch of segments (diamond_tpu/data/segment.py ``DeviceBatch``),
as far as the ported train steps read it: the frames, the actions and the padding mask.
The rest of the data path (episodes, segment sampling, the device store) is not ported."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DeviceBatch:
    obs: torch.Tensor           # uint8 (B, T, H, W, C)
    act: torch.Tensor           # int (B, T)
    mask_padding: torch.Tensor  # bool (B, T): False where the segment was padded
