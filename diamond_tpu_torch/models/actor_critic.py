"""Recurrent actor-critic, inference half (diamond_tpu/models/actor_critic.py): conv
encoder -> LSTMCell -> zero-init actor/critic heads, exposed as ``encode`` (the conv
trunk) and ``head`` (LSTM step + heads) so the rollout can batch and carry encoder
features. ``loss_from_rollout`` and ``compute_lambda_returns`` come with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..config import ActorCriticConfig
from .blocks import Conv3x3, QDense, SmallResBlock
from .lstm import Carry, LSTMCell


class ActorCriticOutput(NamedTuple):
    logits_act: torch.Tensor
    val: torch.Tensor
    carry: Carry


class ActorCriticEncoder(nn.Module):
    """Conv3x3 then per-level SmallResBlock + 2x2 max-pool."""

    def __init__(self, cfg: ActorCriticConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.conv_in = Conv3x3(cfg.img_channels, cfg.channels[0], dtype)
        cur = cfg.channels[0]
        for i, ch in enumerate(cfg.channels):
            self.add_module(f"blocks_{i}", SmallResBlock(cur, ch, dtype))
            cur = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x.to(self.dtype))
        for i in range(len(self.cfg.channels)):
            x = getattr(self, f"blocks_{i}")(x)
            if self.cfg.down[i]:
                n, h, w, c = x.shape
                x = x[:, :h // 2 * 2, :w // 2 * 2].reshape(n, h // 2, 2, w // 2, 2, c)
                x = x.amax(dim=(2, 4))
        return x


class ActorCriticNet(nn.Module):
    def __init__(self, cfg: ActorCriticConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        feat = cfg.img_size // 2 ** sum(cfg.down)
        self.encoder = ActorCriticEncoder(cfg, dtype)
        self.lstm = LSTMCell(cfg.channels[-1] * feat * feat, cfg.lstm_dim, dtype)
        self.actor_linear = QDense(cfg.lstm_dim, cfg.num_actions, torch.float32, zero_init=True)
        self.critic_linear = QDense(cfg.lstm_dim, 1, torch.float32, zero_init=True)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        """obs: (B, H, W, C) float [-1, 1] -> flat HWC features (B, F)."""
        x = self.encoder(obs)
        return x.reshape(x.shape[0], -1)

    def head(self, feat: torch.Tensor, carry: Carry) -> ActorCriticOutput:
        carry, hx = self.lstm(carry, feat)
        return ActorCriticOutput(self.actor_linear(hx), self.critic_linear(hx)[:, 0], carry)


class ActorCritic:
    """Functional wrapper; the weights are those of ``self.net``."""

    def __init__(self, cfg: ActorCriticConfig, dtype: torch.dtype = torch.float32) -> None:
        self.cfg = cfg
        self.net = ActorCriticNet(cfg, dtype)

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        return self.net.encode(obs)

    def head(self, feat: torch.Tensor, carry: Carry) -> ActorCriticOutput:
        return self.net.head(feat, carry)
