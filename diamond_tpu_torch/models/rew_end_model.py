"""Reward (3-class) + episode-end (2-class) predictor, inference half
(diamond_tpu/models/rew_end_model.py). Conv encoder over concat(obs, next_obs),
FiLM-conditioned on an action embedding, flattened HWC into an LSTM over time, two-layer
head -> 5 logits split 3/2. The training loss comes with the training slice.

``calibrate`` installs the static int8 collection (ops/quant.py); the rollout's rew/end
step (envs/world_model_env.py) is the only caller that enters the int8 scope, so the
IC burn-in and everything else stay unquantized.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RewEndModelConfig
from ..ops import quant
from .blocks import Conv3x3, Downsample, Embed, QDense, ResBlocks
from .lstm import LSTM, Carry


class RewEndEncoder(nn.Module):
    """conv_in, per-level ResBlocks with Downsample between levels, plus a final attn
    ResBlocks pair."""

    def __init__(self, cfg: RewEndModelConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        cc = cfg.cond_channels
        self.conv_in = Conv3x3(2 * cfg.img_channels, cfg.channels[0], dtype)
        cur = cfg.channels[0]
        for i, (depth, ch) in enumerate(zip(cfg.depths, cfg.channels)):
            if i > 0:
                self.add_module(f"downsamples_{i}", Downsample(cur, dtype))
            self.add_module(f"blocks_{i}", ResBlocks([cur] + [ch] * (depth - 1), [ch] * depth,
                                                     cc, bool(cfg.attn_depths[i]), dtype))
            cur = ch
        last = cfg.channels[-1]
        self.add_module(f"blocks_{len(cfg.depths)}", ResBlocks([last] * 2, [last] * 2, cc,
                                                               True, dtype))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        n = len(self.cfg.depths)
        x = self.conv_in(x.to(self.dtype))
        for i in range(n + 1):
            if 0 < i < n:
                x = getattr(self, f"downsamples_{i}")(x)
            x, _ = getattr(self, f"blocks_{i}")(x, cond)
        return x


class RewEndNet(nn.Module):
    """The full network; ``forward`` runs a (B, T, ...) sequence."""

    def __init__(self, cfg: RewEndModelConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        feat = cfg.img_size // 2 ** (len(cfg.depths) - 1)
        self.act_emb = Embed(cfg.num_actions, cfg.cond_channels, dtype)
        self.encoder = RewEndEncoder(cfg, dtype)
        self.lstm = LSTM(cfg.channels[-1] * feat * feat, cfg.lstm_dim, dtype)
        self.head_0 = QDense(cfg.lstm_dim, cfg.lstm_dim, dtype, bias_fan_in=cfg.lstm_dim)
        self.head_2 = QDense(cfg.lstm_dim, 3 + 2, dtype, use_bias=False)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, next_obs: torch.Tensor,
                carry: Carry) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """obs/next_obs: (B, T, H, W, C) float [-1, 1]; act: (B, T) int.
        Returns (logits_rew (B, T, 3), logits_end (B, T, 2), new carry)."""
        b, t, h, w, c = obs.shape
        x = torch.cat([obs, next_obs], dim=-1).reshape(b * t, h, w, 2 * c)
        cond = self.act_emb(act.reshape(b * t))
        x = self.encoder(x, cond)
        x = x.reshape(b, t, -1).to(self.dtype)  # (b t) h w e -> b t (h w e)
        hs, carry = self.lstm(x, carry)
        y = self.head_2(F.silu(self.head_0(hs))).float()
        return y[..., :-2], y[..., -2:], carry


class RewEndModel:
    """Functional wrapper; the weights are those of ``self.net``."""

    def __init__(self, cfg: RewEndModelConfig, dtype: torch.dtype = torch.float32) -> None:
        self.cfg = cfg
        self.net = RewEndNet(cfg, dtype)

    def initial_carry(self, batch: int, device=None) -> Carry:
        d = self.cfg.lstm_dim
        return (torch.zeros((batch, d), device=device), torch.zeros((batch, d), device=device))

    def predict_rew_end(self, obs: torch.Tensor, act: torch.Tensor, next_obs: torch.Tensor,
                        carry: Optional[Carry] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """Carry defaults to zeros."""
        if carry is None:
            carry = self.initial_carry(obs.shape[0], obs.device)
        return self.net(obs, act, next_obs, carry)

    @torch.no_grad()
    def calibrate(self, obs: torch.Tensor, act: torch.Tensor, next_obs: torch.Tensor,
                  sites=None) -> dict:
        """Observe every site's input range over one ``predict_rew_end`` and install the
        "quant" collection in the net (a stale one is dropped first); returns it, {} when
        ``sites`` (``quant.parse_sites``) matches nothing. The LSTM's input range is taken
        over the whole sequence."""
        sites = quant.parse_sites(sites)
        quant.strip(self.net)
        registry: dict = {}
        with quant.int8_scope(True), quant.calibration_scope(registry, self.net):
            self.predict_rew_end(obs, act, next_obs)
        if not registry:
            raise RuntimeError("calibration saw no quantizable sites")
        coll = quant.registry_to_collection(registry, sites)
        quant.install(self.net, coll)
        return coll
