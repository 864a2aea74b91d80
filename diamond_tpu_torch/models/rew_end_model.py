"""Reward (3-class) + episode-end (2-class) predictor (diamond_tpu/models/rew_end_model.py).
Conv encoder over concat(obs, next_obs), FiLM-conditioned on an action embedding,
flattened HWC into an LSTM over time, two-layer head -> 5 logits split 3/2.

The training loss (``loss``): where a segment's episode died and its true last frame is
known, that frame replaces the padding frame after the death (a one-hot where-swap at
the first end); the reward targets are sign(rew) + 1; both cross-entropies are masked
by the padding and averaged over max(sum of the mask, 1); the confusion matrices weigh
each step by the mask. The JAX package recomputes the forward in the backward pass
(``jax.checkpoint``), a memory choice that leaves the numbers as they are; the port
keeps the forward's activations (the step's peak memory on the card is in PERF.md).

``calibrate`` installs the static int8 collection (ops/quant.py); the rollout's rew/end
step (envs/world_model_env.py) is the only caller that enters the int8 scope, so the
IC burn-in and everything else stay unquantized.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import RewEndModelConfig
from ..ops import quant
from ..utils import multiclass_confusion_matrix
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
        """Zeros, on ``device`` or else on the device of the net's parameters."""
        d = self.cfg.lstm_dim
        if device is None:
            device = self.net.head_2.kernel.device
        return (torch.zeros((batch, d), device=device), torch.zeros((batch, d), device=device))

    def predict_rew_end(self, obs: torch.Tensor, act: torch.Tensor, next_obs: torch.Tensor,
                        carry: Optional[Carry] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """Carry defaults to zeros."""
        if carry is None:
            carry = self.initial_carry(obs.shape[0], obs.device)
        return self.net(obs, act, next_obs, carry)

    def loss(self, batch_obs: torch.Tensor, batch_act: torch.Tensor, batch_rew: torch.Tensor,
             batch_end: torch.Tensor, batch_mask: torch.Tensor, final_obs: torch.Tensor,
             has_final_obs: torch.Tensor, count_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The masked cross-entropy training loss and its metrics (on the device, no
        graph): ``loss_rew``, ``loss_end``, ``loss_total`` and ``confusion_matrix``
        {"rew": (3, 3), "end": (2, 2)}, rows the true classes.

        batch_obs: (B, T, H, W, C) float [-1, 1]; batch_{act,rew,end,mask}: (B, T);
        final_obs: (B, H, W, C) float, the true last frame of each segment's episode;
        has_final_obs: (B,) bool, that frame is valid. count_mask: the (B', T) mask whose
        count the means divide by, ``batch_mask`` by default; under data parallelism the
        global batch's (this batch holds one rank's rows of it), so that the ranks'
        losses and confusion matrices sum to the global ones."""
        obs = batch_obs[:, :-1]
        act = batch_act[:, :-1]
        next_obs = batch_obs[:, 1:]
        rew = batch_rew[:, :-1]
        end = batch_end[:, :-1]
        mask = batch_mask[:, :-1]

        # where the segment died and its final frame is known, that frame replaces the
        # padding after the first end (argmax takes the first maximum)
        t = end.shape[1]
        dead = (end.int().sum(dim=1) > 0) & has_final_obs.bool()
        onehot = F.one_hot(end.int().argmax(dim=1), t).bool() & dead[:, None]
        next_obs = torch.where(onehot[:, :, None, None, None], final_obs[:, None].to(
            next_obs.dtype), next_obs)

        logits_rew, logits_end, _ = self.predict_rew_end(obs, act, next_obs)

        target_rew = torch.sign(rew).long() + 1  # {-1, 0, 1} -> {0, 1, 2}
        target_end = end.long()
        m = mask.float()
        count = m.sum() if count_mask is None else count_mask[:, :-1].float().sum()
        denom = count.clamp(min=1.0)

        def masked_ce(logits, targets):
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
            return (nll * m).sum() / denom

        loss_rew = masked_ce(logits_rew, target_rew)
        loss_end = masked_ce(logits_end, target_end)
        loss = loss_rew + loss_end
        metrics = {
            "loss_rew": loss_rew.detach(),
            "loss_end": loss_end.detach(),
            "loss_total": loss.detach(),
            "confusion_matrix": {
                "rew": multiclass_confusion_matrix(logits_rew.detach(), target_rew, 3, m),
                "end": multiclass_confusion_matrix(logits_end.detach(), target_end, 2, m),
            },
        }
        return loss, metrics

    @torch.no_grad()
    def calibrate(self, obs: torch.Tensor, act: torch.Tensor, next_obs: torch.Tensor,
                  sites=None, dp=None) -> dict:
        """Observe every site's input range over one ``predict_rew_end`` and install the
        "quant" collection in the net (a stale one is dropped first); returns it, {} when
        ``sites`` (``quant.parse_sites``) matches nothing. The LSTM's input range is taken
        over the whole sequence. ``dp`` (data parallelism: the frames are the rank's
        rows): each site's range is the max over the ranks."""
        sites = quant.parse_sites(sites)
        quant.strip(self.net)
        registry: dict = {}
        with quant.int8_scope(True), quant.calibration_scope(registry, self.net):
            self.predict_rew_end(obs, act, next_obs)
        if not registry:
            raise RuntimeError("calibration saw no quantizable sites")
        if dp is not None:
            quant.all_reduce_ranges(registry, dp)
        coll = quant.registry_to_collection(registry, sites)
        quant.install(self.net, coll)
        return coll
