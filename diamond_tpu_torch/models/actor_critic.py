"""Recurrent actor-critic (diamond_tpu/models/actor_critic.py): conv encoder -> LSTMCell
-> zero-init actor/critic heads, exposed as ``encode`` (the conv trunk) and ``head``
(LSTM step + heads) so the rollout can batch and carry encoder features, and the
REINFORCE-with-baseline loss on lambda-returns (``loss_from_rollout``,
``compute_lambda_returns``).

The encoder's 2x2 max-pool gives each window's gradient to its first maximum in
row-major order, as flax's ``nn.max_pool`` does (``F.max_pool2d``; ``amax`` would split
it among tied maxima, which bf16 activations often hold).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ActorCriticConfig, ActorCriticLossConfig
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
            if self.cfg.down[i]:  # on the channels-last view; the output is NHWC-contiguous
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
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

    def loss_from_rollout(self, act: torch.Tensor, rew: torch.Tensor, end: torch.Tensor,
                          trunc: torch.Tensor, logits_act: torch.Tensor, val: torch.Tensor,
                          val_bootstrap: torch.Tensor, loss_cfg: ActorCriticLossConfig,
                          count: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """REINFORCE with baseline on lambda-returns. All inputs (B, T) but logits_act
        (B, T, A); the gradient flows through logits_act and val only. The means are over
        ``count`` elements (B * T by default; under data parallelism the global batch's B *
        T, so that the ranks' losses sum to the global mean). The metrics stay on the
        device."""
        c = loss_cfg
        share = 1.0 if count is None else rew.numel() / count

        def mean(x: torch.Tensor) -> torch.Tensor:  # the rank's share of the global mean
            return x.mean() if share == 1.0 else x.mean() * share

        logp = torch.log_softmax(logits_act, dim=-1)
        probs = torch.exp(logp)
        entropy = mean(-(probs * logp).sum(dim=-1))

        lambda_returns = compute_lambda_returns(rew, end, trunc, val_bootstrap, c.gamma,
                                                c.lambda_).detach()
        logp_act = torch.gather(logp, -1, act[..., None].long())[..., 0]
        adv = (lambda_returns - val).detach()
        loss_actions = mean(-logp_act * adv)
        loss_values = c.weight_value_loss * mean((val - lambda_returns) ** 2)
        loss_entropy = -c.weight_entropy_loss * entropy

        loss = loss_actions + loss_entropy + loss_values
        metrics = {
            "policy_entropy": entropy.detach() / math.log(2.0),
            "loss_actions": loss_actions.detach(),
            "loss_entropy": loss_entropy.detach(),
            "loss_values": loss_values.detach(),
            "loss_total": loss.detach(),
        }
        return loss, metrics


def compute_lambda_returns(rew: torch.Tensor, end: torch.Tensor, trunc: torch.Tensor,
                           val_bootstrap: torch.Tensor, gamma: float,
                           lambda_: float) -> torch.Tensor:
    """Lambda-returns by a reverse loop over T. All inputs (B, T); rewards are
    sign-clipped here, and values bootstrap with the (1 - lambda)-weighted next value."""
    if rew.dim() != 2:
        raise ValueError(f"compute_lambda_returns: rew must be (B, T), got {tuple(rew.shape)}")
    rew = torch.sign(rew)
    end = end.float()
    trunc = trunc.float()
    val_bootstrap = val_bootstrap.float()

    end_or_trunc = (end + trunc).clamp(max=1.0)
    not_end = 1.0 - end
    not_trunc = 1.0 - trunc

    base = rew + not_end * gamma * (not_trunc * (1 - lambda_) + trunc) * val_bootstrap
    if lambda_ == 0:
        return base

    cont = (1.0 - end_or_trunc) * gamma * lambda_
    last = val_bootstrap[:, -1]
    rets = []
    for t in reversed(range(rew.shape[1])):
        last = base[:, t] + cont[:, t] * last
        rets.append(last)
    return torch.stack(rets[::-1], dim=1)
