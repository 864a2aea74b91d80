"""The trainer's optimizer, written out: the gradients' global norm clipped to
``max_grad_norm``, then AdamW (b1 0.9, b2 0.999, eps outside the square root, decoupled
weight decay on the matrix weights only) at a learning rate that rises linearly from 0
over ``lr_warmup_steps`` updates."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .models import decayed


class AdamW:
    def __init__(self, lr: float, weight_decay: float, eps: float,
                 max_grad_norm: Optional[float], lr_warmup_steps: int) -> None:
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.max_norm, self.warmup = max_grad_norm, lr_warmup_steps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients as the update takes them (scaled down to the norm limit)."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if self.max_norm is None or float(norm) < self.max_norm:
            return dict(grads)
        return {k: g * (self.max_norm / norm) for k, g in grads.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """One update of ``params`` by already clipped ``grads``; returns new params."""
        lr = self.lr * min(self.t, self.warmup) / self.warmup if self.warmup > 0 else self.lr
        self.t += 1
        b1, b2 = 0.9, 0.999
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * b1 + (1 - b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
            self.m[k], self.v[k] = m, v
            upd = (m / (1 - b1 ** self.t)) / (torch.sqrt(v / (1 - b2 ** self.t)) + self.eps)
            if decayed(k):
                upd = upd + self.wd * p
            out[k] = p - lr * upd
        return out
