"""LSTM cell with the JAX package's parameterisation (diamond_tpu/models/lstm.py).

torch gate order (i, f, g, o), separate ``bias_ih``/``bias_hh``, weights stored (in, 4H)
and (H, 4H). Init: xavier-uniform input weights, orthogonal recurrent weights, zero
biases except forget-gate bias 1. The carry stays float32; the gate matmuls and
nonlinearities run in ``dtype``.

The cell is the int8 "lstm" site (ops/quant.py): its input-side scales are recorded by
``LSTM`` over the whole sequence, and the hidden side uses the static bound |h| < 1
(h = o * tanh(c) with o in (0, 1)), so it needs no calibration.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from ..ops import quant

Carry = Tuple[torch.Tensor, torch.Tensor]


class LSTMCell(nn.Module):
    """Single step: ``(carry, x) -> (carry, h)`` with carry ``(hx, cx)``."""

    def __init__(self, in_features: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(in_features, 4 * hidden_dim))
        self.weight_hh = nn.Parameter(torch.empty(hidden_dim, 4 * hidden_dim))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden_dim))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_dim))
        self.hidden_dim, self.dtype = hidden_dim, dtype
        quant.add_site_buffers(self)

    def reset_parameters(self, g: torch.Generator) -> None:
        fan_in, fan_out = self.weight_ih.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        nn.init.uniform_(self.weight_ih, -bound, bound, generator=g)
        w = torch.empty(self.weight_hh.shape[1], self.weight_hh.shape[0])  # torch (4H, H)
        nn.init.orthogonal_(w, generator=g)
        self.weight_hh.copy_(w.T)
        d = self.hidden_dim
        self.bias_ih.zero_()
        self.bias_ih[d:2 * d] = 1.0
        self.bias_hh.zero_()

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        hx, cx = carry
        dt = self.dtype
        if quant.quantized(self):
            h_max = torch.ones(self.hidden_dim, device=hx.device)
            gates = (quant.matmul_q8_static(x, self.weight_ih, self.act_scale)
                     + quant.matmul_q8_static(hx, self.weight_hh, h_max)
                     + (self.bias_ih + self.bias_hh)).to(dt)
        else:
            gates = (x.to(dt) @ self.weight_ih.to(dt) + hx.to(dt) @ self.weight_hh.to(dt)
                     + (self.bias_ih + self.bias_hh).to(dt))
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        new_c = (f * cx.to(dt) + i * g).float()
        new_h = (o * torch.tanh(new_c).to(dt)).float()
        return (new_h, new_c), new_h


class LSTM(nn.Module):
    """The cell over the time axis of (B, T, D) inputs (torch ``nn.LSTM(batch_first)``
    with one layer); parameters live under ``cell.`` as in the flax ``nn.scan``."""

    def __init__(self, in_features: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cell = LSTMCell(in_features, hidden_dim, dtype)

    def forward(self, xs: torch.Tensor, carry: Carry) -> Tuple[torch.Tensor, Carry]:
        if quant.recording():  # the cell's input range over the whole sequence
            quant.record(self.cell, xs.float().abs().amax(dim=(0, 1)), "lstm")
        hs = []
        for t in range(xs.shape[1]):
            carry, h = self.cell(carry, xs[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1), carry
