"""NN building blocks shared by all models: counterpart of diamond_tpu/models/blocks.py.

Layout and names follow the JAX package exactly: NHWC activations, HWIO 3x3 kernels,
(1, 1, Cin, Cout) 1x1 kernels, (in, out) dense kernels, and module/parameter names equal
to the flax paths, so a state dict converts to and from the flax variables by a flatten
(interop/jax_vars.py). Parameters are float32; each module computes in ``dtype``.

Unlike flax, a torch module knows its input width at construction, so every block takes
its input channels explicitly. Parameters are allocated empty; ``init_weights`` fills
them from a ``torch.Generator`` with the initialisers the JAX package mirrors
(blocks.py torch_* inits, zero-init output convs, orthogonal downsample convs).

Both norms run through the fused kernels (ops/fused_norms.py) and every 3x3 conv through
the implicit-GEMM kernel (ops/conv3x3.py), as blocks.py does under DIAMOND_TPU_PALLAS=1.

The static int8 rollout (ops/quant.py): Conv3x3, Conv1x1, QDense (and the LSTM cell)
are sites with three cases inside an int8 scope: calibrating (record the input range,
run the unquantized path), quantized (the module holds a calibrated ``act_scale``), or
left out by ``int8_sites`` (no ``act_scale``: unquantized). Where a norm + SiLU feeds a
quantized 3x3 conv (ResBlock norm1 -> conv1 and norm2 -> conv2, the denoiser's
norm_out -> conv_out), the norm writes the conv's int8 codes itself (K4, ops/fused_q8.py)
and the conv reads them (K5, ops/conv3x3_q8.py); every other quantized 3x3 conv
quantizes x as K5 loads it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import adagn_silu, adagn_silu_q8, conv3x3, groupnorm_silu, groupnorm_silu_q8, quant

GN_GROUP_SIZE = 32
ATTN_HEAD_DIM = 8


def num_groups(c: int) -> int:
    return max(1, c // GN_GROUP_SIZE)


def _uniform(t: torch.Tensor, bound: float, g: torch.Generator) -> None:
    nn.init.uniform_(t, -bound, bound, generator=g)


def init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Fill every parameter and buffer of ``module`` from ``g``."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(g)


# ---------------------------------------------------------------------------
# Linear layers


def _channel_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-channel (last axis) max |x| over every other axis, in f32."""
    return x.float().abs().amax(dim=tuple(range(x.dim() - 1)))


class Conv3x3(nn.Module):
    """3x3 SAME conv, stride 1 or 2; ``init`` is "torch" (kaiming-uniform), "zeros" or
    "orthogonal"."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 strides: int = 1, init: str = "torch") -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype, self.strides, self.init = dtype, strides, init
        quant.add_site_buffers(self)

    def reset_parameters(self, g: torch.Generator) -> None:
        k = self.kernel
        if self.init == "zeros":
            k.zero_()
        elif self.init == "orthogonal":
            m = torch.empty(math.prod(k.shape[:-1]), k.shape[-1])
            nn.init.orthogonal_(m, generator=g)
            k.copy_(m.reshape(k.shape))
        else:
            _uniform(k, 1.0 / math.sqrt(math.prod(k.shape[:-1])), g)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, Cin); int8 x holds codes already quantized with this site's
        scales (a quantizing norm's output)."""
        if quant.quantized(self):
            return quant.conv3x3_q8_static(x, self.kernel, self.act_scale, self.strides,
                                           self.w_q, self.w_scale, self.bias, self.dtype)
        if quant.recording():
            quant.record(self, x.float().abs().amax(dim=(0, 1, 2)), "conv3x3", w=self.kernel)
        return conv3x3(x.to(self.dtype).contiguous(), self.kernel.to(self.dtype).contiguous(),
                       self.bias, self.strides)


class Conv1x1(nn.Module):
    """1x1 conv == channel matmul; kernel (1, 1, Cin, Cout) as flax's nn.Conv."""

    def __init__(self, in_channels: int, features: int, dtype: torch.dtype = torch.float32,
                 zero_init: bool = False) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype, self.zero_init = dtype, zero_init
        quant.add_site_buffers(self)

    def reset_parameters(self, g: torch.Generator) -> None:
        if self.zero_init:
            self.kernel.zero_()
        else:
            _uniform(self.kernel, 1.0 / math.sqrt(self.kernel.shape[2]), g)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if quant.quantized(self):
            y = quant.matmul_q8_static(x, self.kernel[0, 0], self.act_scale, self.w_q,
                                       self.w_scale).to(dt)
            return y + self.bias.to(dt)
        if quant.recording():
            quant.record(self, _channel_absmax(x), "conv1x1", w=self.kernel[0, 0])
        return x.to(dt) @ self.kernel[0, 0].to(dt) + self.bias.to(dt)


class QDense(nn.Module):
    """Dense layer, kernel (in, out) (flax nn.Dense), with the int8 "dense" site.
    ``bias_fan_in``: U(+-1/sqrt(fan_in)) bias init, else zeros; ``zero_init`` zeroes the
    kernel too (the actor/critic heads)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32,
                 use_bias: bool = True, bias_fan_in: Optional[int] = None,
                 zero_init: bool = False) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.dtype, self.bias_fan_in, self.zero_init = dtype, bias_fan_in, zero_init
        quant.add_site_buffers(self)

    def reset_parameters(self, g: torch.Generator) -> None:
        if self.zero_init:
            self.kernel.zero_()
        else:
            _uniform(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]), g)
        if self.bias is not None:
            if self.bias_fan_in:
                _uniform(self.bias, 1.0 / math.sqrt(self.bias_fan_in), g)
            else:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if quant.quantized(self):
            y = quant.matmul_q8_static(x, self.kernel, self.act_scale, self.w_q,
                                       self.w_scale).to(dt)
        else:
            if quant.recording():
                quant.record(self, _channel_absmax(x), "dense", w=self.kernel)
            y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class Embed(nn.Module):
    """flax nn.Embed: table (num, features), N(0, 1) init, output in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.dtype = dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.embedding, generator=g)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[idx.long()]


# ---------------------------------------------------------------------------
# Norms


class GroupNorm(nn.Module):
    """GroupNorm, group size 32, learned affine, optional fused SiLU (K2 kernel)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 fuse_silu: bool = False) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.dtype, self.fuse_silu = dtype, fuse_silu

    def reset_parameters(self, g: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = groupnorm_silu(x.contiguous(), self.scale, self.bias, num_groups(x.shape[-1]),
                           self.fuse_silu)
        return y.to(self.dtype)

    def q8(self, x: torch.Tensor, act_max: torch.Tensor) -> torch.Tensor:
        """``forward(x)`` (with SiLU, x in ``dtype``) as the int8 codes of a quantized
        conv with input scales ``act_max`` (K4)."""
        return groupnorm_silu_q8(x.contiguous(), self.scale, self.bias,
                                 num_groups(x.shape[-1]), act_max)


class AdaGroupNorm(nn.Module):
    """Affine-free GN, FiLM x*(1+scale)+shift from a linear on the conditioning vector,
    optional fused SiLU (K1 kernel)."""

    def __init__(self, channels: int, cond_channels: int, dtype: torch.dtype = torch.float32,
                 fuse_silu: bool = False) -> None:
        super().__init__()
        self.linear = QDense(cond_channels, 2 * channels, dtype, bias_fan_in=cond_channels)
        self.dtype, self.fuse_silu = dtype, fuse_silu

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        ss = self.linear(cond)
        y = adagn_silu(x.contiguous(), ss, num_groups(x.shape[-1]), self.fuse_silu)
        return y.to(self.dtype)

    def q8(self, x: torch.Tensor, cond: torch.Tensor, act_max: torch.Tensor) -> torch.Tensor:
        """``forward(x, cond)`` (with SiLU, x in ``dtype``) as the int8 codes of a
        quantized conv with input scales ``act_max`` (K4)."""
        return adagn_silu_q8(x.contiguous(), self.linear(cond), num_groups(x.shape[-1]),
                             act_max)


def norm_silu_conv(norm: nn.Module, conv: Conv3x3, x: torch.Tensor, *cond) -> torch.Tensor:
    """``conv(norm(x, *cond))`` for a norm with fused SiLU. Where the conv is quantized
    and x is in the norm's dtype (so the norm's output is x's dtype, as K4 rounds it),
    the norm writes the conv's int8 codes and the conv reads them: the same codes the
    conv would make of the norm's output, without the bf16 tensor in between."""
    if quant.quantized(conv) and x.dtype == norm.dtype:
        return conv(norm.q8(x, *cond, conv.act_scale))
    return conv(norm(x, *cond))


# ---------------------------------------------------------------------------
# Attention (8x8 = 64 spatial tokens at the UNet mid-block)


class SelfAttention2d(nn.Module):
    """Spatial MHA over h*w tokens, head_dim 8, zero-init out projection; the residual is
    taken from the *normalized* input (blocks.py:311-332)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 head_dim: int = ATTN_HEAD_DIM) -> None:
        super().__init__()
        self.n_head = max(1, channels // head_dim)
        assert channels % self.n_head == 0
        self.norm = GroupNorm(channels, dtype)
        self.qkv_proj = Conv1x1(channels, 3 * channels, dtype)
        self.out_proj = Conv1x1(channels, channels, dtype, zero_init=True)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        hd = c // self.n_head
        x = self.norm(x)
        qkv = self.qkv_proj(x).reshape(n, h * w, 3, self.n_head, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (n, hw, heads, hd)
        att = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
        att = torch.softmax(att.float(), dim=-1).to(self.dtype)
        y = torch.einsum("nhqk,nkhd->nqhd", att, v).reshape(n, h, w, c)
        return x + self.out_proj(y)


# ---------------------------------------------------------------------------
# Noise-level embedding


class FourierFeatures(nn.Module):
    """Fixed random-frequency embedding of the noise level; the frequencies are a buffer
    (the flax 'constants' collection)."""

    def __init__(self, cond_channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        assert cond_channels % 2 == 0
        self.register_buffer("weight", torch.empty(1, cond_channels // 2))
        self.dtype = dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.normal_(self.weight, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.dim() == 1
        f = 2 * math.pi * x.float()[:, None] @ self.weight
        return torch.cat([torch.cos(f), torch.sin(f)], dim=-1).to(self.dtype)


# ---------------------------------------------------------------------------
# Resampling


class Downsample(nn.Module):
    """Stride-2 3x3 conv, orthogonal init."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype, strides=2, init="orthogonal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 then 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


# ---------------------------------------------------------------------------
# Residual blocks


class SmallResBlock(nn.Module):
    """GN -> SiLU -> Conv3x3 with a 1x1-projected skip."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.norm = GroupNorm(in_channels, dtype, fuse_silu=True)
        self.conv = Conv3x3(in_channels, out_channels, dtype)
        self.skip_projection = (Conv1x1(in_channels, out_channels, dtype)
                                if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(self.norm(x))
        skip = x if self.skip_projection is None else self.skip_projection(x)
        return skip + y


class ResBlock(nn.Module):
    """AdaGN->SiLU->Conv twice, zero-init second conv, optional self-attention."""

    def __init__(self, in_channels: int, out_channels: int, cond_channels: int, attn: bool,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = (Conv1x1(in_channels, out_channels, dtype)
                     if in_channels != out_channels else None)
        self.norm1 = AdaGroupNorm(in_channels, cond_channels, dtype, fuse_silu=True)
        self.conv1 = Conv3x3(in_channels, out_channels, dtype)
        self.norm2 = AdaGroupNorm(out_channels, cond_channels, dtype, fuse_silu=True)
        self.conv2 = Conv3x3(out_channels, out_channels, dtype, init="zeros")
        self.attn = SelfAttention2d(out_channels, dtype) if attn else None

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        r = x if self.proj is None else self.proj(x)
        y = norm_silu_conv(self.norm1, self.conv1, x, cond)
        y = norm_silu_conv(self.norm2, self.conv2, y, cond)
        y = y + r
        return y if self.attn is None else self.attn(y)


class ResBlocks(nn.Module):
    """A sequence of ResBlocks (children ``resblocks_i``), with optional per-block skip
    concatenation; ``in_channels[i]`` is block i's input width after any concat."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 cond_channels: int, attn: bool, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.n = len(out_channels)
        for i, (ci, co) in enumerate(zip(in_channels, out_channels)):
            self.add_module(f"resblocks_{i}", ResBlock(ci, co, cond_channels, attn, dtype))

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                to_cat: Optional[List[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        outputs = []
        for i in range(self.n):
            if to_cat is not None:
                x = torch.cat([x, to_cat[i]], dim=-1)
            x = getattr(self, f"resblocks_{i}")(x, cond)
            outputs.append(x)
        return x, outputs


# ---------------------------------------------------------------------------
# UNet


class UNet(nn.Module):
    """Encoder-decoder with skip concats; pads H, W up to a multiple of 2**num_down then
    crops. Decoder block j consumes the reversed outputs of encoder level L-1-j
    (including its downsampled input), concatenated channelwise."""

    def __init__(self, in_channels: int, cond_channels: int, depths: Sequence[int],
                 channels: Sequence[int], attn_depths: Sequence[int],
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        assert len(depths) == len(channels) == len(attn_depths)
        self.num_levels = len(channels)
        cur = in_channels
        skips: List[List[int]] = []
        for i, (depth, ch) in enumerate(zip(depths, channels)):
            if i > 0:
                self.add_module(f"downsamples_{i}", Downsample(cur, dtype))
            ins = [cur] + [ch] * (depth - 1)
            self.add_module(f"d_blocks_{i}", ResBlocks(ins, [ch] * depth, cond_channels,
                                                       bool(attn_depths[i]), dtype))
            skips.append([cur] + [ch] * depth)
            cur = ch
        self.mid_blocks = ResBlocks([cur, channels[-1]], [channels[-1]] * 2, cond_channels,
                                    True, dtype)
        cur = channels[-1]
        for j, skip in enumerate(reversed(skips)):
            i = self.num_levels - 1 - j
            if j > 0:
                self.add_module(f"upsamples_{j}", Upsample(cur, dtype))
            outs = [channels[i]] * depths[i] + [channels[max(0, i - 1)]]
            ins = []
            for o, s in zip(outs, skip[::-1]):
                ins.append(cur + s)
                cur = o
            self.add_module(f"u_blocks_{j}", ResBlocks(ins, outs, cond_channels,
                                                       bool(attn_depths[i]), dtype))

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        num_down = self.num_levels - 1
        n, h, w, _ = x.shape
        pad_h = math.ceil(h / 2 ** num_down) * 2 ** num_down - h
        pad_w = math.ceil(w / 2 ** num_down) * 2 ** num_down - w
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))

        d_outputs: List[List[torch.Tensor]] = []
        for i in range(self.num_levels):
            if i > 0:
                x = getattr(self, f"downsamples_{i}")(x)
            x_down = x
            x, block_outputs = getattr(self, f"d_blocks_{i}")(x, cond)
            d_outputs.append([x_down, *block_outputs])

        x, _ = self.mid_blocks(x, cond)

        for j, skip in enumerate(reversed(d_outputs)):
            if j > 0:
                x = getattr(self, f"upsamples_{j}")(x)
            x, _ = getattr(self, f"u_blocks_{j}")(x, cond, to_cat=skip[::-1])

        if pad_h or pad_w:
            x = x[:, :h, :w, :]
        return x
