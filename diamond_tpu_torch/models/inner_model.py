"""Raw diffusion network: UNet conditioned on noise level + past actions
(diamond_tpu/models/inner_model.py). With ``is_upsampler`` (the two-stage world model's
upsampler) it takes no actions: it has no ``act_emb`` and its conditioning is the noise
embedding alone; its one conditioning frame is the bilinearly upsampled low-res frame.

Inputs are NHWC; the conditioning frames are stacked channelwise frame-major, then the
noisy next frame. ``obs_features`` is the conv_in contribution of the conditioning
channels, computed once per sampled frame (``compute_obs_features``) and shared by every
sigma step: conv(concat(a, b), K) = conv(a, K[..a..]) + conv(b, K[..b..]) + bias.
That split conv goes around the ``conv_in`` module, so in the sampler ``conv_in`` is never
calibrated and never quantized: it stays on the bf16/f32 kernel even with every int8
site selected, as in the JAX package. Training (``Denoiser.loss``) passes no
``obs_features``: ``conv_in`` runs on the 15-channel concatenation, where only its
weights need a gradient. The split holds for any number of conditioning channels: the
upsampler's ``conv_in`` takes 6 (one conditioning frame, then the noisy frame).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import InnerModelConfig
from ..ops import conv3x3
from .blocks import Conv3x3, Embed, FourierFeatures, GroupNorm, QDense, UNet, norm_silu_conv


class InnerModel(nn.Module):
    """noisy_next_obs (B, H, W, C), c_noise (B,), obs (B, H, W, T*C), act (B, T) (None
    for the upsampler) -> (B, H, W, C) float32 F-space prediction."""

    def __init__(self, cfg: InnerModelConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        t, cc = cfg.num_steps_conditioning, cfg.cond_channels
        self.cfg, self.dtype = cfg, dtype
        self.noise_emb = FourierFeatures(cc, dtype)
        if not cfg.is_upsampler:
            self.act_emb = Embed(cfg.num_actions, cc // t, dtype)
        self.cond_proj_0 = QDense(cc, cc, dtype, bias_fan_in=cc)
        self.cond_proj_2 = QDense(cc, cc, dtype, bias_fan_in=cc)
        self.conv_in = Conv3x3((t + 1) * cfg.img_channels, cfg.channels[0], dtype)
        self.unet = UNet(cfg.channels[0], cc, cfg.depths, cfg.channels, cfg.attn_depths, dtype)
        self.norm_out = GroupNorm(cfg.channels[0], dtype, fuse_silu=True)
        self.conv_out = Conv3x3(cfg.channels[0], cfg.img_channels, dtype, init="zeros")

    def _conv_in_kernel(self, lo: int, hi: int) -> torch.Tensor:
        return self.conv_in.kernel[:, :, lo:hi, :].to(self.dtype).contiguous()

    def compute_obs_features(self, obs: torch.Tensor) -> torch.Tensor:
        """conv_in contribution of the conditioning channels (no bias)."""
        return conv3x3(obs.to(self.dtype).contiguous(), self._conv_in_kernel(0, obs.shape[-1]))

    def forward(self, noisy_next_obs: torch.Tensor, c_noise: torch.Tensor, obs: torch.Tensor,
                act: Optional[torch.Tensor],
                obs_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        cond = self.noise_emb(c_noise)
        if not self.cfg.is_upsampler:
            cond = cond + self.act_emb(act).reshape(act.shape[0], -1)  # b t e -> b (t e)
        cond = self.cond_proj_2(F.silu(self.cond_proj_0(cond)))

        if obs_features is None:
            x = self.conv_in(torch.cat([obs, noisy_next_obs], dim=-1).to(self.dtype))
        else:
            split = self.conv_in.kernel.shape[2] - noisy_next_obs.shape[-1]
            x = conv3x3(noisy_next_obs.to(self.dtype).contiguous(),
                        self._conv_in_kernel(split, self.conv_in.kernel.shape[2]))
            x = x + obs_features.to(self.dtype) + self.conv_in.bias.to(self.dtype)
        x = self.unet(x, cond)
        x = norm_silu_conv(self.norm_out, self.conv_out, x)
        return x.float()
