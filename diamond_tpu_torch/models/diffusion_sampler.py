"""Karras-schedule diffusion sampler, Euler / Heun with optional churn
(diamond_tpu/models/diffusion_sampler.py; int8 calibration is not part of the port).

The initial latent is a *standard normal* draw, not scaled by sigma_max, and each step
denoises at sigma, not sigma_hat, even with churn (reference behaviour).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import DiffusionSamplerConfig
from .denoiser import Denoiser


def build_sigmas(num_steps: int, sigma_min: float, sigma_max: float, rho: int) -> np.ndarray:
    """Karras rho-schedule + trailing zero."""
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    l = np.linspace(0, 1, num_steps)
    sigmas = (max_inv_rho + l * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, np.zeros(1)])


class DiffusionSampler:
    def __init__(self, denoiser: Denoiser, cfg: DiffusionSamplerConfig) -> None:
        self.denoiser = denoiser
        self.cfg = cfg
        self.sigmas = build_sigmas(cfg.num_steps_denoising, cfg.sigma_min, cfg.sigma_max,
                                   cfg.rho)

    def _gammas(self) -> List[float]:
        cfg = self.cfg
        gamma_ = min(cfg.s_churn / (len(self.sigmas) - 1), 2 ** 0.5 - 1)
        return [gamma_ if cfg.s_tmin <= float(s) <= cfg.s_tmax else 0.0
                for s in self.sigmas[:-1]]

    def num_churn_draws(self) -> int:
        return sum(g > 0 for g in self._gammas())

    def sample(self, prev_obs: torch.Tensor, prev_act: torch.Tensor,
               x_init: Optional[torch.Tensor] = None,
               churn_noise: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Sample the next frame.

        prev_obs: (B, T, H, W, C) float [-1, 1]; prev_act: (B, T) int. ``x_init``
        replaces the initial N(0, 1) latent and ``churn_noise`` the N(0, 1) draws of the
        churn steps (one per step with gamma > 0); what is not given is drawn from
        ``generator``. Returns the sampled frame (B, H, W, C)."""
        cfg = self.cfg
        b, t, h, w, c = prev_obs.shape
        prev_obs = prev_obs.movedim(1, 3).reshape(b, h, w, t * c)  # frame-major channels
        obs_features = self.denoiser.compute_obs_features(prev_obs)

        dev = prev_obs.device
        x = (torch.randn((b, h, w, c), generator=generator, device=dev)
             if x_init is None else x_init.to(device=dev, dtype=torch.float32))
        churn = iter(churn_noise) if churn_noise is not None else None

        for sigma, next_sigma, gamma in zip(self.sigmas[:-1], self.sigmas[1:], self._gammas()):
            sigma, next_sigma = float(sigma), float(next_sigma)
            sigma_hat = sigma * (gamma + 1)
            if gamma > 0:
                eps = (next(churn) if churn is not None
                       else torch.randn(x.shape, generator=generator, device=dev))
                x = x + eps * cfg.s_noise * (sigma_hat ** 2 - sigma ** 2) ** 0.5
            denoised = self.denoiser.denoise(x, sigma, prev_obs, prev_act, obs_features)
            d = (x - denoised) / sigma_hat
            dt = next_sigma - sigma_hat
            if cfg.order == 1 or next_sigma == 0:
                x = x + d * dt  # Euler
            else:
                x_2 = x + d * dt  # Heun
                denoised_2 = self.denoiser.denoise(x_2, next_sigma, prev_obs, prev_act,
                                                   obs_features)
                d_2 = (x_2 - denoised_2) / next_sigma
                x = x + (d + d_2) / 2 * dt
        return x
