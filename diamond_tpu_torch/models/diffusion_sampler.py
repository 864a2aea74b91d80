"""Karras-schedule diffusion sampler, Euler / Heun with optional churn, and the
calibration of the static int8 rollout (diamond_tpu/models/diffusion_sampler.py).

The initial latent is a *standard normal* draw, not scaled by sigma_max, and each step
denoises at sigma, not sigma_hat, even with churn (reference behaviour).

The int8 gate is structural (ops/quant.py): ``sample`` runs inside the int8 scope iff
the denoiser holds a calibrated collection (``calibrate``), so an uncalibrated denoiser
samples exactly as before and nothing outside the sampler is ever quantized.

``TwoStageSampler`` is the two-stage world model's cascade: the dynamics denoiser samples
the next low-res frame, then the upsampler, an action-free denoiser, samples its full-
resolution rendition conditioned on the low-res frame upsampled bilinearly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import DiffusionSamplerConfig
from ..ops import quant
from ..parallel.mesh import DataParallel
from .denoiser import Denoiser, upsample_frame


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

    def sample(self, prev_obs: torch.Tensor, prev_act: Optional[torch.Tensor],
               x_init: Optional[torch.Tensor] = None,
               churn_noise: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None, return_trajectory: bool = False
               ) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
        """Sample the next frame.

        prev_obs: (B, T, H, W, C) float [-1, 1]; prev_act: (B, T) int, or None for an
        action-free denoiser (the upsampler). ``x_init`` replaces the initial N(0, 1)
        latent and ``churn_noise`` the N(0, 1) draws of the churn steps (one per step
        with gamma > 0); what is not given is drawn from ``generator``. Returns the
        sampled frame (B, H, W, C); with ``return_trajectory`` (frame, trajectory), the
        trajectory the latent before each step and after the last."""
        enabled = quant.calibrating() or quant.has_collection(self.denoiser.inner_model)
        with quant.int8_scope(enabled):
            x, traj = self._sample(prev_obs, prev_act, x_init, churn_noise, generator,
                                   return_trajectory)
        return (x, traj) if return_trajectory else x

    @torch.no_grad()
    def calibrate(self, prev_obs: torch.Tensor, prev_act: Optional[torch.Tensor], sites=None,
                  x_init: Optional[torch.Tensor] = None,
                  churn_noise: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None,
                  dp: Optional[DataParallel] = None) -> dict:
        """Observe every site's input range over one sampling pass and install the
        "quant" collection in the denoiser (a stale one is dropped first); returns it.
        The ranges are max-merged over the sigma steps. ``sites``: which site kinds
        quantize (``quant.parse_sites``; config ``int8_sites``); the others keep their
        unquantized path. A selection that matches nothing leaves the denoiser
        unquantized and returns {}. Call with representative conditioning frames (the
        live rollout buffers); the draws are injectable as in ``sample``. ``dp`` (data
        parallelism: the frames are the rank's rows): each site's range is the max over
        the ranks, so every rank folds the same int8 weights."""
        sites = quant.parse_sites(sites)
        net = self.denoiser.inner_model
        quant.strip(net)
        registry: dict = {}
        with quant.calibration_scope(registry, net):
            self.sample(prev_obs, prev_act, x_init, churn_noise, generator)
        if not registry:
            raise RuntimeError("calibration saw no quantizable sites")
        if dp is not None:
            quant.all_reduce_ranges(registry, dp)
        coll = quant.registry_to_collection(registry, sites)
        quant.install(net, coll)
        return coll

    def _sample(self, prev_obs, prev_act, x_init, churn_noise, generator, return_trajectory=False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        cfg = self.cfg
        b, t, h, w, c = prev_obs.shape
        prev_obs = prev_obs.movedim(1, 3).reshape(b, h, w, t * c)  # frame-major channels
        obs_features = self.denoiser.compute_obs_features(prev_obs)

        dev = prev_obs.device
        x = (torch.randn((b, h, w, c), generator=generator, device=dev)
             if x_init is None else x_init.to(device=dev, dtype=torch.float32))
        churn = iter(churn_noise) if churn_noise is not None else None
        trajectory = [x] if return_trajectory else []

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
            if return_trajectory:
                trajectory.append(x)
        return x, trajectory


class TwoStageSampler:
    """The two-stage world model's cascade (diamond_tpu/models/diffusion_sampler.py
    ``TwoStageSampler``): ``low_sampler`` draws the next low-res frame from the dynamics
    denoiser, then ``up_sampler`` (the upsampler's own sampling loop, ``up_cfg``)
    super-resolves it, conditioned on it upsampled bilinearly. The upsampler is
    memoryless: one frame in, one frame out."""

    def __init__(self, low_sampler: DiffusionSampler, upsampler: Denoiser,
                 up_cfg: DiffusionSamplerConfig) -> None:
        if upsampler.cfg.upsampling_factor is None:
            raise ValueError("TwoStageSampler needs an upsampler (a denoiser with an "
                             "upsampling_factor)")
        self.low_sampler = low_sampler
        self.up_sampler = DiffusionSampler(upsampler, up_cfg)
        self.factor = int(upsampler.cfg.upsampling_factor)

    def sample(self, prev_obs_low: torch.Tensor, prev_act: torch.Tensor,
               x_init_low: Optional[torch.Tensor] = None,
               x_init_high: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """prev_obs_low (B, T, h, w, C) low-res conditioning frames, prev_act (B, T) ->
        (next_low (B, h, w, C), next_high (B, h * f, w * f, C)). Each stage's initial
        latent is injectable, else drawn from ``generator``."""
        low = self.low_sampler.sample(prev_obs_low, prev_act, x_init=x_init_low,
                                      generator=generator)
        return low, self.upsample(low, x_init=x_init_high, generator=generator)

    def upsample(self, low: torch.Tensor, x_init: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Super-resolve low-res frames (B, h, w, C) -> (B, h * f, w * f, C)."""
        cond = upsample_frame(low, self.factor)
        return self.up_sampler.sample(cond[:, None], None, x_init=x_init, generator=generator)
