"""EDM (Karras et al.) preconditioning around InnerModel, inference half
(diamond_tpu/models/denoiser.py). The training loss comes with the training slice.

Exact-behavior notes carried over: the offset-noise sigma is folded into the
conditioners, and the output is snapped to the 256-level [-1, 1] grid with a floor
(the reference's ``.byte()`` truncation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..config import DenoiserConfig
from .inner_model import InnerModel


class Conditioners(NamedTuple):
    """c_in/c_out/c_skip broadcast over (B, H, W, C); c_noise is (B,)."""

    c_in: torch.Tensor
    c_out: torch.Tensor
    c_skip: torch.Tensor
    c_noise: torch.Tensor


def quantize_to_uint8_grid(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [-1, 1] and snap (floor) to the 256-level grid."""
    x = torch.clamp(x, -1.0, 1.0)
    return torch.floor((x + 1) / 2 * 255) / 255 * 2 - 1


class Denoiser:
    """EDM wrapper; the weights are those of ``self.inner_model`` (an nn.Module whose
    state-dict keys are the flax paths of the JAX Denoiser's variables)."""

    def __init__(self, cfg: DenoiserConfig, dtype: torch.dtype = torch.float32) -> None:
        self.cfg = cfg
        self.inner_model = InnerModel(cfg.inner_model, dtype)

    def compute_conditioners(self, sigma: torch.Tensor) -> Conditioners:
        sigma = torch.sqrt(sigma ** 2 + self.cfg.sigma_offset_noise ** 2)
        sd2 = self.cfg.sigma_data ** 2
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * torch.sqrt(c_skip)
        c_noise = torch.log(sigma) / 4
        expand = lambda v: v.reshape(v.shape + (1,) * (4 - v.dim()))  # noqa: E731
        return Conditioners(expand(c_in), expand(c_out), expand(c_skip), c_noise)

    def compute_model_output(self, noisy_next_obs: torch.Tensor, obs: torch.Tensor,
                             act: torch.Tensor, cs: Conditioners,
                             obs_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """obs is (B, H, W, T*C) frame-major."""
        rescaled_obs = obs / self.cfg.sigma_data
        rescaled_noise = noisy_next_obs * cs.c_in
        return self.inner_model(rescaled_noise, cs.c_noise, rescaled_obs, act, obs_features)

    def compute_obs_features(self, obs: torch.Tensor) -> torch.Tensor:
        """conv_in's conditioning contribution, shared by a sampler's denoise calls."""
        return self.inner_model.compute_obs_features(obs / self.cfg.sigma_data)

    def wrap_model_output(self, noisy_next_obs: torch.Tensor, model_output: torch.Tensor,
                          cs: Conditioners) -> torch.Tensor:
        d = cs.c_skip * noisy_next_obs + cs.c_out * model_output
        return quantize_to_uint8_grid(d)

    def denoise(self, noisy_next_obs: torch.Tensor, sigma: Union[float, torch.Tensor],
                obs: torch.Tensor, act: torch.Tensor,
                obs_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Single denoising evaluation."""
        n, dev = noisy_next_obs.shape[0], noisy_next_obs.device
        if isinstance(sigma, torch.Tensor):
            sigma = sigma.to(device=dev, dtype=torch.float32).expand(n)
        else:  # a fill on the device: a copy from the host would wait for the stream
            sigma = torch.full((n,), sigma, dtype=torch.float32, device=dev)
        cs = self.compute_conditioners(sigma)
        model_output = self.compute_model_output(noisy_next_obs, obs, act, cs, obs_features)
        return self.wrap_model_output(noisy_next_obs, model_output, cs)
