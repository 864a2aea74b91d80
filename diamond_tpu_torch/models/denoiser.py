"""EDM (Karras et al.) preconditioning around InnerModel (diamond_tpu/models/denoiser.py):
the denoising evaluation the sampler calls, the autoregressive training loss, and the
two-stage world model's upsampler loss (``loss_upsampler``, a denoiser whose config has
an ``upsampling_factor``) with its resolution changes (``downsample_avg``,
``upsample_frame``).

Exact-behavior notes carried over: the offset-noise sigma is folded into the
conditioners, and the output is snapped to the 256-level [-1, 1] grid with a floor
(the reference's ``.byte()`` truncation).

The loss draws its random numbers from ``DenoiserDraws`` (injected, so a test can hand
it the JAX package's draws) or from an explicit ``torch.Generator``. The JAX package
recomputes each window's U-Net forward in the backward (``jax.checkpoint``), a TPU
memory-layout trade; the port keeps the activations instead.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..config import DenoiserConfig, SigmaDistributionConfig
from .inner_model import InnerModel


class Conditioners(NamedTuple):
    """c_in/c_out/c_skip broadcast over (B, H, W, C); c_noise is (B,)."""

    c_in: torch.Tensor
    c_out: torch.Tensor
    c_skip: torch.Tensor
    c_noise: torch.Tensor


class DenoiserDraws(NamedTuple):
    """The random numbers of ``Denoiser.loss``, stacked over its ``S`` windows: the
    standard normals of the training sigma (S, B), of the offset noise (S, B, 1, 1, C)
    and of the iid noise (S, B, H, W, C)."""

    sigma: torch.Tensor
    offset: torch.Tensor
    noise: torch.Tensor


def draw_loss_noise(windows: int, b: int, hwc: Tuple[int, int, int],
                    generator: Optional[torch.Generator], device) -> DenoiserDraws:
    """``DenoiserDraws`` of ``windows`` windows at batch b and frame size hwc from
    ``generator`` (on ``device``)."""
    h, w, c = hwc
    rnd = lambda *shape: torch.randn(shape, generator=generator, device=device)  # noqa: E731
    return DenoiserDraws(rnd(windows, b), rnd(windows, b, 1, 1, c), rnd(windows, b, h, w, c))


def quantize_to_uint8_grid(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [-1, 1] and snap (floor) to the 256-level grid."""
    x = torch.clamp(x, -1.0, 1.0)
    return torch.floor((x + 1) / 2 * 255) / 255 * 2 - 1


def downsample_avg(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Exact area downsample by an integer factor over the (H, W) axes of (..., H, W, C).
    The factor x factor values of a window are summed one by one in row-major order,
    then divided: the order of XLA's mean in the JAX function run op by op, so the result
    is that function's bit for bit, on either device. (The mean of grid values often lies
    exactly on a grid level, where ``quantize_to_uint8_grid``'s floor flips on a last-ulp
    difference of a sum in another order; under jit XLA fuses the sum in another order.)"""
    if factor == 1:
        return x
    *lead, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"downsample_avg: {h}x{w} is not a multiple of {factor}")
    x = x.reshape(*lead, h // factor, factor, w // factor, factor, c)
    acc = x[..., 0, :, 0, :]
    for k in range(1, factor * factor):
        acc = acc + x[..., k // factor, :, k % factor, :]
    return acc / (factor * factor)


def upsample_frame(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear upsample of the (H, W) axes of (..., H, W, C) by an integer factor: half-
    pixel centres, edge samples clamped (``jax.image.resize(..., "bilinear")``, which
    is ``align_corners=False``)."""
    if factor == 1:
        return x
    *lead, h, w, c = x.shape
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), scale_factor=factor,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, h * factor, w * factor, c)


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
                             act: Optional[torch.Tensor], cs: Conditioners,
                             obs_features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """obs is (B, H, W, T*C) frame-major; act is None for the upsampler."""
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
                obs: torch.Tensor, act: Optional[torch.Tensor],
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

    # -- training ----------------------------------------------------------------

    @staticmethod
    def sample_sigma_training(normal: torch.Tensor, cfg: SigmaDistributionConfig
                              ) -> torch.Tensor:
        """sigma = clip(exp(normal * scale + loc), sigma_min, sigma_max) from standard
        normals (B,)."""
        return torch.clamp(torch.exp(normal * cfg.scale + cfg.loc), cfg.sigma_min, cfg.sigma_max)

    def apply_noise(self, x: torch.Tensor, sigma: torch.Tensor, offset: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) plus per-channel offset noise (standard normals offset (B, 1, 1,
        C), scaled by sigma_offset_noise) and iid noise (B, H, W, C) scaled by sigma."""
        return x + self.cfg.sigma_offset_noise * offset + noise * sigma[:, None, None, None]

    def loss(self, obs: torch.Tensor, act: torch.Tensor, mask: torch.Tensor,
             sigma_cfg: SigmaDistributionConfig, draws: Optional[DenoiserDraws] = None,
             generator: Optional[torch.Generator] = None,
             count_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The autoregressive training loss (the JAX package's ``Denoiser.loss``): obs (B,
        T, H, W, C) float in [-1, 1], act (B, T) int, mask (B, T) bool. Over the ``T - n``
        windows (n conditioning frames) the masked mean squared error of the F-space
        prediction, each window conditioned on the previous window's quantized,
        detached prediction in place of its last frame. Random numbers from ``draws``,
        else from ``generator``. ``count_mask``: the mask whose counts each window's mean
        divides by, ``mask`` by default; under data parallelism the global batch's (this
        batch holds one rank's rows of it), so that the ranks' losses sum to the global
        mean. Returns (loss, {"loss_denoising": detached loss})."""
        n = self.cfg.inner_model.num_steps_conditioning
        b, t_total, h, w, c = obs.shape
        windows = t_total - n
        if draws is None:
            draws = draw_loss_noise(windows, b, (h, w, c), generator, obs.device)
        frames = list(obs.unbind(1))
        loss = obs.new_zeros(())
        for i in range(windows):
            cond = torch.stack(frames[i:n + i], dim=3).reshape(b, h, w, n * c)  # frame-major
            next_obs = frames[n + i]
            sigma = self.sample_sigma_training(draws.sigma[i], sigma_cfg)
            noisy = self.apply_noise(next_obs, sigma, draws.offset[i], draws.noise[i])
            cs = self.compute_conditioners(sigma)
            model_output = self.compute_model_output(noisy, cond, act[:, i:n + i], cs)
            target = (next_obs - cs.c_skip * noisy) / cs.c_out
            se = (model_output - target) ** 2
            m = mask[:, n + i].float()
            count = m.sum() if count_mask is None else count_mask[:, n + i].float().sum()
            denom = torch.clamp_min(count * (h * w * c), 1.0)
            loss = loss + (se.sum(dim=(1, 2, 3)) * m).sum() / denom
            frames[n + i] = self.wrap_model_output(noisy, model_output.detach(), cs)
        loss = loss / windows
        return loss, {"loss_denoising": loss.detach()}

    def loss_upsampler(self, obs: torch.Tensor, mask: torch.Tensor,
                       sigma_cfg: SigmaDistributionConfig, draws: Optional[DenoiserDraws] = None,
                       generator: Optional[torch.Generator] = None,
                       count_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The upsampler's per-frame training loss (the JAX package's ``loss_upsampler``):
        obs (B, T, H, W, C) float in [-1, 1] at full resolution, mask (B, T) bool. Time
        folds into batch: each of the B * T frames is denoised, conditioned on its own
        low-res rendition (area downsample by ``upsampling_factor``, snapped to the uint8
        grid as the low-res model's samples are, upsampled bilinearly). The masked mean
        squared error of the F-space prediction. Random numbers from ``draws`` (one
        window of B * T frames), else from ``generator``. ``count_mask``: as in ``loss``.
        Returns (loss, {"loss_denoising": detached loss})."""
        f = self.cfg.upsampling_factor
        if f is None:
            raise ValueError("loss_upsampler needs a denoiser with an upsampling_factor")
        b, t, h, w, c = obs.shape
        x = obs.reshape(b * t, h, w, c)
        m = mask.reshape(b * t).float()
        if draws is None:
            draws = draw_loss_noise(1, b * t, (h, w, c), generator, obs.device)
        cond = upsample_frame(quantize_to_uint8_grid(downsample_avg(x, f)), f)
        sigma = self.sample_sigma_training(draws.sigma[0], sigma_cfg)
        noisy = self.apply_noise(x, sigma, draws.offset[0], draws.noise[0])
        cs = self.compute_conditioners(sigma)
        model_output = self.compute_model_output(noisy, cond, None, cs)
        target = (x - cs.c_skip * noisy) / cs.c_out
        se = (model_output - target) ** 2
        count = m.sum() if count_mask is None else count_mask.reshape(-1).float().sum()
        denom = torch.clamp_min(count * (h * w * c), 1.0)
        loss = (se.sum(dim=(1, 2, 3)) * m).sum() / denom
        return loss, {"loss_denoising": loss.detach()}
