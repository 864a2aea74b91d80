"""Stateful world-model env with the reference's reset/step API, for play and model-based
evaluation (diamond_tpu/envs/wm_env_stateful.py).

Built on the rollout's own transition (``ImaginationEngine._wm_transition``: the
sampler, then the rew/end step and the buffer roll); the host only orchestrates resets
and the initial conditions (ICs). Frames cross to the host as uint8 numpy arrays.

  * rolling buffers of the last n_cond frames and actions; reward and end sampled from
    the predicted logits;
  * horizon truncation, at ``horizon`` steps (the engine's ``cfg.horizon``: setting the
    env's horizon, as the play app's keys do, moves the next truncations);
  * on death: refill from the IC provider (real segments with the rew/end LSTM burned in),
    reporting ``final_observation`` and ``burnin_obs``;
  * ``denoising_trajectory`` in info on request: the sampler's latents, rerun from the
    step's own draws.

Two-stage mode (``upsampler`` set, the csgo agent): the dynamics run at the low
resolution (dataset resolution / upsampling_factor) and every displayed frame is
super-resolved by the upsampler's sampling loop (``TwoStageSampler.upsample``). IC frames
arrive at full resolution and are area-downsampled, snapped to the uint8 grid, into the
buffers; the full-resolution originals are kept for display, and ``info["low_res_obs"]``
holds the low-res frame.

A step's random numbers (the low-res latent, the Gumbel noise of the reward and end
draws, and in two-stage mode the upsampler's latent) are one ``StepDraws``, drawn from
the env's ``torch.Generator`` on the models' device unless the caller passes them. The
upsampler is queued right after the transition, before anything is read back, and a
step reads its results back in one copy: its one host-device synchronisation. Host data
goes to the card through pinned memory without waiting (the action; on a refill the
fresh ICs, merged into the buffers with ``where`` on the device's own death mask), so a
refill adds only the read-back of the new buffers (``burnin_obs``) and what the IC
provider does.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.episode import obs_to_float, obs_to_uint8
from ..models.denoiser import downsample_avg, quantize_to_uint8_grid
from .world_model_env import ImagState, ImaginationEngine, gumbel, make_ic_preparer

# n -> (obs_u8 (n, n_cond, H, W, C), act (n, n_cond) int32, hx (n, D), cx (n, D)), numpy
ICProvider = Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]


class StepDraws(NamedTuple):
    """The random numbers of one step at batch B."""

    x_init: torch.Tensor                   # (B, h, w, C) the dynamics sampler's latent
    gumbel_rew: torch.Tensor               # (B, 3)
    gumbel_end: torch.Tensor               # (B, 2)
    x_init_high: Optional[torch.Tensor] = None  # (B, H, W, C) the upsampler's, two-stage


def to_low_res(obs_u8: torch.Tensor, factor: int) -> torch.Tensor:
    """uint8 frames -> their area downsample by ``factor``, snapped to the uint8 grid as
    the dynamics model's samples are, as uint8 (exact: the values lie on the grid)."""
    if factor == 1:
        return obs_u8
    return obs_to_uint8(quantize_to_uint8_grid(downsample_avg(obs_to_float(obs_u8), factor)))


class WorldModelEnv:
    """``num_envs`` fixed at construction; obs in and out are uint8 numpy (B, H, W, C).
    ``engine`` holds the dynamics denoiser, the rew/end model and the horizon; with
    ``upsampler`` (a Denoiser with an upsampling_factor) the env is two-stage, the
    upsampler sampled with the engine's sampling loop."""

    def __init__(self, engine: ImaginationEngine, ic_provider: ICProvider, num_envs: int,
                 seed: int = 0, return_denoising_trajectory: bool = False,
                 upsampler: Optional[Any] = None) -> None:
        self.engine = engine
        self.num_envs = num_envs
        self.device = next(engine.denoiser.inner_model.parameters()).device
        self._ic_provider = ic_provider
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._return_traj = return_denoising_trajectory
        self._st: Optional[ImagState] = None
        self._factor = 1
        self.cascade = None
        if upsampler is not None:
            from ..models.diffusion_sampler import TwoStageSampler

            self.cascade = TwoStageSampler(engine.sampler, upsampler, engine.sampler.cfg)
            self._factor = self.cascade.factor
        self._display_obs: Optional[np.ndarray] = None  # (B, H, W, C) full-res, two-stage
        self._act_host = torch.empty(num_envs, dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda")

    @property
    def horizon(self) -> int:
        return self.engine.cfg.horizon

    @horizon.setter
    def horizon(self, value: int) -> None:
        self.engine.cfg.horizon = int(value)

    @property
    def num_actions(self) -> int:
        return self.engine.actor_critic.cfg.num_actions \
            if self.engine.actor_critic is not None else 0

    def draw(self) -> StepDraws:
        """One step's random numbers from the env's generator."""
        b, (h, w, c) = self.num_envs, self._st.obs_buffer.shape[2:]
        g, dev = self._gen, self.device
        x_init = torch.randn((b, h, w, c), generator=g, device=dev)
        g_rew, g_end = gumbel((b, 3), g, dev), gumbel((b, 2), g, dev)
        high = None
        if self.cascade is not None:
            f = self._factor
            high = torch.randn((b, h * f, w * f, c), generator=g, device=dev)
        return StepDraws(x_init, g_rew, g_end, high)

    def _upload(self, x: np.ndarray, dtype) -> torch.Tensor:
        """A host array on the models' device, copied from pinned memory without waiting."""
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _fetch_ics(self, n: int, rows: Optional[np.ndarray] = None):
        """n ICs from the provider: the frames as numpy, and on the device the frames,
        actions and LSTM states; with ``rows``, placed at those rows of B-row arrays (the
        others zero)."""
        obs_u8, act, hx, cx = (np.asarray(a) for a in self._ic_provider(n))
        host = (obs_u8, act, hx, cx)
        if rows is not None:
            host = tuple(np.zeros((self.num_envs,) + a.shape[1:], a.dtype) for a in host)
            for full, a in zip(host, (obs_u8, act, hx, cx)):
                full[rows] = a
        obs_h, act_h, hx_h, cx_h = host
        return (obs_u8, self._upload(obs_h, np.uint8), self._upload(act_h, np.int32),
                self._upload(hx_h, np.float32), self._upload(cx_h, np.float32))

    def reset(self, seed: Optional[Any] = None, **kwargs) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            s = int(np.sum(seed)) if isinstance(seed, (list, tuple, np.ndarray)) else int(seed)
            self._gen.manual_seed(s)
        obs_np, obs, act, hx, cx = self._fetch_ics(self.num_envs)
        b, d = self.num_envs, hx.shape[-1]
        self._st = ImagState(
            obs_buffer=to_low_res(obs, self._factor), act_buffer=act, re_hx=hx, re_cx=cx,
            ac_hx=torch.zeros((b, d), device=self.device),
            ac_cx=torch.zeros((b, d), device=self.device),
            ep_len=torch.zeros((b,), dtype=torch.int32, device=self.device))
        if self.cascade is not None:  # display the full-res originals of the ICs
            self._display_obs = obs_np[:, -1].copy()
            return self._display_obs.copy(), {}
        return self._st.obs_buffer[:, -1].cpu().numpy(), {}

    @torch.no_grad()
    def step(self, act: Any, draws: Optional[StepDraws] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict[str, Any]]:
        if self._st is None:
            raise RuntimeError("reset() first")
        if draws is None:
            draws = self.draw()
        self._act_host.copy_(torch.from_numpy(np.asarray(act, np.int32).reshape(-1)))
        act = self._act_host.to(self.device, non_blocking=True)
        st0 = self._st
        self._st, next_obs, rew, end, trunc = self.engine._wm_transition(
            st0, act, draws.x_init, draws.gumbel_rew, draws.gumbel_end)
        traj = None
        if self._return_traj:  # the same draws again, keeping the latents
            act_buffer = st0.act_buffer.clone()
            act_buffer[:, -1] = act
            _, traj = self.engine.sampler.sample(obs_to_float(st0.obs_buffer), act_buffer,
                                                 x_init=draws.x_init, return_trajectory=True)
            traj = torch.stack(traj, dim=1)
        # the upsampler queued on the device before anything is read back
        high = (self.cascade.upsample(next_obs, x_init=draws.x_init_high,
                                      generator=self._gen)
                if self.cascade is not None else None)

        # one copy back: rewards, ends, truncations, the low-res frame, the high-res one
        b = self.num_envs
        parts = [torch.stack([rew + 1, end.float(), trunc.float()]).to(torch.uint8).reshape(-1),
                 obs_to_uint8(next_obs).reshape(-1)]
        if high is not None:
            parts.append(obs_to_uint8(high).reshape(-1))
        host = torch.cat(parts).cpu().numpy()
        flags = host[:3 * b].reshape(3, b)
        rew_np = flags[0].astype(np.float32) - 1.0
        end_np, trunc_np = flags[1].astype(bool), flags[2].astype(bool)
        low_np = host[3 * b:3 * b + next_obs.numel()].reshape(next_obs.shape)
        dead = end_np | trunc_np

        info: Dict[str, Any] = {}
        if traj is not None:
            info["denoising_trajectory"] = traj.cpu().numpy()
        if high is not None:  # display the super-resolved frame
            self._display_obs = host[3 * b + next_obs.numel():].reshape(high.shape)
            info["low_res_obs"] = low_np
            final_obs_pool = self._display_obs
        else:
            final_obs_pool = low_np

        if dead.any():
            info["final_observation"] = final_obs_pool[dead]
            obs_np, obs_ic, act_ic, hx_ic, cx_ic = self._fetch_ics(int(dead.sum()),
                                                                   np.nonzero(dead)[0])
            st = self._st
            m = (end + trunc) > 0  # the death mask, on the device
            m2, m5 = m[:, None], m[:, None, None, None, None]
            obs_buffer = torch.where(m5, to_low_res(obs_ic, self._factor), st.obs_buffer)
            self._st = replace(st, obs_buffer=obs_buffer,
                               act_buffer=torch.where(m2, act_ic, st.act_buffer),
                               re_hx=torch.where(m2, hx_ic, st.re_hx),
                               re_cx=torch.where(m2, cx_ic, st.re_cx),
                               ep_len=torch.where(m, torch.zeros_like(st.ep_len), st.ep_len))
            buf = obs_buffer.cpu().numpy()
            info["burnin_obs"] = buf[dead][:, :-1]
            if self.cascade is not None:  # display the full-res originals of the fresh ICs
                self._display_obs = self._display_obs.copy()
                self._display_obs[dead] = obs_np[:, -1]
            else:
                low_np = buf[:, -1]

        obs = self._display_obs.copy() if self.cascade is not None else low_np.copy()
        return obs, rew_np, end_np, trunc_np, info


def make_dataset_ic_provider(dataset, sampler, rew_end_model,
                             downsample_factor: int = 1) -> ICProvider:
    """An IC provider backed by real episodes: conditioning segments drawn by ``sampler``
    (a BatchSampler of n_cond-frame segments) from ``dataset``, and the rew/end LSTM burned
    in over them on the rew/end model's device. ``downsample_factor`` > 1 (two-stage):
    the rew/end model lives at the low resolution, so the burn-in runs on the segments'
    low-res rendition (``to_low_res``, the pixels the env's buffers will hold); the
    returned frames stay at full resolution."""
    prepare = make_ic_preparer(rew_end_model)
    dev = next(rew_end_model.net.parameters()).device

    def provider(n: int):
        ids = []
        while len(ids) < n:
            ids.extend(sampler.sample())
        segs = [dataset[sid] for sid in ids[:n]]
        obs = np.stack([s.obs for s in segs])
        act = np.stack([s.act for s in segs]).astype(np.int32)
        obs_t = to_low_res(torch.from_numpy(obs).to(dev), downsample_factor)
        hx, cx = prepare(obs_t, torch.from_numpy(act).to(dev))
        return obs, act, hx.cpu().numpy(), cx.cpu().numpy()

    return provider
