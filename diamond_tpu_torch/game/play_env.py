"""The play app's facade over [world-model, real-test, real-train] envs
(diamond_tpu/game/play_env.py): human or policy control ('m'), the world model's horizon
up and down, env cycling, header lines, and a recording mode that writes played
episodes into ``dataset/rec_<env>_<H|P>`` datasets (the ``.npz`` layout both packages
read).

The policy runs on the models' device: the uint8 frame goes up, ``obs_to_float`` (for a
two-stage agent the frame's area downsample to the dynamics resolution, snapped to the
uint8 grid: the policy works at the low resolution), ``encode``, then ``head`` with the
carry, and the action is ``argmax(logits + Gumbel)``, read back to step the env. The
Gumbel noise comes from a ``torch.Generator`` of the play env's own on the device,
seeded by ``seed``, unless ``step`` is given it (``jax.random.categorical`` is exactly
that argmax, so a test can inject JAX's draw). The carry is zero after a reset and
after each end or truncation. The keys' moves are methods too (``change_horizon``,
``cycle_env``; ``human`` is the control), so that play runs headless without pygame.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..data.episode import Episode, obs_to_float
from ..envs.world_model_env import gumbel
from ..models.actor_critic import ActorCriticOutput
from ..models.denoiser import downsample_avg, quantize_to_uint8_grid
from ..utils import to_device
from .keymap import get_keymap_and_action_names


class NamedEnv:
    def __init__(self, name: str, env: Any) -> None:
        self.name, self.env = name, env


class PlayEnv:
    def __init__(self, agent: Any, envs: List[NamedEnv], keymap_name: str, fps: int,
                 record_mode: bool = False, record_dir: Optional[Path] = None,
                 seed: int = 0) -> None:
        self.agent = agent
        self.envs = envs
        self.env_idx = 0
        self.keymap_name = keymap_name
        self.fps = fps
        self.human = True
        self.record_mode = record_mode
        self.record_dir = Path(record_dir) if record_dir else Path("dataset")
        self._rec_buffer: List[Tuple] = []
        self._rec_datasets: Dict[str, Dataset] = {}
        self.device = next(agent.actor_critic.net.parameters()).device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._carry = None
        self._obs: Optional[np.ndarray] = None
        self._episode_return = 0.0
        self._episode_len = 0
        # a two-stage agent's policy lives at the dynamics (low) resolution, while the
        # frames shown are full resolution
        self._factor = agent.cfg.downsample_factor \
            if getattr(agent, "upsampler", None) is not None else 1

    # -- the policy on the device ----------------------------------------------

    def initial_carry(self) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.agent.actor_critic.cfg.lstm_dim
        return (torch.zeros((1, d), device=self.device),
                torch.zeros((1, d), device=self.device))

    def draw(self, num_actions: int) -> torch.Tensor:
        """One policy step's Gumbel noise (1, num_actions) from the play env's generator."""
        return gumbel((1, num_actions), self._gen, self.device)

    @torch.no_grad()
    def policy_step(self, obs_u8: np.ndarray, carry, gumbel_noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ActorCriticOutput]:
        """uint8 frames (1, H, W, C) and the carry -> (the action (1,) on the device, the
        actor-critic's output with the new carry)."""
        ac = self.agent.actor_critic
        obs = obs_to_float(to_device(obs_u8, self.device))
        if self._factor > 1:
            obs = quantize_to_uint8_grid(downsample_avg(obs, self._factor))
        out = ac.head(ac.encode(obs), carry)
        if gumbel_noise is None:
            gumbel_noise = self.draw(out.logits_act.shape[-1])
        return torch.argmax(out.logits_act + gumbel_noise, dim=-1), out

    # -- the facade Game drives --------------------------------------------------

    @property
    def env(self) -> Any:
        return self.envs[self.env_idx].env

    @property
    def env_name(self) -> str:
        return self.envs[self.env_idx].name

    def keymap_and_names(self):
        return get_keymap_and_action_names(self.keymap_name)

    def reset(self):
        obs, info = self.env.reset()
        self._carry = self.initial_carry()
        self._episode_return, self._episode_len = 0.0, 0
        self._rec_buffer = []
        self._obs = obs
        return obs[0], info

    def step(self, human_act: int, gumbel_noise: Optional[torch.Tensor] = None):
        """One frame: the human's action, or under policy control the policy's (its
        Gumbel noise ``gumbel_noise`` (1, num_actions) if given, else drawn)."""
        if self.human:
            act = np.asarray([human_act])
        else:
            a, out = self.policy_step(self._obs, self._carry, gumbel_noise)
            self._carry = out.carry
            act = a.cpu().numpy()  # the action read back

        next_obs, rew, end, trunc, info = self.env.step(act)
        rew0 = float(np.asarray(rew)[0])
        end0, trunc0 = bool(np.asarray(end)[0]), bool(np.asarray(trunc)[0])
        self._episode_return += rew0
        self._episode_len += 1

        if self.record_mode:
            self._rec_buffer.append((self._obs[0], int(act[0]), rew0, int(end0), int(trunc0)))

        if end0 or trunc0:
            if self.record_mode and self._rec_buffer:
                self._save_recording(info)
            print(f"[{self.env_name}] return={self._episode_return:.1f} "
                  f"length={self._episode_len}")
            self._episode_return, self._episode_len = 0.0, 0
            self._carry = self.initial_carry()
            self._rec_buffer = []

        self._obs = next_obs
        return next_obs[0], rew0, end0, trunc0, info

    def change_horizon(self, delta: int) -> None:
        """The world model's horizon up or down by ``delta`` (at least 1); other envs
        have none."""
        if hasattr(self.env, "horizon"):
            self.env.horizon = max(1, self.env.horizon + delta)

    def cycle_env(self, step: int = 1) -> None:
        """Switch to the env ``step`` places on in the list, and reset it."""
        self.env_idx = (self.env_idx + step) % len(self.envs)
        self.reset()

    def key_handler(self, key: int) -> None:
        import pygame

        if key == pygame.K_m:
            self.human = not self.human
        elif key == pygame.K_UP:
            self.change_horizon(1)
        elif key == pygame.K_DOWN:
            self.change_horizon(-1)
        elif key in (pygame.K_PAGEUP, pygame.K_RIGHTBRACKET):
            self.cycle_env(1)
        elif key in (pygame.K_PAGEDOWN, pygame.K_LEFTBRACKET):
            self.cycle_env(-1)

    def header_lines(self) -> List[str]:
        lines = [
            f"env: {self.env_name}   control: {'human' if self.human else 'policy'} (m)",
            f"return: {self._episode_return:.1f}   length: {self._episode_len}",
        ]
        if hasattr(self.env, "horizon"):
            lines.append(f"horizon: {self.env.horizon} (up/down)")
        lines.append("[ ] cycle env | Return reset | . pause | e step | Esc quit")
        return lines

    def render_frame(self, obs: np.ndarray) -> np.ndarray:
        return obs

    # -- recording ---------------------------------------------------------------

    def _save_recording(self, info: Dict[str, Any]) -> None:
        name = f"rec_{self.env_name}_{'H' if self.human else 'P'}"
        if name not in self._rec_datasets:
            self._rec_datasets[name] = Dataset(self.record_dir / name, name)
            self._rec_datasets[name].load_from_default_path()
        obs, act, rew, end, trunc = (np.stack(x) for x in zip(*self._rec_buffer))
        ep_info = {}
        if "final_observation" in info:
            ep_info["final_observation"] = np.asarray(info["final_observation"])[0]
        ep = Episode(obs=obs.astype(np.uint8), act=act.astype(np.int32),
                     rew=rew.astype(np.float32), end=end.astype(np.uint8),
                     trunc=trunc.astype(np.uint8), info=ep_info)
        ds = self._rec_datasets[name]
        ds.add_episode(ep)
        ds.save_to_default_path()
        print(f"saved episode to {name} ({ds.num_episodes} episodes)")
