"""The full-size default configuration, as dataclass defaults.

These carry the values of diamond_tpu/configs/agent/default.yaml (the DIAMOND Atari
agent), the ``world_model_env`` section of diamond_tpu/configs/trainer.yaml, the Atari
frame size (configs/env/atari.yaml ``train.size``) and the ``tpu`` options the port
honours. The port reads no YAML: its machine may have no PyYAML, and a test holds these
defaults equal to ``diamond_tpu.config.load_config("trainer")``.

The class names and fields are those of the JAX package's config dataclasses
(models/inner_model.py, denoiser.py, diffusion_sampler.py, rew_end_model.py,
actor_critic.py, agent.py, envs/world_model_env.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

IMG_SIZE = 64               # configs/env/atari.yaml train.size
NUM_ACTIONS_BREAKOUT = 4    # BreakoutNoFrameskip-v4's action set (bench.py NUM_ACTIONS)


def _four(v: int) -> List[int]:
    return field(default_factory=lambda: [v] * 4)


@dataclass
class InnerModelConfig:
    img_channels: int = 3
    num_steps_conditioning: int = 4
    cond_channels: int = 256
    depths: List[int] = _four(2)
    channels: List[int] = _four(64)
    attn_depths: List[int] = _four(0)
    num_actions: Optional[int] = None


@dataclass
class DenoiserConfig:
    inner_model: InnerModelConfig = field(default_factory=InnerModelConfig)
    sigma_data: float = 0.5
    sigma_offset_noise: float = 0.3


@dataclass
class RewEndModelConfig:
    lstm_dim: int = 512
    img_channels: int = 3
    img_size: int = IMG_SIZE
    cond_channels: int = 128
    depths: List[int] = _four(2)
    channels: List[int] = _four(32)
    attn_depths: List[int] = _four(0)
    num_actions: Optional[int] = None


@dataclass
class ActorCriticConfig:
    lstm_dim: int = 512
    img_channels: int = 3
    img_size: int = IMG_SIZE
    channels: List[int] = field(default_factory=lambda: [32, 32, 64, 64])
    down: List[int] = _four(1)
    num_actions: Optional[int] = None


@dataclass
class DiffusionSamplerConfig:
    num_steps_denoising: int = 3
    sigma_min: float = 2e-3
    sigma_max: float = 5.0
    rho: int = 7
    order: int = 1
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0


@dataclass
class WorldModelEnvConfig:
    horizon: int = 15
    num_batches_to_preload: int = 256
    diffusion_sampler: DiffusionSamplerConfig = field(default_factory=DiffusionSamplerConfig)


@dataclass
class AgentConfig:
    """``num_actions`` is injected into the three model configs (reference agent.py)."""

    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    rew_end_model: RewEndModelConfig = field(default_factory=RewEndModelConfig)
    actor_critic: ActorCriticConfig = field(default_factory=ActorCriticConfig)
    num_actions: int = NUM_ACTIONS_BREAKOUT

    def __post_init__(self) -> None:
        self.denoiser.inner_model.num_actions = self.num_actions
        self.rew_end_model.num_actions = self.num_actions
        self.actor_critic.num_actions = self.num_actions


@dataclass
class RuntimeConfig:
    """The trainer.yaml ``tpu`` options the port follows. ``int8_rollout``: calibrate
    the denoiser and the rew/end model (``DiffusionSampler.calibrate``,
    ``RewEndModel.calibrate``) so that the rollout runs the static int8 path on the site
    kinds of ``int8_sites`` ('all' or a comma list of conv3x3, conv1x1, dense, lstm)."""

    compute_dtype: str = "bfloat16"
    pool_policy_feats: bool = True
    int8_rollout: bool = True
    int8_sites: str = "conv3x3,conv1x1"
