"""The full-size default configuration, as dataclass defaults.

These carry the values of diamond_tpu/configs/agent/default.yaml (the DIAMOND Atari
agent), the ``world_model_env`` section of diamond_tpu/configs/trainer.yaml and its
three models' ``training``/``optimizer`` sections with the actor-critic loss, the Atari
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
class ActorCriticLossConfig:
    """trainer.yaml ``actor_critic.actor_critic_loss`` (models/actor_critic.py)."""

    backup_every: int = 15
    gamma: float = 0.985
    lambda_: float = 0.95
    weight_value_loss: float = 1.0
    weight_entropy_loss: float = 0.001


@dataclass
class OptimizerConfig:
    """trainer.yaml ``<model>.optimizer``: AdamW (models/agent.py ``configure_opt``)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    eps: float = 1e-8


@dataclass
class TrainingConfig:
    """trainer.yaml ``<model>.training``; ``num_autoregressive_steps`` is the denoiser's
    alone and ``seq_length`` (horizon + conditioning frames) the rew/end model's."""

    batch_size: int = 32
    lr_warmup_steps: int = 100
    max_grad_norm: Optional[float] = 100.0
    grad_acc_steps: int = 1
    start_after_epochs: int = 0
    steps_first_epoch: int = 10000
    steps_per_epoch: int = 400
    sample_weights: List[float] = field(default_factory=lambda: [0.1, 0.1, 0.1, 0.7])
    num_autoregressive_steps: Optional[int] = None
    seq_length: Optional[int] = None


@dataclass
class ActorCriticTrainerConfig:
    training: TrainingConfig = field(
        default_factory=lambda: TrainingConfig(steps_first_epoch=5000))
    actor_critic_loss: ActorCriticLossConfig = field(default_factory=ActorCriticLossConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


@dataclass
class SigmaDistributionConfig:
    """trainer.yaml ``denoiser.sigma_distribution``: the training noise levels,
    sigma = clip(exp(N(loc, scale)), sigma_min, sigma_max) (models/denoiser.py)."""

    loc: float = -0.4
    scale: float = 1.2
    sigma_min: float = 2e-3
    sigma_max: float = 20.0


@dataclass
class DenoiserTrainerConfig:
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        max_grad_norm=1.0, num_autoregressive_steps=1))
    optimizer: OptimizerConfig = field(default_factory=lambda: OptimizerConfig(weight_decay=1e-2))
    sigma_distribution: SigmaDistributionConfig = field(
        default_factory=SigmaDistributionConfig)


@dataclass
class RewEndTrainerConfig:
    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(seq_length=19))
    optimizer: OptimizerConfig = field(default_factory=lambda: OptimizerConfig(weight_decay=1e-2))


@dataclass
class TrainerConfig:
    """The trainer.yaml sections of the three train steps (``denoiser``,
    ``rew_end_model``, ``actor_critic``: training and optimizer values, the denoiser's
    sigma distribution and the AC loss)."""

    denoiser: DenoiserTrainerConfig = field(default_factory=DenoiserTrainerConfig)
    rew_end_model: RewEndTrainerConfig = field(default_factory=RewEndTrainerConfig)
    actor_critic: ActorCriticTrainerConfig = field(default_factory=ActorCriticTrainerConfig)


@dataclass
class RuntimeConfig:
    """The trainer.yaml ``tpu`` options the port follows. ``int8_rollout``: calibrate
    the denoiser and the rew/end model (``DiffusionSampler.calibrate``,
    ``RewEndModel.calibrate``) so that the rollout runs the static int8 path on the site
    kinds of ``int8_sites`` ('all' or a comma list of conv3x3, conv1x1, dense, lstm).
    ``grad_acc_sum``: with ``grad_acc_steps`` > 1 the update takes the sum of the
    micro-gradients, not their mean (``models/agent.py`` ``AdamWClip``)."""

    compute_dtype: str = "bfloat16"
    pool_policy_feats: bool = True
    int8_rollout: bool = True
    int8_sites: str = "conv3x3,conv1x1"
    grad_acc_sum: bool = False
