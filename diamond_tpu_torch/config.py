"""The trainer's whole configuration, as dataclass defaults, and its override parser.

These carry the values of diamond_tpu/configs/trainer.yaml with its group files
(agent/default.yaml, the DIAMOND Atari agent; env/atari.yaml and env/fake.yaml): every
section the port's trainer reads, the ``tpu`` options it honours among them. The port
reads no YAML: its machine may have no PyYAML, and a test holds ``load_config`` equal
to ``diamond_tpu.config.load_config("trainer", overrides)`` on every key the port has.

``load_config(overrides)`` takes the CLI's ``key=value`` strings: values through
``ast.literal_eval`` (``null``/``true``/``false`` as YAML spells them, anything else
that is no Python literal stays a string), the group choices ``env=atari|fake`` and
``agent=default|csgo``. ``agent=csgo`` (configs/agent/csgo.yaml) is the two-stage world
model: ``agent.upsampler`` set, the dynamics denoiser, the rew/end model and the
actor-critic at ``env.train.size // upsampling_factor``. The values the YAML derives by
interpolation (the rew/end model's ``seq_length``, the ``sample_weights`` that follow
the denoiser's, ``env.test`` from ``env.train``, the models' frame size and channels)
are derived after the overrides, unless an override set them itself. A run saves its
resolved config as JSON (``save_config``); resume reads it back (``load_config(overrides,
base=...)``).

The class names and fields are those of the JAX package's config dataclasses
(models/inner_model.py, denoiser.py, diffusion_sampler.py, rew_end_model.py,
actor_critic.py, agent.py, envs/world_model_env.py).
"""

from __future__ import annotations

import ast
import copy
import json
from dataclasses import asdict, dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

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
    # the two-stage world model's upsampler: no action embedding, conditioned on the
    # noise level alone (models/inner_model.py)
    is_upsampler: bool = False


@dataclass
class DenoiserConfig:
    """``upsampling_factor`` set: the two-stage world model's upsampler, an action-free
    denoiser at full resolution conditioned on the bilinearly upsampled low-res frame
    (models/denoiser.py ``loss_upsampler``)."""

    inner_model: InnerModelConfig = field(default_factory=InnerModelConfig)
    sigma_data: float = 0.5
    sigma_offset_noise: float = 0.3
    upsampling_factor: Optional[int] = None

    def __post_init__(self) -> None:
        if self.upsampling_factor is not None:
            if self.upsampling_factor <= 1:
                raise ValueError(f"upsampling_factor must be > 1, got {self.upsampling_factor}")
            self.inner_model.is_upsampler = True


def csgo_upsampler() -> DenoiserConfig:
    """configs/agent/csgo.yaml ``upsampler``: factor 4, one conditioning frame."""
    return DenoiserConfig(inner_model=InnerModelConfig(num_steps_conditioning=1),
                          upsampling_factor=4)


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
    """``num_actions`` is injected into the three model configs (reference agent.py).
    ``upsampler``: the two-stage world model's second stage (``agent=csgo``), else None;
    it takes no actions."""

    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    rew_end_model: RewEndModelConfig = field(default_factory=RewEndModelConfig)
    actor_critic: ActorCriticConfig = field(default_factory=ActorCriticConfig)
    num_actions: int = NUM_ACTIONS_BREAKOUT
    upsampler: Optional[DenoiserConfig] = None

    @property
    def downsample_factor(self) -> int:
        """The dynamics resolution's divisor: the upsampler's factor, else 1."""
        return self.upsampler.upsampling_factor if self.upsampler is not None else 1

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
class UpsamplerTrainerConfig:
    """trainer.yaml ``upsampler``: read only where ``agent.upsampler`` is set; B x
    seq_length frames feed each step (time folds into batch)."""

    training: TrainingConfig = field(default_factory=lambda: TrainingConfig(
        batch_size=16, max_grad_norm=1.0, seq_length=2))
    optimizer: OptimizerConfig = field(default_factory=lambda: OptimizerConfig(weight_decay=1e-2))
    sigma_distribution: SigmaDistributionConfig = field(
        default_factory=SigmaDistributionConfig)


@dataclass
class TrainerConfig:
    """The trainer.yaml sections of the three train steps (``denoiser``,
    ``rew_end_model``, ``actor_critic``: training and optimizer values, the denoiser's
    sigma distribution and the AC loss)."""

    denoiser: DenoiserTrainerConfig = field(default_factory=DenoiserTrainerConfig)
    rew_end_model: RewEndTrainerConfig = field(default_factory=RewEndTrainerConfig)
    actor_critic: ActorCriticTrainerConfig = field(default_factory=ActorCriticTrainerConfig)


@dataclass
class DistributedConfig:
    """``tpu.distributed``: a process group across hosts (parallel/multihost.py). The
    training CLI runs one host and refuses a coordinator; ``cpu_gloo`` picks gloo over
    NCCL (the CPU test fabric)."""

    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    cpu_gloo: bool = False


@dataclass
class RuntimeConfig:
    """The trainer.yaml ``tpu`` options the port follows. ``int8_rollout``: calibrate
    the denoiser and the rew/end model (``DiffusionSampler.calibrate``,
    ``RewEndModel.calibrate``) so that the rollout runs the static int8 path on the site
    kinds of ``int8_sites`` ('all' or a comma list of conv3x3, conv1x1, dense, lstm).
    ``grad_acc_sum``: with ``grad_acc_steps`` > 1 the update takes the sum of the
    micro-gradients, not their mean (``models/agent.py`` ``AdamWClip``).
    ``data_parallel``: one process per card of ``common.devices`` where there are more
    than one and every batch size divides over them (main.py)."""

    compute_dtype: str = "bfloat16"
    pool_policy_feats: bool = True
    int8_rollout: bool = True
    int8_sites: str = "conv3x3,conv1x1"
    grad_acc_sum: bool = False
    device_dataset: bool = True                   # the device episode store
    device_dataset_capacity: Optional[int] = None  # steps; None: from the collection budget
    profile_dir: Optional[str] = None             # a torch.profiler trace of epoch 1
    data_parallel: bool = True
    distributed: DistributedConfig = field(default_factory=DistributedConfig)


# ---------------------------------------------------------------------------
# The trainer's other sections (trainer.yaml)


@dataclass
class WandbConfig:
    mode: str = "disabled"
    project: Optional[str] = None
    entity: Optional[str] = None
    name: Optional[str] = None
    group: Optional[str] = None
    tags: Optional[List[str]] = None
    notes: Optional[str] = None


@dataclass
class InitializationConfig:
    path_to_ckpt: Optional[str] = None
    load_denoiser: bool = True
    load_rew_end_model: bool = True
    load_actor_critic: bool = True


@dataclass
class CommonConfig:
    devices: Any = "all"  # "all", or a card index or a list of them
    seed: Optional[int] = None
    resume: bool = False


@dataclass
class CheckpointingConfig:
    save_agent_every: int = 5
    num_to_keep: Optional[int] = 11


@dataclass
class FirstEpochConfig:
    min: int = 5000
    max: Optional[int] = 10000
    threshold_rew: int = 10


@dataclass
class TrainCollectionConfig:
    num_envs: int = 1
    epsilon: float = 0.01
    num_steps_total: int = 100000
    first_epoch: FirstEpochConfig = field(default_factory=FirstEpochConfig)
    steps_per_epoch: int = 100


@dataclass
class TestCollectionConfig:
    num_envs: int = 1
    num_episodes: int = 4
    epsilon: float = 0.0
    num_final_episodes: int = 100


@dataclass
class CollectionConfig:
    train: TrainCollectionConfig = field(default_factory=TrainCollectionConfig)
    test: TestCollectionConfig = field(default_factory=TestCollectionConfig)


@dataclass
class StaticDatasetConfig:
    path: Optional[str] = None
    ignore_sample_weights: bool = True


@dataclass
class TrainingLoopConfig:
    """trainer.yaml ``training``. ``num_workers_data_loaders``: the host prefetcher's
    producer threads (0: synchronous), read only without the device store.
    ``wm_only``: train the world model alone (the denoiser and the upsampler), the
    two-stage world model's mode on a static dataset."""

    should: bool = True
    num_final_epochs: int = 50
    cache_in_ram: bool = True
    num_workers_data_loaders: int = 2
    model_free: bool = False
    wm_only: bool = False


@dataclass
class EvaluationConfig:
    should: bool = True
    every: int = 10


@dataclass
class EnvSplitConfig:
    id: str = "BreakoutNoFrameskip-v4"
    done_on_life_loss: bool = True
    size: int = IMG_SIZE
    max_episode_steps: Optional[int] = None


@dataclass
class EnvConfig:
    """configs/env/atari.yaml; ``env_group("fake")`` gives fake.yaml's."""

    train: EnvSplitConfig = field(default_factory=EnvSplitConfig)
    test: EnvSplitConfig = field(default_factory=lambda: EnvSplitConfig(done_on_life_loss=False))
    keymap: str = "atari/BreakoutNoFrameskip-v4"


# ---------------------------------------------------------------------------
# The root config and its overrides


@dataclass
class Config:
    """trainer.yaml as the port reads it: ``agent`` is the chosen agent group (its
    ``num_actions`` is set from the env by the trainer), ``env`` the chosen env group."""

    wandb: WandbConfig = field(default_factory=WandbConfig)
    initialization: InitializationConfig = field(default_factory=InitializationConfig)
    common: CommonConfig = field(default_factory=CommonConfig)
    checkpointing: CheckpointingConfig = field(default_factory=CheckpointingConfig)
    collection: CollectionConfig = field(default_factory=CollectionConfig)
    static_dataset: StaticDatasetConfig = field(default_factory=StaticDatasetConfig)
    training: TrainingLoopConfig = field(default_factory=TrainingLoopConfig)
    tpu: RuntimeConfig = field(default_factory=RuntimeConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    world_model_env: WorldModelEnvConfig = field(default_factory=WorldModelEnvConfig)
    denoiser: DenoiserTrainerConfig = field(default_factory=DenoiserTrainerConfig)
    upsampler: UpsamplerTrainerConfig = field(default_factory=UpsamplerTrainerConfig)
    rew_end_model: RewEndTrainerConfig = field(default_factory=RewEndTrainerConfig)
    actor_critic: ActorCriticTrainerConfig = field(default_factory=ActorCriticTrainerConfig)
    env: EnvConfig = field(default_factory=EnvConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


ENV_GROUPS = ("atari", "fake")
AGENT_GROUPS = ("csgo", "default")


# (target, source): the YAML interpolations, applied after the overrides unless an
# override set the target (trainer.yaml:160, 165, 179, 183, 196; agent/*.yaml; env/*).
# The models' frame size is derived apart (``derive``): it is divided by the
# upsampler's factor under agent=csgo.
DERIVED = (
    ("upsampler.training.sample_weights", "denoiser.training.sample_weights"),
    ("rew_end_model.training.sample_weights", "denoiser.training.sample_weights"),
    ("actor_critic.training.sample_weights", "denoiser.training.sample_weights"),
    ("agent.rew_end_model.img_channels", "agent.denoiser.inner_model.img_channels"),
    ("agent.actor_critic.img_channels", "agent.denoiser.inner_model.img_channels"),
    ("env.test.id", "env.train.id"),
    ("env.test.size", "env.train.size"),
)


def env_group(name: str) -> EnvConfig:
    """The env group's defaults (configs/env/<name>.yaml)."""
    if name == "atari":
        return EnvConfig()
    if name == "fake":
        return EnvConfig(
            train=EnvSplitConfig(id="Fake-v0", done_on_life_loss=False, max_episode_steps=100),
            test=EnvSplitConfig(id="Fake-v0", done_on_life_loss=False, max_episode_steps=100),
            keymap="fake")
    raise ValueError(f"Unknown env group option {name!r}; available: {list(ENV_GROUPS)}")


def agent_group(name: str) -> AgentConfig:
    """The agent group's defaults (configs/agent/<name>.yaml): the DIAMOND Atari agent,
    or with ``csgo`` the same three models and the upsampler."""
    if name == "default":
        return AgentConfig()
    if name == "csgo":
        return AgentConfig(upsampler=csgo_upsampler())
    raise ValueError(f"Unknown agent group option {name!r}; available: {list(AGENT_GROUPS)}")


def parse_value(raw: str) -> Any:
    """A CLI value: a Python literal, YAML's null/true/false (any case), else the
    string itself."""
    raw = raw.strip()
    low = raw.lower()
    if low in ("null", "none", "~"):
        return None
    if low in ("true", "false"):
        return low == "true"
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _get(cfg: Any, path: str) -> Any:
    node = cfg
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, list) else getattr(node, part)
    return node


def _set(cfg: Any, path: str, value: Any) -> None:
    *parents, leaf = path.split(".")
    try:
        node = _get(cfg, ".".join(parents)) if parents else cfg
    except (AttributeError, IndexError, ValueError):
        raise KeyError(f"Override targets unknown config key {path!r}") from None
    if isinstance(node, list):
        node[int(leaf)] = value
        return
    if not is_dataclass(node) or leaf not in {f.name for f in fields(node)}:
        raise KeyError(f"Override targets unknown config key {path!r}")
    if is_dataclass(getattr(node, leaf)):
        raise KeyError(f"Override {path!r} names a section; set its keys one by one")
    setattr(node, leaf, value)


# The sections that are None by default, and what builds one where a saved config sets
# it (agent.upsampler, under agent=csgo).
OPTIONAL_SECTIONS = {"upsampler": csgo_upsampler}


def apply_dict(cfg: Any, d: Dict[str, Any]) -> Any:
    """Set a nested dict's values onto a config in place (the saved JSON onto the
    defaults), each section's derived values derived again."""
    for k, v in d.items():
        cur = getattr(cfg, k)
        if cur is None and v is not None and k in OPTIONAL_SECTIONS:
            cur = OPTIONAL_SECTIONS[k]()
            setattr(cfg, k, cur)
        if is_dataclass(cur):
            apply_dict(cur, v)
        else:
            setattr(cfg, k, v)
    if hasattr(cfg, "__post_init__"):
        cfg.__post_init__()
    return cfg


def load_config(overrides: Sequence[str] = (), base: Optional[Dict[str, Any]] = None
                ) -> Config:
    """The config of ``overrides`` (``key=value`` strings, group choices included).
    ``base``: a saved, resolved config (a resumed run's) to start from instead of the
    defaults; nothing is derived then, as a resolved YAML derives nothing again."""
    group_env, group_agent = "atari", "default"
    values = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        key, raw = key.strip().lstrip("+"), raw.strip()
        if key == "env":
            env_group(raw)  # refuses an unknown group
            group_env = raw
        elif key == "agent":
            agent_group(raw)
            group_agent = raw
        else:
            values.append((key, parse_value(raw)))

    cfg = Config()
    if base is not None:
        apply_dict(cfg, copy.deepcopy(base))
    else:
        cfg.env = env_group(group_env)
        cfg.agent = agent_group(group_agent)
    for key, value in values:
        _set(cfg, key, copy.deepcopy(value))
    if base is None:
        derive(cfg, {k for k, _ in values}, group_env)
    cfg.agent.__post_init__()
    return cfg


def derive(cfg: Config, overridden: set, group_env: str) -> None:
    """The YAML's interpolated values, from their sources, where no override set them."""
    targets = list(DERIVED)
    if group_env == "fake":
        targets.append(("env.test.max_episode_steps", "env.train.max_episode_steps"))
    for target, source in targets:
        if target not in overridden:
            _set(cfg, target, copy.deepcopy(_get(cfg, source)))
    low_res = cfg.env.train.size // cfg.agent.downsample_factor  # agent/csgo.yaml
    for target in ("agent.rew_end_model.img_size", "agent.actor_critic.img_size"):
        if target not in overridden:
            _set(cfg, target, low_res)
    if "rew_end_model.training.seq_length" not in overridden:
        cfg.rew_end_model.training.seq_length = (
            cfg.world_model_env.horizon + cfg.agent.denoiser.inner_model.num_steps_conditioning)
    if "env.keymap" not in overridden and group_env == "atari":
        cfg.env.keymap = f"atari/{cfg.env.train.id}"


def save_config(cfg: Config, path: Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg.to_dict(), indent=1))


def read_config(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
