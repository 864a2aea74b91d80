"""Train steps (diamond_tpu/training.py): ``(state, inputs) -> (state, metrics)``, the
gradient, the clipping, the AdamW update and the LR schedule on the device, with no
host-device synchronisation. Every step takes gradient accumulation (``grad_acc_steps``
> 1, the trainer's ``optax.MultiSteps``; ``apply_update``).

The denoiser step takes the autoregressive EDM loss (models/denoiser.py ``loss``) of a
batch of uint8 segments over its ``T - n`` windows and backpropagates it through the
U-Net on the hand-written backward kernels: K1's and K2's (the norms), K3's data and
weight gradients (the 3x3 convs, the stride-2 Downsample included).

The actor-critic step embeds the whole ``backup_every``-step imagination rollout
(envs/world_model_env.py) in one differentiated step: the world model runs with no
grad, the policy's trunk and heads with grad, and one backward pass takes the REINFORCE
+ value + entropy loss of the rollout into the actor-critic's parameters through the
hand-written backward kernels (K2's, K3's data and weight gradients).

The rew/end step takes the masked cross-entropy loss of a batch of segments
(models/rew_end_model.py ``loss``, with the final-obs swap) and backpropagates it
through the encoder on the same kernels (K1's and K2's backwards, K3's data and weight
gradients; ``conv_in``'s input needs no data gradient) and through the LSTM and heads
in plain autograd. The model-free actor-critic step recomputes the policy over recorded
uint8 observations: the conv trunk encodes all B * T frames in one call (it has no
recurrence, and its norms are per sample, so the numbers are those of one call a
step), then the LSTM head runs step by step with its carry gated by 1 - reset_mask.

The two-stage world model: the denoiser step with ``downsample_factor`` f > 1 trains the
dynamics denoiser on its segments' area downsample by f, snapped to the uint8 grid
(``_two_stage_obs``, what the stateful env's buffers hold), inside the step; the
upsampler step takes ``Denoiser.loss_upsampler`` of the full-resolution frames, time
folded into batch, through the same kernels.

Data parallelism (parallel/mesh.py) keeps the JAX package's global semantics: the
optimizer's ``dp`` sums each step's gradient over the ranks before the clip; a step takes
its rank's rows of a global batch (``DeviceBatch.mask_global`` beside them) and divides
its masked sums by the global counts; draws have global shapes, and each rank takes its
rows. Without a process group every step is the single-card path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from .config import ActorCriticLossConfig, SigmaDistributionConfig
from .data.episode import obs_to_float
from .data.segment import DeviceBatch
from .envs.world_model_env import ICPool, ImagState, ImaginationEngine, RolloutDraws
from .models.actor_critic import ActorCritic
from .models.agent import AdamWClip, configure_opt
from .models.denoiser import (Denoiser, DenoiserDraws, downsample_avg, draw_loss_noise,
                              quantize_to_uint8_grid)
from .models.rew_end_model import RewEndModel
from .parallel.mesh import DataParallel


@dataclass
class TrainState:
    """One model's optimization state: the module whose parameters are trained, its
    torch optimizer (the AdamW moments), and the steps made so far. ``step`` counts the
    calls of the train step (micro-steps under gradient accumulation, as the JAX
    package's ``state.step``); the LR warmup counts the optimizer's updates, step // k.
    It stays on the host, so setting the learning rate waits for nothing (the JAX
    package keeps it on the device inside jit). ``acc``: the running mean of the
    micro-gradients under gradient accumulation, else None."""

    net: nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0
    acc: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, net: nn.Module, tx: AdamWClip) -> "TrainState":
        return cls(net=net, opt_state=tx.init(net), step=0)


@dataclass
class OptimizerSpec:
    lr: float
    weight_decay: float
    eps: float
    max_grad_norm: Optional[float]
    lr_warmup_steps: int
    grad_acc_steps: int = 1
    grad_acc_sum: bool = False

    @classmethod
    def from_cfg(cls, opt_cfg: Any, train_cfg: Any, grad_acc_sum: bool = False
                 ) -> "OptimizerSpec":
        """From the config's ``<model>.optimizer`` and ``<model>.training`` sections and
        ``tpu.grad_acc_sum`` (``RuntimeConfig``)."""
        return cls(lr=float(opt_cfg.lr), weight_decay=float(opt_cfg.weight_decay),
                   eps=float(opt_cfg.eps), max_grad_norm=train_cfg.max_grad_norm,
                   lr_warmup_steps=int(train_cfg.lr_warmup_steps),
                   grad_acc_steps=int(train_cfg.grad_acc_steps), grad_acc_sum=grad_acc_sum)

    def lr_at(self, step: int) -> float:
        """The logged learning rate of micro-step ``step`` (the JAX package's
        ``OptimizerSpec.lr_at``)."""
        if self.lr_warmup_steps > 0:
            return self.lr * min(1.0, step / self.lr_warmup_steps)
        return self.lr

    def build(self, dp: Optional[DataParallel] = None) -> AdamWClip:
        return configure_opt(self.lr, self.weight_decay, self.eps, self.max_grad_norm,
                             self.lr_warmup_steps, self.grad_acc_steps, self.grad_acc_sum, dp)


def apply_update(tx: AdamWClip, state: TrainState) -> Tuple[TrainState, torch.Tensor]:
    """One train step's update from the gradients in the parameters' ``.grad`` (summed
    over the ranks first under data parallelism): the chain's update, or under gradient
    accumulation the micro-step (``AdamWClip.accumulate``). Returns the new state and
    the global norm of this step's gradient before clipping (on the device), as the JAX
    package's ``_apply_update`` reports it."""
    if tx.grad_acc_steps == 1:
        grad_norm = tx.update(state.opt_state, state.step)
    else:
        state.acc, grad_norm = tx.accumulate(state.opt_state, state.acc, state.step)
    state.step += 1
    return state, grad_norm


def _count_mask(batch: DeviceBatch, dp: DataParallel) -> Optional[torch.Tensor]:
    """The mask a step's loss counts by where the batch holds one rank's rows of a global
    batch (None: the batch's own)."""
    if dp.world > 1 and batch.mask_global is None:
        raise ValueError("a data-parallel step needs the global batch's mask beside its "
                         "rows (DeviceBatch.mask_global; parallel.shard_device_batch)")
    return batch.mask_global


def _rank_draws(draws: Optional[DenoiserDraws], windows: int, b: int, hwc: Tuple[int, ...],
                generator: Optional[torch.Generator], device, dp: DataParallel
                ) -> DenoiserDraws:
    """A diffusion loss's draws at the global batch of world * ``b`` (given, else drawn
    from ``generator``), this rank's rows of them."""
    if draws is None:
        draws = draw_loss_noise(windows, b * dp.world, hwc, generator, device)
    return DenoiserDraws(*(dp.take(x, 1) for x in draws))


# ---------------------------------------------------------------------------
# Denoiser


def _two_stage_obs(obs_u8: torch.Tensor, downsample_factor: int) -> torch.Tensor:
    """The dynamics model's view of uint8 frames: as floats, and with ``downsample_factor``
    > 1 (the two-stage world model) their area downsample snapped to the uint8 grid, as
    the rollout's conditioning buffers hold them."""
    obs = obs_to_float(obs_u8)
    if downsample_factor == 1:
        return obs
    return quantize_to_uint8_grid(downsample_avg(obs, downsample_factor))


def _denoiser_loss(denoiser: Denoiser, sigma_cfg: SigmaDistributionConfig,
                   downsample_factor: int) -> Callable:
    def loss_fn(batch: DeviceBatch, draws: Optional[DenoiserDraws],
                generator: Optional[torch.Generator], dp: Optional[DataParallel] = None):
        obs = _two_stage_obs(batch.obs, downsample_factor)
        count_mask = None
        if dp is not None:
            n = denoiser.cfg.inner_model.num_steps_conditioning
            b, t = obs.shape[:2]
            draws = _rank_draws(draws, t - n, b, tuple(obs.shape[2:]), generator, obs.device,
                                dp)
            count_mask = _count_mask(batch, dp)
        return denoiser.loss(obs, batch.act, batch.mask_padding, sigma_cfg, draws, generator,
                             count_mask)

    return loss_fn


def _upsampler_loss(upsampler: Denoiser, sigma_cfg: SigmaDistributionConfig) -> Callable:
    def loss_fn(batch: DeviceBatch, draws: Optional[DenoiserDraws],
                generator: Optional[torch.Generator], dp: Optional[DataParallel] = None):
        obs = obs_to_float(batch.obs)
        count_mask = None
        if dp is not None:  # time folds into batch: a rank's frames are contiguous
            b, t = obs.shape[:2]
            draws = _rank_draws(draws, 1, b * t, tuple(obs.shape[2:]), generator, obs.device,
                                dp)
            count_mask = _count_mask(batch, dp)
        return upsampler.loss_upsampler(obs, batch.mask_padding, sigma_cfg, draws, generator,
                                        count_mask)

    return loss_fn


def _make_diffusion_step(model: Denoiser, tx: AdamWClip, loss_fn: Callable,
                         what: str) -> Callable:
    def step(state: TrainState, batch: DeviceBatch, draws: Optional[DenoiserDraws] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.net is not model.inner_model:
            raise ValueError(f"{what}: state.net must be the model's inner model")
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = loss_fn(batch, draws, generator, tx.dp)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, metrics

    return step


def _make_eval_step(loss_fn: Callable) -> Callable:
    def step(batch: DeviceBatch, draws: Optional[DenoiserDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return loss_fn(batch, draws, generator)[1]

    return step


def make_denoiser_train_step(denoiser: Denoiser, tx: AdamWClip,
                             sigma_cfg: SigmaDistributionConfig,
                             downsample_factor: int = 1) -> Callable:
    """The denoiser step: ``step(state, batch, draws=None, generator=None) -> (state,
    metrics)``. It takes ``denoiser.loss`` of the uint8 segments in ``batch`` (random
    numbers from ``draws``, else from ``generator``), backpropagates it into
    ``state.net`` (the denoiser's inner model) and updates it. Under data parallelism
    (``tx.dp``) ``batch`` is the rank's rows of the global batch (with ``mask_global``)
    and ``draws`` the global batch's. The metrics
    (``loss_denoising``, ``grad_norm_before_clip``) stay on the device.
    ``downsample_factor`` > 1 (the two-stage world model): the loss takes the frames'
    area downsample (``_two_stage_obs``), made in the step."""
    return _make_diffusion_step(denoiser, tx, _denoiser_loss(denoiser, sigma_cfg,
                                                             downsample_factor),
                                "make_denoiser_train_step")


def make_denoiser_eval_step(denoiser: Denoiser, sigma_cfg: SigmaDistributionConfig,
                            downsample_factor: int = 1) -> Callable:
    """``step(batch, draws=None, generator=None) -> metrics``: the training loss of a
    batch under no grad (``loss_denoising``, on the device)."""
    return _make_eval_step(_denoiser_loss(denoiser, sigma_cfg, downsample_factor))


# ---------------------------------------------------------------------------
# Upsampler (the two-stage world model)


def make_upsampler_train_step(upsampler: Denoiser, tx: AdamWClip,
                              sigma_cfg: SigmaDistributionConfig) -> Callable:
    """The upsampler step: ``step(state, batch, draws=None, generator=None) -> (state,
    metrics)``. It takes ``upsampler.loss_upsampler`` of the full-resolution uint8
    segments in ``batch`` (B x T frames, one window of ``DenoiserDraws``), backpropagates
    it into ``state.net`` (the upsampler's inner model) and updates it; the metrics
    (``loss_denoising``, ``grad_norm_before_clip``) stay on the device."""
    return _make_diffusion_step(upsampler, tx, _upsampler_loss(upsampler, sigma_cfg),
                                "make_upsampler_train_step")


def make_upsampler_eval_step(upsampler: Denoiser, sigma_cfg: SigmaDistributionConfig
                             ) -> Callable:
    """``step(batch, draws=None, generator=None) -> metrics``: the upsampler's loss of a
    batch under no grad."""
    return _make_eval_step(_upsampler_loss(upsampler, sigma_cfg))


# ---------------------------------------------------------------------------
# Reward/end model


def _rew_end_loss(rew_end_model: RewEndModel, batch: DeviceBatch):
    return rew_end_model.loss(obs_to_float(batch.obs), batch.act, batch.rew, batch.end,
                              batch.mask_padding, obs_to_float(batch.final_obs),
                              batch.has_final_obs, batch.mask_global)


def make_rew_end_train_step(rew_end_model: RewEndModel, tx: AdamWClip) -> Callable:
    """The rew/end step: ``step(state, batch) -> (state, metrics)``. It takes
    ``rew_end_model.loss`` of the segments in ``batch`` (the final-obs swap included),
    backpropagates it into ``state.net`` (the rew/end model's module) and updates it.
    The metrics (``loss_rew``, ``loss_end``, ``loss_total``, ``confusion_matrix``,
    ``grad_norm_before_clip``) stay on the device. Under data parallelism (``tx.dp``)
    ``batch`` is the rank's rows of the global batch, with ``mask_global``."""

    def step(state: TrainState, batch: DeviceBatch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        if state.net is not rew_end_model.net:
            raise ValueError("make_rew_end_train_step: state.net must be the rew/end model's "
                             "module")
        _count_mask(batch, tx.dp)
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = _rew_end_loss(rew_end_model, batch)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, metrics

    return step


def make_rew_end_eval_step(rew_end_model: RewEndModel) -> Callable:
    """``step(batch) -> metrics``: the rew/end loss's metrics of a batch under no grad
    (on the device)."""

    def step(batch: DeviceBatch) -> Dict[str, Any]:
        with torch.no_grad():
            return _rew_end_loss(rew_end_model, batch)[1]

    return step


# ---------------------------------------------------------------------------
# Actor-critic


def ac_rollout_loss(engine: ImaginationEngine, actor_critic: ActorCritic,
                    loss_cfg: ActorCriticLossConfig, st: ImagState, pool: ICPool,
                    draws: Optional[RolloutDraws] = None,
                    generator: Optional[torch.Generator] = None):
    """The actor-critic step's loss (training.py:185-193 of the JAX package): roll
    ``loss_cfg.backup_every`` imagined steps from ``st`` with the policy in the loop and
    take the REINFORCE + value + entropy loss of the trajectory. Where grad is enabled
    the loss carries the graph into the actor-critic's parameters. Under data
    parallelism (``engine.dp``) ``st`` holds the rank's env rows, ``draws`` are the
    global batch's and the loss is the rank's share of the global mean. Returns (loss,
    metrics, st, pool, trajectory)."""
    traj, st, pool = engine.rollout(st, pool, loss_cfg.backup_every, draws=draws,
                                    generator=generator)
    loss, metrics = actor_critic.loss_from_rollout(
        traj["act"], traj["rew"], traj["end"].float(), traj["trunc"].float(),
        traj["logits_act"], traj["val"], traj["val_bootstrap"], loss_cfg,
        traj["act"].numel() * engine.dp.world)
    metrics["imagination_deaths"] = traj["dead"].sum()
    return loss, metrics, st, pool, traj


def make_ac_train_step(engine: ImaginationEngine, actor_critic: ActorCritic, tx: AdamWClip,
                       loss_cfg: ActorCriticLossConfig) -> Callable:
    """The actor-critic step: ``step(state, st, pool, draws=None, generator=None) ->
    (state, st, pool, metrics)``. It takes ``ac_rollout_loss`` from ``st`` (random
    numbers from ``draws``, else from ``generator``), backpropagates it into
    ``state.net`` (the actor-critic's module) and updates it. The metrics (the loss
    terms, ``imagination_deaths``, ``grad_norm_before_clip``) stay on the device; the
    returned ``st`` carries no graph."""

    def step(state: TrainState, st: ImagState, pool: ICPool,
             draws: Optional[RolloutDraws] = None, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, ImagState, ICPool, Dict[str, torch.Tensor]]:
        if state.net is not actor_critic.net:
            raise ValueError("make_ac_train_step: state.net must be the actor-critic's module")
        if engine.dp.group is not tx.dp.group:
            raise ValueError("make_ac_train_step: the engine and the optimizer must be in one "
                             "process group")
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics, st, pool, _ = ac_rollout_loss(engine, actor_critic, loss_cfg, st,
                                                         pool, draws, generator)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, st, pool, metrics

    return step


# ---------------------------------------------------------------------------
# Actor-critic, model-free (training.model_free)


def model_free_ac_loss(actor_critic: ActorCritic, loss_cfg: ActorCriticLossConfig,
                       obs_u8: torch.Tensor, act: torch.Tensor, rew: torch.Tensor,
                       end: torch.Tensor, trunc: torch.Tensor, reset_mask: torch.Tensor,
                       hx0: torch.Tensor, cx0: torch.Tensor, val_bootstrap: torch.Tensor,
                       count: Optional[int] = None):
    """The model-free step's loss (training.py:212-253 of the JAX package): the policy
    recomputed over the recorded frames obs_u8 (B, T, H, W, C) uint8 from the carry
    (hx0, cx0), the carry multiplied by 1 - reset_mask[:, t] before step t, and the
    REINFORCE + value + entropy loss with the recorded ``val_bootstrap``, its means over
    ``count`` (B * T by default). The trunk encodes all B * T frames in one call.
    Returns (loss, metrics)."""
    b, t = obs_u8.shape[:2]
    feats = actor_critic.encode(obs_to_float(obs_u8.reshape(b * t, *obs_u8.shape[2:])))
    feats = feats.reshape(b, t, -1)
    carry = (hx0, cx0)
    logits, vals = [], []
    for i in range(t):
        gate = 1.0 - reset_mask[:, i].float()[:, None]
        out = actor_critic.head(feats[:, i], (carry[0] * gate, carry[1] * gate))
        carry = out.carry
        logits.append(out.logits_act)
        vals.append(out.val)
    return actor_critic.loss_from_rollout(act, rew, end.float(), trunc.float(),
                                          torch.stack(logits, dim=1), torch.stack(vals, dim=1),
                                          val_bootstrap, loss_cfg, count)


def make_model_free_ac_train_step(actor_critic: ActorCritic, tx: AdamWClip,
                                  loss_cfg: ActorCriticLossConfig) -> Callable:
    """The model-free actor-critic step: ``step(state, obs_u8, act, rew, end, trunc,
    reset_mask, hx0, cx0, val_bootstrap) -> (state, metrics)`` on tensors the env loop
    recorded (all (B, T) but obs_u8 (B, T, H, W, C) and the carry (B, lstm_dim)). It
    takes ``model_free_ac_loss``, backpropagates it into ``state.net`` (the
    actor-critic's module) and updates it; the metrics stay on the device. Under data
    parallelism (``tx.dp``) the tensors are the rank's rows of the global batch."""

    def step(state: TrainState, obs_u8: torch.Tensor, act: torch.Tensor, rew: torch.Tensor,
             end: torch.Tensor, trunc: torch.Tensor, reset_mask: torch.Tensor,
             hx0: torch.Tensor, cx0: torch.Tensor, val_bootstrap: torch.Tensor
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.net is not actor_critic.net:
            raise ValueError("make_model_free_ac_train_step: state.net must be the "
                             "actor-critic's module")
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = model_free_ac_loss(actor_critic, loss_cfg, obs_u8, act, rew, end,
                                               trunc, reset_mask, hx0, cx0, val_bootstrap,
                                               act.numel() * tx.dp.world)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, metrics

    return step
