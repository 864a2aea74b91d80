"""Train steps (diamond_tpu/training.py): ``(state, inputs) -> (state, metrics)``, the
gradient, the clipping, the AdamW update and the LR schedule on the device, with no
host-device synchronisation.

The denoiser step takes the autoregressive EDM loss (models/denoiser.py ``loss``) of a
batch of uint8 segments over its ``T - n`` windows and backpropagates it through the
U-Net on the hand-written backward kernels: K1's and K2's (the norms), K3's data and
weight gradients (the 3x3 convs, the stride-2 Downsample included).

The actor-critic step embeds the whole ``backup_every``-step imagination rollout
(envs/world_model_env.py) in one differentiated step: the world model runs with no
grad, the policy's trunk and heads with grad, and one backward pass takes the REINFORCE
+ value + entropy loss of the rollout into the actor-critic's parameters through the
hand-written backward kernels (K2's, K3's data and weight gradients).

Not ported yet: gradient accumulation (``grad_acc_steps`` > 1, optax ``MultiSteps``),
the model-free AC step, the rew/end step and the two-stage (upsampler) denoiser.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .config import ActorCriticLossConfig, SigmaDistributionConfig
from .data.episode import obs_to_float
from .data.segment import DeviceBatch
from .envs.world_model_env import ICPool, ImagState, ImaginationEngine, RolloutDraws
from .models.actor_critic import ActorCritic
from .models.agent import AdamWClip, configure_opt
from .models.denoiser import Denoiser, DenoiserDraws


@dataclass
class TrainState:
    """One model's optimization state: the module whose parameters are trained, its
    torch optimizer (the AdamW moments), and the updates made so far. ``step`` drives
    the LR warmup and stays on the host, so setting the learning rate waits for nothing
    (the JAX package keeps it on the device inside jit)."""

    net: nn.Module
    opt_state: torch.optim.Optimizer
    step: int = 0

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

    @classmethod
    def from_cfg(cls, opt_cfg: Any, train_cfg: Any) -> "OptimizerSpec":
        """From the config's ``<model>.optimizer`` and ``<model>.training`` sections."""
        if train_cfg.grad_acc_steps != 1:
            raise ValueError("grad_acc_steps > 1 is not ported yet")
        return cls(lr=float(opt_cfg.lr), weight_decay=float(opt_cfg.weight_decay),
                   eps=float(opt_cfg.eps), max_grad_norm=train_cfg.max_grad_norm,
                   lr_warmup_steps=int(train_cfg.lr_warmup_steps))

    def build(self) -> AdamWClip:
        return configure_opt(self.lr, self.weight_decay, self.eps, self.max_grad_norm,
                             self.lr_warmup_steps)


def apply_update(tx: AdamWClip, state: TrainState) -> Tuple[TrainState, torch.Tensor]:
    """One update from the gradients in the parameters' ``.grad``; returns the new state
    and the global gradient norm before clipping (on the device)."""
    grad_norm = tx.update(state.opt_state, state.step)
    state.step += 1
    return state, grad_norm


# ---------------------------------------------------------------------------
# Denoiser


def _denoiser_loss(denoiser: Denoiser, sigma_cfg: SigmaDistributionConfig,
                   downsample_factor: int) -> Callable:
    if downsample_factor != 1:
        raise ValueError("downsample_factor > 1 (the two-stage world model) is not ported yet")

    def loss_fn(batch: DeviceBatch, draws: Optional[DenoiserDraws],
                generator: Optional[torch.Generator]):
        return denoiser.loss(obs_to_float(batch.obs), batch.act, batch.mask_padding, sigma_cfg,
                             draws, generator)

    return loss_fn


def make_denoiser_train_step(denoiser: Denoiser, tx: AdamWClip,
                             sigma_cfg: SigmaDistributionConfig,
                             downsample_factor: int = 1) -> Callable:
    """The denoiser step: ``step(state, batch, draws=None, generator=None) -> (state,
    metrics)``. It takes ``denoiser.loss`` of the uint8 segments in ``batch`` (random
    numbers from ``draws``, else from ``generator``), backpropagates it into
    ``state.net`` (the denoiser's inner model) and updates it. The metrics
    (``loss_denoising``, ``grad_norm_before_clip``) stay on the device.
    ``downsample_factor`` > 1 (the two-stage world model) is refused."""
    loss_fn = _denoiser_loss(denoiser, sigma_cfg, downsample_factor)

    def step(state: TrainState, batch: DeviceBatch, draws: Optional[DenoiserDraws] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.net is not denoiser.inner_model:
            raise ValueError("make_denoiser_train_step: state.net must be the denoiser's "
                             "inner model")
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics = loss_fn(batch, draws, generator)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, metrics

    return step


def make_denoiser_eval_step(denoiser: Denoiser, sigma_cfg: SigmaDistributionConfig,
                            downsample_factor: int = 1) -> Callable:
    """``step(batch, draws=None, generator=None) -> metrics``: the training loss of a
    batch under no grad (``loss_denoising``, on the device)."""
    loss_fn = _denoiser_loss(denoiser, sigma_cfg, downsample_factor)

    def step(batch: DeviceBatch, draws: Optional[DenoiserDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return loss_fn(batch, draws, generator)[1]

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
    the loss carries the graph into the actor-critic's parameters. Returns (loss,
    metrics, st, pool, trajectory)."""
    traj, st, pool = engine.rollout(st, pool, loss_cfg.backup_every, draws=draws,
                                    generator=generator)
    loss, metrics = actor_critic.loss_from_rollout(
        traj["act"], traj["rew"], traj["end"].float(), traj["trunc"].float(),
        traj["logits_act"], traj["val"], traj["val_bootstrap"], loss_cfg)
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
        state.opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, metrics, st, pool, _ = ac_rollout_loss(engine, actor_critic, loss_cfg, st,
                                                         pool, draws, generator)
            loss.backward()
        state, grad_norm = apply_update(tx, state)
        metrics["grad_norm_before_clip"] = grad_norm
        return state, st, pool, metrics

    return step
