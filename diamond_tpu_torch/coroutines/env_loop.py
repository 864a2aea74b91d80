"""The rollout loop over a host-side vector env, driving the policy on the card
(diamond_tpu/coroutines/env_loop.py): real-env collection and the model-free train
step's recordings.

Semantics kept from the JAX package:
  * the policy's LSTM state is carried across sends; an env that died at the previous
    step starts from a zero state (the reset gate);
  * epsilon-greedy: one uniform draw flips the whole batch to random actions by
    default, one per env with ``epsilon_per_env``;
  * on a death, the value of the true final frame (``info["final_observation"]``) is
    taken with the PRE-reset LSTM state and becomes that step's bootstrap; the next
    step's value is the bootstrap elsewhere, and a last value call (no state update)
    gives the final step's;
  * world-model resets (``info["burnin_obs"]``) replay the new context frames through
    the policy from a zero state.

Per step the card gets the frames (uint8) and the reset mask, and sends back one tensor,
the actions; the logits, values and bootstraps stay on the card and are stacked after
the loop (``send`` returns them as device tensors, or None with ``need_values=False``).

The draws of step s are a Gumbel (B, num_actions) for the categorical (argmax(logits +
Gumbel)), a uniform (() or (B,)) for epsilon and an integer (B,) for the random action,
made by ``draw(step, batch, num_actions)``: by default from a ``torch.Generator`` on the
policy's device; a test replaces ``draw`` to inject them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.episode import obs_to_float
from ..envs.world_model_env import gumbel
from ..models.actor_critic import ActorCritic, ActorCriticOutput
from ..utils import to_device


class EnvLoop:
    def __init__(self, env: Any, actor_critic: ActorCritic, epsilon: float = 0.0,
                 seed: Optional[int] = None, epsilon_per_env: bool = False) -> None:
        self.env = env
        self.ac = actor_critic
        self.epsilon = float(epsilon)
        self.epsilon_per_env = bool(epsilon_per_env)
        self.device = next(actor_critic.net.parameters()).device
        self._rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else int(self._rng.integers(0, 2 ** 31 - 1)))
        self._step_count = 0
        self._state: Optional[Tuple] = None
        self.last_extras: Dict[str, Any] = {}

    # -- the policy on the card -------------------------------------------------

    def draw(self, step: int, batch: int, num_actions: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(Gumbel (B, A), uniform (() or (B,)), random action (B,)) of step ``step``."""
        g = self.generator
        u_shape = (batch,) if self.epsilon_per_env else ()
        return (gumbel((batch, num_actions), g, self.device),
                torch.rand(u_shape, generator=g, device=self.device),
                torch.randint(0, num_actions, (batch,), generator=g, device=self.device))

    def _act_value(self, obs_u8: torch.Tensor, carry) -> ActorCriticOutput:
        return self.ac.head(self.ac.encode(obs_to_float(obs_u8)), carry)

    @torch.no_grad()
    def _policy_step(self, obs_u8, hx, cx, reset_mask, step: int):
        gate = 1.0 - reset_mask.float()[:, None]
        out = self._act_value(obs_u8, (hx * gate, cx * gate))
        b, a = out.logits_act.shape
        g, u, rand_act = self.draw(step, b, a)
        act = torch.argmax(out.logits_act + g, dim=-1)
        act = torch.where(u < self.epsilon, rand_act, act)
        return act, out.logits_act, out.val, out.carry[0], out.carry[1]

    @torch.no_grad()
    def _value_only(self, obs_u8, hx, cx) -> torch.Tensor:
        """The value of ``obs_u8`` without updating the state."""
        return self._act_value(obs_u8, (hx, cx)).val

    @torch.no_grad()
    def _burnin(self, burnin_obs_u8, hx, cx):
        """Replay the conditioning frames (B, K, H, W, C) through the policy."""
        carry = (hx, cx)
        for k in range(burnin_obs_u8.shape[1]):
            carry = self._act_value(burnin_obs_u8[:, k], carry).carry
        return carry

    # -- the loop ---------------------------------------------------------------

    def reset(self) -> None:
        """Reset the env (per-env seeds) and zero the LSTM state."""
        b = self.env.num_envs
        d = self.ac.cfg.lstm_dim
        seed = int(self._rng.integers(0, 2 ** 31 - 1))
        obs, _ = self.env.reset(seed=[seed + i for i in range(b)])
        hx = torch.zeros((b, d), device=self.device)
        cx = torch.zeros((b, d), device=self.device)
        self._state = (obs, hx, cx, np.zeros(b, bool))

    def send(self, num_steps: int, need_values: bool = True) -> Tuple:
        """Step the env ``num_steps`` times. Returns (obs, act, rew, end, trunc) stacked
        (B, T, ...) in numpy, then logits_act (B, T, A), val and val_bootstrap (B, T) as
        tensors on the card (None with ``need_values=False``: collection reads none of
        them, and skips the value calls), then the list of infos. ``last_extras`` holds
        the send's initial LSTM state (``hx0``, ``cx0``, on the card) and the reset mask
        of each step (``reset_mask`` (B, T) bool), enough to recompute the policy's
        forward (the model-free step)."""
        if self._state is None:
            self.reset()
        obs, hx, cx, prev_dead = self._state
        dev = self.device
        b = self.env.num_envs
        zeros_b = torch.zeros((b,), device=dev)
        extras: Dict[str, Any] = {"hx0": hx, "cx0": cx, "reset_mask": []}
        steps_host: List[List[Any]] = []
        infos: List[Dict[str, Any]] = []
        logits_l, vals_l, finals_l, dead_l = [], [], [], []

        for _ in range(num_steps):
            extras["reset_mask"].append(np.asarray(prev_dead))
            act, logits, val, hx, cx = self._policy_step(
                to_device(obs, dev), hx, cx, to_device(np.asarray(prev_dead), dev),
                self._step_count)
            self._step_count += 1
            act_np = act.cpu().numpy()  # the one copy to the host per step

            next_obs, rew, end, trunc, info = self.env.step(act_np)
            dead = np.asarray(end) | np.asarray(trunc)

            val_final = zeros_b
            if dead.any():
                if need_values:
                    # the true final frame's value, with the pre-reset state
                    final_full = np.array(next_obs, copy=True) \
                        if isinstance(next_obs, np.ndarray) else next_obs.clone()
                    final_full[dead] = info["final_observation"]
                    val_final = self._value_only(to_device(final_full, dev), hx, cx)
                if "burnin_obs" in info:
                    gate = to_device(~dead, dev).float()[:, None]
                    bh, bc = self._burnin(to_device(info["burnin_obs"], dev), hx * gate,
                                          cx * gate)
                    mask = to_device(dead, dev)[:, None]
                    hx, cx = torch.where(mask, bh, hx), torch.where(mask, bc, cx)

            steps_host.append([obs, act_np, np.asarray(rew), np.asarray(end, np.uint8),
                               np.asarray(trunc, np.uint8)])
            if need_values:
                logits_l.append(logits)
                vals_l.append(val)
                finals_l.append(val_final)
            dead_l.append(dead)
            infos.append(info)
            obs = next_obs
            prev_dead = dead

        logits_t = val_t = boot_t = None
        if need_values:
            val_extra = self._value_only(to_device(obs, dev), hx, cx)
            val_t = torch.stack(vals_l, dim=1)
            val_next = torch.cat([val_t[:, 1:], val_extra[:, None]], dim=1)
            dead_t = to_device(np.stack(dead_l, axis=1), dev)
            boot_t = torch.where(dead_t, torch.stack(finals_l, dim=1), val_next)
            logits_t = torch.stack(logits_l, dim=1)

        self._state = (obs, hx, cx, prev_dead)
        extras["reset_mask"] = np.stack(extras["reset_mask"], axis=1)
        self.last_extras = extras
        obs_s, act_s, rew_s, end_s, trunc_s = (
            np.stack([np.asarray(s[i]) for s in steps_host], axis=1) for i in range(5))
        return obs_s, act_s, rew_s, end_s, trunc_s, logits_t, val_t, boot_t, infos
