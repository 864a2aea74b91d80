"""Imagination MDP on the card: the world model as an environment
(diamond_tpu/envs/world_model_env.py).

One rollout step: policy step (conv trunk carried from the previous step, LSTMCell,
heads) -> diffusion sampler (``num_steps_denoising`` U-Net forwards) -> reward/end LSTM
step -> uint8 frame-buffer roll -> masked resets of dead envs from the initial-condition
pool, with the policy LSTM burned in over the new context. The world model always runs
with no grad; the policy's trunk, heads and burn-in carry the gradient into the
actor-critic (the AC train step, training.py), and the bootstrap values are detached.
A caller that only serves or measures the rollout runs it under ``torch.no_grad()``.

Every random draw of a rollout (the sampler's initial latents and the Gumbel noise of
the action, reward and end draws: categorical(logits) = argmax(logits + Gumbel)) is one
``RolloutDraws``, made from a ``torch.Generator`` on the rollout's device unless the
caller passes it; the same draws give the same trajectory.

The pool pointer is a device tensor and dead-env resets are gathers and ``where``s, so
a rollout step never waits on the host.

Data parallelism (``ImaginationEngine(dp=...)``, parallel/mesh.py): the state holds the
rank's env rows, the draws are the global batch's (each rank takes its rows), and the
pool is whole on every rank with one global pointer: a reset takes the exclusive prefix
count of deaths over the global batch (each rank's deaths assembled by one all_reduce),
and the pointer advances by the global count, the same on every rank. Each rank's
``PoolManager`` builds its pool from the same data, sampler seed and weights, with no
collective on its thread; at the swap the trainer takes rank 0's burned-in state
(``parallel.replicate_pool``).

The static int8 rollout (ops/quant.py) is structural: the sampler quantizes iff the
denoiser holds a calibrated collection, and the rew/end step enters the int8 scope iff
the rew/end model does. The IC burn-in (``make_ic_preparer``) never enters it.

``PoolManager`` keeps the rollout supplied with initial conditions: it builds a pool
from real segments of the dataset (gathered on the card from the device store, or
collated on the host without one), burns in the rew/end LSTM over them and, with
``policy_feats``, encodes their policy features; after each swap it builds the next
pool on a background thread. The weights a build reads are a snapshot: before each
build the live rew/end model's and actor-critic's state is copied, on the caller's
thread and in stream order before the next optimizer step, into the manager's own
copies of the two models, which only builds read. The build thread launches on the
default stream, so its kernels serialize with the train step's on the card.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import WorldModelEnvConfig
from ..data.episode import obs_to_float, obs_to_uint8
from ..models.actor_critic import ActorCritic
from ..models.denoiser import Denoiser
from ..models.diffusion_sampler import DiffusionSampler
from ..models.rew_end_model import RewEndModel
from ..ops import quant
from ..parallel.mesh import DataParallel


@dataclass
class ICPool:
    """Initial conditions: real conditioning segments + burned-in reward/end LSTM state.
    ``feats`` (tpu.pool_policy_feats): policy-trunk features of the conditioning frames,
    precomputed at pool build (``encode_pool_feats``); when None the rollout encodes the
    context of each reset."""

    obs: torch.Tensor   # (P, n_cond, H, W, C) uint8
    act: torch.Tensor   # (P, n_cond) int32
    hx: torch.Tensor    # (P, D) float32
    cx: torch.Tensor    # (P, D) float32
    ptr: torch.Tensor   # () int64 on the pool's device: next unconsumed entry
    feats: Optional[torch.Tensor] = None  # (P, n_cond, F)

    @property
    def size(self) -> int:
        return self.obs.shape[0]


@dataclass
class ImagState:
    """Per-env imagination state carried across rollouts."""

    obs_buffer: torch.Tensor  # (B, n_cond, H, W, C) uint8: every frame lies on the grid
    act_buffer: torch.Tensor  # (B, n_cond) int32
    re_hx: torch.Tensor       # (B, D) reward/end LSTM
    re_cx: torch.Tensor
    ac_hx: torch.Tensor       # (B, D) policy LSTM
    ac_cx: torch.Tensor
    ep_len: torch.Tensor      # (B,) int32


class RolloutDraws(NamedTuple):
    """The random numbers of a ``num_steps`` rollout, time first."""

    x_init: torch.Tensor      # (T, B, H, W, C) N(0, 1) initial latents of the sampler
    gumbel_act: torch.Tensor  # (T, B, num_actions)
    gumbel_rew: torch.Tensor  # (T, B, 3)
    gumbel_end: torch.Tensor  # (T, B, 2)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def draw_rollout_noise(num_steps: int, batch: int, frame_shape: Tuple[int, int, int],
                       num_actions: int, generator: torch.Generator,
                       device: torch.device) -> RolloutDraws:
    t, b = num_steps, batch
    return RolloutDraws(
        x_init=torch.randn((t, b, *frame_shape), generator=generator, device=device),
        gumbel_act=gumbel((t, b, num_actions), generator, device),
        gumbel_rew=gumbel((t, b, 3), generator, device),
        gumbel_end=gumbel((t, b, 2), generator, device))


@torch.no_grad()
def encode_pool_feats(actor_critic: ActorCritic, obs_u8: torch.Tensor) -> torch.Tensor:
    """Policy-trunk features of a pool's conditioning frames (ICPool.feats):
    (P, n_cond, H, W, C) uint8 -> (P, n_cond, F). Callers chunk the pool dimension."""
    p, t = obs_u8.shape[:2]
    flat = obs_to_float(obs_u8.reshape((p * t,) + tuple(obs_u8.shape[2:])))
    return actor_critic.encode(flat).reshape(p, t, -1)


def make_ic_preparer(rew_end_model: RewEndModel, chunk: int = 512):
    """Burn in the reward/end LSTM over the conditioning transitions of real segments.
    ``prepare(obs_u8 (N, n_cond, H, W, C), act (N, n_cond)) -> (hx, cx)``, at most
    ``chunk`` segments per forward."""

    @torch.no_grad()
    def prepare(obs_u8: torch.Tensor, act: torch.Tensor):
        hs, cs = [], []
        for i in range(0, obs_u8.shape[0], chunk):
            obs = obs_to_float(obs_u8[i:i + chunk])
            a = act[i:i + chunk]
            *_, (hx, cx) = rew_end_model.predict_rew_end(obs[:, :-1], a[:, :-1], obs[:, 1:])
            hs.append(hx)
            cs.append(cx)
        return torch.cat(hs), torch.cat(cs)

    return prepare


class ImaginationEngine:
    def __init__(self, denoiser: Denoiser, rew_end_model: RewEndModel,
                 actor_critic: ActorCritic, cfg: WorldModelEnvConfig,
                 dp: Optional[DataParallel] = None) -> None:
        self.denoiser = denoiser
        self.rew_end_model = rew_end_model
        self.actor_critic = actor_critic
        self.cfg = cfg
        self.dp = dp if dp is not None else DataParallel()
        self.sampler = DiffusionSampler(denoiser, cfg.diffusion_sampler)

    # -- one world-model transition -------------------------------------------

    @torch.no_grad()
    def _wm_transition(self, st: ImagState, act: torch.Tensor, x_init: torch.Tensor,
                       gumbel_rew: torch.Tensor, gumbel_end: torch.Tensor):
        """Sample the next frame, predict and sample reward/end, roll the buffers.
        Returns (state, next_obs, rew, end, trunc)."""
        act_buffer = st.act_buffer.clone()
        act_buffer[:, -1] = act

        prev_obs = obs_to_float(st.obs_buffer)
        next_obs = self.sampler.sample(prev_obs, act_buffer, x_init=x_init)

        with quant.int8_scope(quant.has_collection(self.rew_end_model.net)):
            logits_rew, logits_end, (re_hx, re_cx) = self.rew_end_model.predict_rew_end(
                prev_obs[:, -1:], act_buffer[:, -1:], next_obs[:, None],
                (st.re_hx, st.re_cx))
        rew = torch.argmax(logits_rew[:, 0] + gumbel_rew, dim=-1).float() - 1.0
        end = torch.argmax(logits_end[:, 0] + gumbel_end, dim=-1).to(torch.int32)

        ep_len = st.ep_len + 1
        trunc = (ep_len >= self.cfg.horizon).to(torch.int32)

        obs_buffer = torch.cat([st.obs_buffer[:, 1:], obs_to_uint8(next_obs)[:, None]], dim=1)
        act_buffer = torch.cat([act_buffer[:, 1:], act_buffer[:, -1:]], dim=1)
        st = replace(st, obs_buffer=obs_buffer, act_buffer=act_buffer, re_hx=re_hx,
                     re_cx=re_cx, ep_len=ep_len)
        return st, next_obs, rew, end, trunc

    @torch.no_grad()
    def _reset_dead(self, st: ImagState, pool: ICPool, dead: torch.Tensor
                    ) -> Tuple[ImagState, ICPool, torch.Tensor]:
        """Masked pool pull for dead envs: the k-th dead env (in global batch order)
        takes entry ptr + k (mod pool size). Also returns the per-env pool indices (0
        where alive)."""
        dead_g = self.dp.assemble(dead.long())
        # exclusive prefix count of deaths over the global batch, this rank's rows
        before = self.dp.take(torch.cumsum(dead_g, 0) - dead_g)
        idx = torch.where(dead, (pool.ptr + before) % pool.size, torch.zeros_like(before))

        m5 = dead[:, None, None, None, None]
        m2 = dead[:, None]
        st = replace(
            st,
            obs_buffer=torch.where(m5, pool.obs[idx], st.obs_buffer),
            act_buffer=torch.where(m2, pool.act[idx], st.act_buffer),
            re_hx=torch.where(m2, pool.hx[idx], st.re_hx),
            re_cx=torch.where(m2, pool.cx[idx], st.re_cx),
            ep_len=torch.where(dead, torch.zeros_like(st.ep_len), st.ep_len),
        )
        return st, replace(pool, ptr=pool.ptr + dead_g.sum()), idx

    # -- rollout ------------------------------------------------------------------

    def rollout(self, st: ImagState, pool: ICPool, num_steps: int,
                draws: Optional[RolloutDraws] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], ImagState, ICPool]:
        """Roll ``num_steps`` of imagination with the policy in the loop; where grad is
        enabled, ``logits_act`` and ``val`` carry the gradient into the actor-critic's
        parameters, and nothing else does (the world model, the bootstrap values and
        the returned state are detached).

        Returns (trajectory dict of (B, T) tensors, new state, new pool). Without
        ``draws`` the random numbers come from ``generator``; under data parallelism
        they are the global batch's, and the rank takes its rows."""
        ac = self.actor_critic
        b, n_cond = st.act_buffer.shape
        if draws is None:
            draws = draw_rollout_noise(num_steps, b * self.dp.world,
                                       tuple(st.obs_buffer.shape[2:]), ac.cfg.num_actions,
                                       generator, st.obs_buffer.device)
        draws = RolloutDraws(*(self.dp.take(x, 1) for x in draws))

        def encode_context(obs_buffer: torch.Tensor) -> torch.Tensor:
            flat = obs_to_float(obs_buffer.reshape((b * n_cond,) + tuple(obs_buffer.shape[2:])))
            return ac.encode(flat).reshape(b, n_cond, -1)

        # the current frame's features are carried from step to step: the next step's
        # main eval input is this step's final obs, or the IC's last frame after a reset
        feat_cur = ac.encode(obs_to_float(st.obs_buffer[:, -1]))
        ys = []
        for t in range(num_steps):
            out = ac.head(feat_cur, (st.ac_hx, st.ac_cx))
            act = torch.argmax(out.logits_act + draws.gumbel_act[t], dim=-1).to(torch.int32)

            st2, next_obs, rew, end, trunc = self._wm_transition(
                st, act, draws.x_init[t], draws.gumbel_rew[t], draws.gumbel_end[t])
            dead = (end + trunc) > 0

            # value of the final obs with the pre-reset policy carry, no grad (its
            # features feed the next step's main eval, with grad)
            feat_next = ac.encode(next_obs)
            with torch.no_grad():
                val_final = ac.head(feat_next, out.carry).val

            st2 = replace(st2, ac_hx=out.carry[0], ac_cx=out.carry[1])
            st2, pool, ic_idx = self._reset_dead(st2, pool, dead)

            # policy-LSTM reset + burn-in over the new context frames from a zero state,
            # computed for all envs and applied to the dead ones
            feats_ic = pool.feats[ic_idx] if pool.feats is not None \
                else encode_context(st2.obs_buffer)
            carry = (torch.zeros_like(st2.ac_hx), torch.zeros_like(st2.ac_cx))
            for k in range(n_cond - 1):
                carry = ac.head(feats_ic[:, k], carry).carry
            m2 = dead[:, None]
            st2 = replace(st2, ac_hx=torch.where(m2, carry[0], st2.ac_hx),
                          ac_cx=torch.where(m2, carry[1], st2.ac_cx))
            feat_cur = torch.where(m2, feats_ic[:, -1], feat_next)

            ys.append(dict(act=act, rew=rew, end=end, trunc=trunc, logits_act=out.logits_act,
                           val=out.val, val_final=val_final, dead=dead))
            st = st2

        traj = {k: torch.stack([y[k] for y in ys], dim=1) for k in ys[0]}
        # bootstrap values, detached: the next step's value, or the final-obs value where
        # the env died
        with torch.no_grad():
            val_extra = ac.head(feat_cur, (st.ac_hx, st.ac_cx)).val
        val_next = torch.cat([traj["val"][:, 1:].detach(), val_extra[:, None]], dim=1)
        traj["val_bootstrap"] = torch.where(traj["dead"], traj["val_final"], val_next)
        # the next rollout starts from this carry without backpropagating into this one
        st = replace(st, ac_hx=st.ac_hx.detach(), ac_cx=st.ac_cx.detach())
        return traj, st, pool

    # -- initial state ------------------------------------------------------------

    def initial_state(self, pool: ICPool, batch_size: int) -> Tuple[ImagState, ICPool]:
        """Fill all envs from the pool with a zero policy LSTM state. ``batch_size`` is
        the global batch's; the state holds this rank's rows of it."""
        d = self.actor_critic.cfg.lstm_dim
        dev = pool.obs.device
        idx = self.dp.take((pool.ptr + torch.arange(batch_size, device=dev)) % pool.size)
        b = idx.shape[0]
        st = ImagState(
            obs_buffer=pool.obs[idx],
            act_buffer=pool.act[idx],
            re_hx=pool.hx[idx],
            re_cx=pool.cx[idx],
            ac_hx=torch.zeros((b, d), device=dev),
            ac_cx=torch.zeros((b, d), device=dev),
            ep_len=torch.zeros((b,), dtype=torch.int32, device=dev),
        )
        return st, replace(pool, ptr=pool.ptr + batch_size)


class PoolManager:
    """Refills the IC pool from the episode dataset. ``sampler``: a BatchSampler with
    ``seq_length`` = the conditioning frames (its batch size is the chunk a build draws
    at once); ``store``: a DeviceEpisodeStore to gather from (else host segments).

    Double-buffered: after handing out a pool it starts building the next one on a
    daemon thread, so a swap only waits where the build has not finished
    (``last_refill_wait_s``). A failed background build is raised by the next
    ``ensure`` or ``wait_pending``, never swallowed. ``last_ids``: the segment ids of
    the last build, chunk by chunk, so that a check can rebuild it (``build_pool(ids)``).
    """

    def __init__(self, engine: ImaginationEngine, dataset, sampler, pool_size: int,
                 chunk: int = 512, background: bool = True, store=None,
                 policy_feats: bool = False) -> None:
        self.engine = engine
        self.dataset = dataset
        self.sampler = sampler
        self.pool_size = pool_size
        self.chunk = chunk
        self.background = background
        self.store = store
        self.policy_feats = policy_feats
        self.last_refill_wait_s = 0.0
        self.builds = self.background_builds = self.swaps = 0
        self.last_ids: List[list] = []
        # the snapshot copies: no quant collection (the burn-in runs unquantized), no grad
        self.rew_end = copy.deepcopy(engine.rew_end_model)
        quant.strip(self.rew_end.net)
        self.rew_end.net.requires_grad_(False)
        self.ac = copy.deepcopy(engine.actor_critic) if policy_feats else None
        if self.ac is not None:
            self.ac.net.requires_grad_(False)
        self._prepare = make_ic_preparer(self.rew_end, chunk)
        self._pending: Optional[threading.Thread] = None
        self._next_pool: Optional[ICPool] = None
        self._pending_error: Optional[BaseException] = None

    @torch.no_grad()
    def snapshot(self) -> None:
        """Copy the live weights into the manager's models (queued on the caller's
        stream, so before any later in-place update of the live ones)."""
        pairs = [(self.rew_end.net, self.engine.rew_end_model.net)]
        if self.ac is not None:
            pairs.append((self.ac.net, self.engine.actor_critic.net))
        for own, live in pairs:
            own_sd = own.state_dict()
            for k, v in live.state_dict().items():
                own_sd[k].copy_(v)

    @torch.no_grad()
    def build_pool(self, ids: Optional[List[list]] = None) -> ICPool:
        """A pool from the snapshot models: ``pool_size`` segments drawn chunk by chunk
        (or the given ``ids``), burned in, with their policy features if asked."""
        obs_l, act_l, hx_l, cx_l, f_l, used = [], [], [], [], [], []
        remaining = self.pool_size
        while remaining > 0:
            n = min(self.chunk, remaining)
            chunk_ids = ids[len(used)] if ids is not None else self.sampler.sample()[:n]
            used.append(chunk_ids)
            if self.store is not None:
                obs, act = self.store.gather_ic(chunk_ids)
            else:
                from ..data.segment import collate_segments_to_batch

                b = collate_segments_to_batch([self.dataset[sid] for sid in chunk_ids])
                dev = next(self.rew_end.net.parameters()).device
                obs = torch.from_numpy(b.obs).to(dev)
                act = torch.from_numpy(b.act.astype(np.int32)).to(dev)
            hx, cx = self._prepare(obs, act)
            obs_l.append(obs)
            act_l.append(act)
            hx_l.append(hx)
            cx_l.append(cx)
            if self.ac is not None:
                f_l.append(encode_pool_feats(self.ac, obs))
            remaining -= n
        self.last_ids = used
        self.builds += 1
        return ICPool(obs=torch.cat(obs_l), act=torch.cat(act_l), hx=torch.cat(hx_l),
                      cx=torch.cat(cx_l),
                      ptr=torch.zeros((), dtype=torch.long, device=obs_l[0].device),
                      feats=torch.cat(f_l) if f_l else None)

    def _kick(self) -> None:
        """Snapshot the live weights now and build the next pool on a thread."""
        if not self.background:
            return
        self.snapshot()

        def work() -> None:
            try:
                with torch.no_grad():  # grad mode is per thread
                    self._next_pool = self.build_pool()
                self.background_builds += 1
            except BaseException as e:  # raised by the next ensure / wait_pending
                self._pending_error = e

        self._pending = threading.Thread(target=work, daemon=True, name="diamond-pool-builder")
        self._pending.start()

    def building(self) -> bool:
        """True while a background build runs."""
        return self._pending is not None and self._pending.is_alive()

    def wait_pending(self) -> None:
        """Block until a background build has finished; call before mutating the
        dataset the sampler reads."""
        if self._pending is not None:
            self._pending.join()
            if self._pending_error is not None:
                e, self._pending_error = self._pending_error, None
                self._pending, self._next_pool = None, None
                raise RuntimeError("background IC-pool build failed") from e

    def ensure(self, pool: Optional[ICPool], max_consumption: int
               ) -> Tuple[ICPool, bool]:
        """(pool, swapped): a pool with at least ``max_consumption`` unconsumed entries."""
        if pool is None:
            self.wait_pending()
            self.snapshot()
            pool = self.build_pool()
            self._kick()
            self.swaps += 1
            return pool, True
        if not self.needs_refill(pool, max_consumption):
            return pool, False
        t0 = time.perf_counter()
        if self._pending is not None:
            self.wait_pending()
            pool = self._next_pool
            self._pending, self._next_pool = None, None
        else:
            self.snapshot()
            pool = self.build_pool()
        self.last_refill_wait_s = time.perf_counter() - t0
        self._kick()
        self.swaps += 1
        return pool, True

    @staticmethod
    def needs_refill(pool: ICPool, max_consumption: int) -> bool:
        """The pool pointer is read back from the card: the one synchronisation an AC
        step makes."""
        return int(pool.ptr) + max_consumption > pool.size
