"""The actor-critic train step in imagination (``training.make_ac_train_step``) on the
int8-calibrated world model, as ``Trainer`` runs it: ``PoolManager.ensure`` before every
step (its background builds swapped in as the pool runs out), then the step, which rolls
``backup_every`` imagined steps of the whole batch and trains the actor-critic on them.

Set-up makes every model's weights from the seed, a ``DeviceEpisodeStore`` of synthetic
episodes, the initial pool (``num_batches_to_preload`` x B starts, built by the
manager, which then builds the next one in the background; set-up waits for it, so
every window starts from the same state), the initial imagination state, and the int8
calibration on it (``DiffusionSampler.calibrate`` and ``RewEndModel.calibrate`` at the
configuration's sites, as ``Trainer._calibrate_if_stale``). The rollout's draws are made
on the card from the seed and injected. A window at the cell's size ends before the pool
runs out, so it holds no swap and no background build (the trainer makes one a pool,
every few tens of steps): on an H100 a build inside a 30 s window made the rate swing by
7-15 % between runs of one seed, the interpreter shared by two threads.

The comparison follows the program's trajectory step by step: the reference is given
the program's own state before each imagined transition (its frame and action buffers,
its actions, rewards and ends), as it would be given a served model's tokens, and
works out again everything the program derived: the pool's segments and its burned-in
rew/end LSTM state and policy features, the int8 scales, each transition's next frame,
rewards and ends, the policy's actions, logits and values, the loss and the update.
Numbers, besides the train step's ``loss``, ``grad`` and ``change``:
- ``frame``: the worst frame's mean gap in grid levels between the program's next frame
  and the reference's from the same state, action and latent;
- ``rew_end``: the share of the reward and end draws that differ (same Gumbel noise);
- ``actions``: the share of the policy's action draws that differ (same noise);
- ``state``: the elements of the program's buffers, pool pointer draws, episode lengths,
  truncations, pool segments and world-model weights that differ from what the
  transitions, resets and pool build say they must be (exact).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from harness.episodes import fill_store, gather, make_episodes
from harness.training import Result, TrainCell, compare, norms
from reference import models as ref
from reference.optim import AdamW

TINY = torch.finfo(torch.float32).tiny


def gumbel(shape, g, dev) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=dev)
    return -torch.log(-torch.log(u.clamp_min(TINY)))


def u8(x: torch.Tensor) -> torch.Tensor:
    """A frame on the grid as its uint8 codes (round to nearest)."""
    return torch.round((torch.clamp(x, -1.0, 1.0) + 1) / 2 * 255).to(torch.uint8)


class Cell(TrainCell):
    model = "actor_critic"

    def __init__(self, env) -> None:
        cfg, tr = env.config, env.traffic
        self.model_cfg = cfg["actor_critic"]
        self.opt_cfg = tr["optimizer"]
        self.loss_cfg = tr["actor_critic_loss"]
        self.b = int(tr["batch_size"])
        self.t = int(self.loss_cfg["backup_every"])
        self.n = cfg["denoiser"]["inner_model"]["num_steps_conditioning"]
        self.frame = (cfg["img_size"], cfg["img_size"], cfg["denoiser"]["inner_model"]["img_channels"])
        self.units_per_step = self.b * self.t
        self.refill_s = 0.0
        self.swaps = 0
        super().__init__(env)
        with self.parts("weights"):
            self.Wd = ref.make_weights(ref.param_specs("denoiser", cfg["denoiser"]), self.gen,
                                       self.dev)
            self.Wr = ref.make_weights(ref.param_specs("rew_end_model", cfg["rew_end_model"]),
                                       self.gen, self.dev)
        with self.parts("store"):
            self.episodes = make_episodes(int(tr["store_steps"]), self.frame, cfg["num_actions"],
                                          env.seed, self.dev)
        with self.parts("program"):
            self._build_program(env)
        with self.parts("pool"):
            self.pool, _ = self.manager.ensure(None, self.max_consumption)
            self.manager.wait_pending()
        with self.parts("calibration"):
            self._calibrate()

    def _build_program(self, env) -> None:
        from diamond_tpu_torch import kernels
        from diamond_tpu_torch.config import (ActorCriticConfig, ActorCriticLossConfig,
                                              DenoiserConfig, DiffusionSamplerConfig,
                                              InnerModelConfig, RewEndModelConfig,
                                              WorldModelEnvConfig)
        from diamond_tpu_torch.data.batch_sampler import BatchSampler
        from diamond_tpu_torch.data.device_store import DeviceEpisodeStore
        from diamond_tpu_torch.envs.world_model_env import ImaginationEngine, PoolManager
        from diamond_tpu_torch.models.actor_critic import ActorCritic
        from diamond_tpu_torch.models.agent import configure_opt
        from diamond_tpu_torch.models.denoiser import Denoiser
        from diamond_tpu_torch.models.rew_end_model import RewEndModel
        from diamond_tpu_torch.training import TrainState, make_ac_train_step

        if self.dev.type == "cuda":
            with self.parts("kernels_load"):
                kernels.lib()
        cfg, tr = env.config, env.traffic
        dtype = getattr(torch, cfg["compute_dtype"])
        d, im = cfg["denoiser"], dict(cfg["denoiser"]["inner_model"])
        den = Denoiser(DenoiserConfig(
            inner_model=InnerModelConfig(**{k: (list(v) if isinstance(v, list) else v)
                                            for k, v in im.items()}),
            sigma_data=d["sigma_data"], sigma_offset_noise=d["sigma_offset_noise"]), dtype)
        lists = lambda c: {k: (list(v) if isinstance(v, list) else v)  # noqa: E731
                           for k, v in c.items()}
        rew_end = RewEndModel(RewEndModelConfig(**lists(cfg["rew_end_model"])), dtype)
        ac = ActorCritic(ActorCriticConfig(**lists(self.model_cfg)), dtype)
        for net, W in ((den.inner_model, self.Wd), (rew_end.net, self.Wr), (ac.net, self.W0)):
            net.to(self.dev)
            net.load_state_dict(W, strict=True)
        wm = cfg["world_model_env"]
        self.sampler_cfg = dict(wm["diffusion_sampler"])
        wm_cfg = WorldModelEnvConfig(horizon=wm["horizon"],
                                     num_batches_to_preload=wm["num_batches_to_preload"],
                                     diffusion_sampler=DiffusionSamplerConfig(**self.sampler_cfg))
        self.engine = ImaginationEngine(den, rew_end, ac, wm_cfg)
        self.store = DeviceEpisodeStore(self.episodes.num_steps, self.frame,
                                        max_episodes=self.episodes.num_episodes + 1,
                                        device=self.dev)
        fill_store(self.store, self.episodes)
        chunk = int(tr["pool_chunk"])
        seg_sampler = BatchSampler(self.episodes, 0, 1, chunk, self.n, tr["sample_weights"],
                                   seed=env.seed % (2 ** 63))
        self.pool_size = wm["num_batches_to_preload"] * self.b
        self.manager = PoolManager(self.engine, self.episodes, seg_sampler, self.pool_size,
                                   chunk=chunk, store=self.store, policy_feats=True)
        self.builds: List[tuple] = []
        orig = self.manager.build_pool

        def build_pool(ids=None):  # the segment ids of each build, for the reference
            pool = orig(ids)
            self.builds.append((pool, [list(c) for c in self.manager.last_ids]))
            return pool

        self.manager.build_pool = build_pool
        self.max_consumption = self.t * self.b + self.b
        o = self.opt_cfg
        tx = configure_opt(o["lr"], o["weight_decay"], o["eps"], o["max_grad_norm"],
                           o["lr_warmup_steps"])
        self.net = ac.net
        self.state = TrainState.create(ac.net, tx)
        self.fn = make_ac_train_step(self.engine, ac, tx, ActorCriticLossConfig(**self.loss_cfg))
        self.sites = cfg["int8_sites"]

    def _calibrate(self) -> None:
        from diamond_tpu_torch.data.episode import obs_to_float

        eng = self.engine
        self.st, self.pool = eng.initial_state(self.pool, self.b)
        obs_f = obs_to_float(self.st.obs_buffer)
        self.x_cal = torch.randn((self.b,) + self.frame, generator=self.gen, device=self.dev)
        eng.sampler.calibrate(obs_f, self.st.act_buffer, self.sites, x_init=self.x_cal)
        eng.rew_end_model.calibrate(obs_f[:, -2:-1], self.st.act_buffer[:, -2:-1],
                                    obs_f[:, -1:], self.sites)
        self.wm_before = [{k: v.detach().clone() for k, v in net.state_dict().items()}
                          for net in (eng.denoiser.inner_model, eng.rew_end_model.net)]

    # -- one step ---------------------------------------------------------------

    def draws(self):
        from diamond_tpu_torch.envs.world_model_env import RolloutDraws

        t, b, g, dev = self.t, self.b, self.gen, self.dev
        a = self.cfg["num_actions"]
        return RolloutDraws(torch.randn((t, b) + self.frame, generator=g, device=dev),
                            gumbel((t, b, a), g, dev), gumbel((t, b, 3), g, dev),
                            gumbel((t, b, 2), g, dev))

    def program_step(self, record: bool, spans: Dict[str, float] = None):
        self.pool, swapped = self.manager.ensure(self.pool, self.max_consumption)
        if swapped:
            self.refill_s += self.manager.last_refill_wait_s
            self.swaps += 1
        draws = self.draws()
        if not record:
            self.state, self.st, self.pool, m = self.fn(self.state, self.st, self.pool,
                                                        draws=draws)
            self.count_nonfinite(m["loss_total"])
            return None
        eng = self.engine
        rec = dict(draws=draws, trans=[], batch_size=self.b, pool=self.pool, st_in=self.st)
        orig = (eng._wm_transition, eng._reset_dead, eng.rollout)

        def wm(st, act, x_init, gr, ge):
            out = orig[0](st, act, x_init, gr, ge)
            rec["trans"].append(dict(obs_buffer=st.obs_buffer, act_buffer=st.act_buffer,
                                     ep_len=st.ep_len, act=act, next_obs=out[1], rew=out[2],
                                     end=out[3], trunc=out[4]))
            return out

        def reset(st, pool, dead):
            out = orig[1](st, pool, dead)
            rec["trans"][-1].update(dead=dead, idx=out[2], ptr=pool.ptr)
            return out

        def rollout(st, pool, n, draws=None, generator=None):
            traj, st2, pool2 = orig[2](st, pool, n, draws=draws, generator=generator)
            rec["traj"] = {k: v.detach() for k, v in traj.items()}
            return traj, st2, pool2

        eng._wm_transition, eng._reset_dead, eng.rollout = wm, reset, rollout
        try:
            self.state, self.st, self.pool, m = self.fn(self.state, self.st, self.pool,
                                                        draws=draws)
        finally:
            del eng._wm_transition, eng._reset_dead, eng.rollout
        rec["loss"] = m["loss_total"]
        rec["st_out"] = self.st
        return rec

    def plant(self, fault: str) -> None:
        super().plant(fault)
        if fault == "altered":  # every sampled frame's first row, mirrored on the grid
            sampler = self.engine.sampler
            orig_sample = sampler.sample

            def sample(*a, **k):
                x = orig_sample(*a, **k).clone()
                x[0] = -x[0]
                return x

            sampler.sample = sample
        if fault == "half_batch":  # the loss's mean over the first half of the rows
            ac = self.engine.actor_critic
            orig = ac.loss_from_rollout

            def half(act, rew, end, trunc, logits, val, vb, cfg, count=None):
                h = act.shape[0] // 2
                return orig(act[:h], rew[:h], end[:h], trunc[:h], logits[:h], val[:h],
                            vb[:h], cfg, None)

            ac.loss_from_rollout = half

    def counters(self) -> Dict[str, float]:
        """The pool's swaps in the window and their waits; the pointer at its end."""
        return {"pool_refill_s": self.refill_s, "pool_swaps": float(self.swaps),
                "pool_ptr": float(self.pool.ptr), "pool_size": float(self.pool_size)}

    def warm_up(self) -> None:
        """The check steps; then the pool they drew from (its segments and the ids the
        manager gathered them by) is kept for the reference, and builds go unrecorded."""
        super().warm_up()
        used = {rec["pool"].obs.data_ptr() for rec in self.recs}
        if len(used) != 1:
            raise RuntimeError("the check steps drew from more than one pool")
        self.check_pool = next((p.obs, p.act, ids) for p, ids in self.builds
                               if p.obs.data_ptr() in used)
        for rec in self.recs:
            del rec["pool"]
        del self.manager.build_pool
        self.builds = []
        self.refill_s, self.swaps = 0.0, 0  # the window's own

    def release(self) -> None:
        """Join the pool builder; keep the pool the check steps drew from (its segments
        and the ids they were gathered by) and drop the rest of the program."""
        self.manager.wait_pending()
        eng = self.engine
        self.wm_after = [{k: v.detach().clone() for k, v in net.state_dict().items()}
                         for net in (eng.denoiser.inner_model, eng.rew_end_model.net)]
        super().release()
        for name in ("engine", "manager", "store", "st", "pool", "builds"):
            if hasattr(self, name):
                delattr(self, name)

    # -- the reference ------------------------------------------------------------

    def _prepare(self):
        """The reference's own pool (segments gathered from the episodes by the build's
        ids), its burn-in and policy features at the entries the check steps use, and
        its int8 scales from the same calibration inputs."""
        if getattr(self, "_prep", None) is not None:
            return self._prep
        cfg = self.cfg
        p_obs, p_act, ids = self.check_pool
        flat = [(s.episode_id, s.start, s.stop) for c in ids for s in c]
        g = gather(self.episodes, flat)
        pool = dict(obs=g["obs"], act=g["act"], size=len(flat))
        bad = int(torch.count_nonzero(p_act != g["act"]))
        for i in range(0, len(flat), 4096):
            bad += int(torch.count_nonzero(p_obs[i:i + 4096] != g["obs"][i:i + 4096]))
        used = set(range(self.b))
        for rec in self.recs:
            for tr in rec["trans"]:
                used.update(tr["idx"][tr["dead"]].tolist())
        used = torch.tensor(sorted(used), device=self.dev)
        hx = torch.zeros((pool["size"], cfg["rew_end_model"]["lstm_dim"]), device=self.dev)
        cx = torch.zeros_like(hx)
        feats = None
        f32 = ref.Ctx()
        blk = int(self.traffic.get("ref_rows", self.b))
        with torch.no_grad(), self.exact():
            for i in range(0, len(used), blk):
                u = used[i:i + blk]
                o = ref.u8_to_float(pool["obs"][u])
                z = torch.zeros((len(u), hx.shape[1]), device=self.dev)
                _, _, (h, c) = ref.rew_end(f32, self.Wr, cfg["rew_end_model"], o[:, :-1],
                                           pool["act"][u][:, :-1], o[:, 1:], (z, z))
                hx[u], cx[u] = h, c
                f = ref.ac_encode(f32, self.W0, self.model_cfg,
                                  o.reshape((-1,) + self.frame)).reshape(len(u), self.n, -1)
                if feats is None:
                    feats = torch.zeros((pool["size"],) + f.shape[1:], device=self.dev)
                feats[u] = f
            # the calibration: the sites' input ranges over the same pass, max-merged
            rec_d, rec_r = {}, {}
            obs0 = ref.u8_to_float(pool["obs"][:self.b])
            act0 = pool["act"][:self.b]
            for i in range(0, self.b, blk):
                r = slice(i, min(self.b, i + blk))
                ref.sample_frame(ref.Ctx(record=rec_d), self.Wd, cfg["denoiser"],
                                 self.sampler_cfg, obs0[r], act0[r], self.x_cal[r])
                z = torch.zeros((r.stop - r.start, hx.shape[1]), device=self.dev)
                ref.rew_end(ref.Ctx(record=rec_r), self.Wr, cfg["rew_end_model"],
                            obs0[r, -2:-1], act0[r, -2:-1], obs0[r, -1:], (z, z))
        pool.update(hx=hx, cx=cx, feats=feats)
        self._prep = dict(pool=pool, pool_bad=bad, quant_d=rec_d, quant_r=rec_r)
        return self._prep

    def _wm_pass(self, precisions) -> Dict[str, Dict[str, float]]:
        """The world model's transitions from the program's states, at the sampled rows:
        for each (name, int_max) the worst frame's mean gap to the program's next frame
        and the share of differing reward/end draws; with two, also the second against
        the first."""
        prep = self._prep
        cfg = self.cfg
        blk = int(self.traffic.get("ref_rows", self.b))
        sample = self.check_sample()
        stats = {name: dict(frame=0.0, rew_end=0) for name, _ in precisions}
        if len(precisions) == 2:
            stats["vs_ref"] = dict(frame=0.0, rew_end=0)
        total = 0
        with torch.no_grad(), self.exact():
            for rec in self.recs:
                d = rec["draws"]
                for t, tr in enumerate(rec["trans"]):
                    for i in range(0, len(sample), blk):
                        r = sample[i:i + blk]
                        prev = ref.u8_to_float(tr["obs_buffer"][r])
                        acts = tr["act_buffer"][r].clone()
                        acts[:, -1] = tr["act"][r]
                        outs = []
                        for name, qmax in precisions:
                            ctx_d = ref.Ctx(quant=prep["quant_d"], int_max=qmax,
                                            precision="f32" if qmax == 127 else "fp8")
                            ctx_r = ctx_d.with_(quant=prep["quant_r"])
                            nxt = ref.sample_frame(ctx_d, self.Wd, cfg["denoiser"],
                                                   self.sampler_cfg, prev, acts,
                                                   d.x_init[t, r])
                            carry = (rec["re_carry"][t][0][r], rec["re_carry"][t][1][r])
                            lr_, le_, _ = ref.rew_end(ctx_r, self.Wr, cfg["rew_end_model"],
                                                      prev[:, -1:], acts[:, -1:],
                                                      tr["next_obs"][r, None], carry)
                            rew = torch.argmax(lr_[:, 0] + d.gumbel_rew[t, r], -1).float() - 1
                            end = torch.argmax(le_[:, 0] + d.gumbel_end[t, r], -1)
                            gap = (nxt - tr["next_obs"][r]).abs().mean(dim=(1, 2, 3)) * 127.5
                            s = stats[name]
                            s["frame"] = max(s["frame"], float(gap.max()))
                            s["rew_end"] += int(((rew != tr["rew"][r]) | (end != tr["end"][r]))
                                                .sum())
                            outs.append((nxt, rew, end))
                        if len(outs) == 2:
                            (a, ra, ea), (c, rc, ec) = outs
                            s = stats["vs_ref"]
                            s["frame"] = max(s["frame"], float(((c - a).abs().mean(
                                dim=(1, 2, 3)) * 127.5).max()))
                            s["rew_end"] += int(((ra != rc) | (ea != ec)).sum())
                    total += len(sample)
        for s in stats.values():
            s["rew_end"] = s["rew_end"] / total
        return stats

    def check_sample(self) -> torch.Tensor:
        """The rows whose transitions the reference recomputes (``check_rows`` of them,
        drawn from the seed; every row where the traffic gives none)."""
        n = int(self.traffic.get("check_rows", self.b))
        g = torch.Generator().manual_seed(self.env.seed % (2 ** 63))
        return torch.randperm(self.b, generator=g)[:n].sort().values.to(self.dev)

    def _state_check(self) -> int:
        """Exact: each transition's input state follows from the previous transition,
        its reset and the pool; the steps chain; the world model is unchanged."""
        prep = self._prep
        pool = prep["pool"]
        bad = prep["pool_bad"]
        ptr = self.b
        prev = None
        h = self.cfg["world_model_env"]["horizon"]
        for rec in self.recs:
            st_in = rec["st_in"]
            if prev is None:
                bad += int((st_in.obs_buffer != pool["obs"][:self.b]).sum()
                           + (st_in.act_buffer != pool["act"][:self.b]).sum())
            for t, tr in enumerate(rec["trans"]):
                if prev is not None:
                    exp_obs, exp_act, exp_len = prev
                    bad += int((tr["obs_buffer"] != exp_obs).sum()
                               + (tr["act_buffer"] != exp_act).sum()
                               + (tr["ep_len"] != exp_len).sum())
                dead = (tr["end"] + tr["trunc"]) > 0
                ep_len = tr["ep_len"] + 1
                bad += int((tr["trunc"] != (ep_len >= h).to(tr["trunc"].dtype)).sum())
                before = torch.cumsum(dead.long(), 0) - dead.long()
                idx = torch.where(dead, (ptr + before) % pool["size"], torch.zeros_like(before))
                bad += int((tr["idx"] != idx).sum()) + int(int(tr["ptr"]) != ptr)
                obs = torch.cat([tr["obs_buffer"][:, 1:], u8(tr["next_obs"])[:, None]], dim=1)
                acts = tr["act_buffer"].clone()
                acts[:, -1] = tr["act"]
                acts = torch.cat([acts[:, 1:], acts[:, -1:]], dim=1)
                m = dead[:, None]
                obs = torch.where(m[..., None, None, None], pool["obs"][idx], obs)
                acts = torch.where(m, pool["act"][idx], acts)
                prev = (obs, acts, torch.where(dead, torch.zeros_like(ep_len), ep_len))
                ptr += int(dead.sum())
            st_out = rec["st_out"]
            bad += int((st_out.obs_buffer != prev[0]).sum() + (st_out.act_buffer != prev[1]).sum())
        for before, after in zip(self.wm_before, self.wm_after):
            bad += sum(int((before[k] != after[k]).sum()) for k in before)
        return bad

    def _ac_pass(self, precision: str = "f32", fault: Optional[str] = None):
        """The actor-critic's steps along the program's trajectory: its own carries,
        logits, values, loss and update. Returns (Result, action draws (steps, B, T))."""
        prep = self._prep
        pool = prep["pool"]
        lcfg = self.loss_cfg
        o = self.opt_cfg
        opt = AdamW(o["lr"], o["weight_decay"], o["eps"], o["max_grad_norm"],
                    o["lr_warmup_steps"])
        W = dict(self.W0)
        ctx = ref.Ctx(precision=precision)
        blk = int(self.traffic.get("ref_rows", self.b))
        d_lstm = self.model_cfg["lstm_dim"]
        carries = {}
        losses, g1, acts_all = [], None, []
        count = self.b * self.t if fault != "half_batch" else (self.b // 2) * self.t
        with self.exact():
            for k, rec in enumerate(self.recs):
                params = {n: W[n].detach().clone().requires_grad_(True) for n in self.trained}
                Wg = {**W, **params}
                total = 0.0
                acts_k = torch.zeros((self.b, self.t), dtype=torch.long, device=self.dev)
                for i in range(0, self.b, blk):
                    r = slice(i, min(self.b, i + blk))
                    if fault == "half_batch" and r.start >= self.b // 2:
                        continue
                    rows = torch.arange(r.start, r.stop, device=self.dev)
                    if fault == "half_batch":
                        rows = rows[rows < self.b // 2]
                    loss, carry, acts = self._ac_rollout(ctx, Wg, rec, rows, carries.get(i),
                                                         pool, d_lstm, count)
                    carries[i] = carry
                    acts_k[rows] = acts
                    loss.backward()
                    total += float(loss.detach())
                grads = opt.clip({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                  for n, p in params.items()})
                if g1 is None:
                    g1 = grads
                W = {**W, **{n: v.detach() for n, v in opt.step(
                    {n: W[n] for n in self.trained}, grads).items()}}
                losses.append(total)
                acts_all.append(acts_k)
        res = Result(losses, norms(g1), norms({n: W[n] - self.W0[n] for n in self.trained}))
        return res, torch.stack(acts_all)

    def _ac_rollout(self, ctx, W, rec, rows, carry, pool, d_lstm, count):
        """One recorded step's imagined steps for ``rows``, teacher-forced by the
        program's transitions; returns (the rows' share of the loss, the final carry,
        the action draws)."""
        cfg, lcfg = self.model_cfg, self.loss_cfg
        d = rec["draws"]
        trs = rec["trans"]
        n = len(rows)
        if carry is None:
            z = torch.zeros((n, d_lstm), device=self.dev)
            carry = (z, z)
        obs_last = ref.u8_to_float(rec["st_in"].obs_buffer[rows, -1])
        feat = ref.ac_encode(ctx, W, cfg, obs_last)
        logits_l, val_l, vfin_l, acts = [], [], [], []
        for t, tr in enumerate(trs):
            logits, val, carry = ref.ac_head(ctx, W, feat, carry)
            acts.append(torch.argmax(logits.detach() + d.gumbel_act[t, rows], -1))
            nxt = tr["next_obs"][rows]
            feat_next = ref.ac_encode(ctx, W, cfg, nxt)
            with torch.no_grad():
                vfin_l.append(ref.ac_head(ctx, W, feat_next, carry)[1])
            dead = tr["dead"][rows]
            idx = tr["idx"][rows]
            fic = pool["feats"][idx]
            c2 = (torch.zeros_like(carry[0]), torch.zeros_like(carry[1]))
            for j in range(self.n - 1):
                c2 = ref.ac_head(ctx, W, fic[:, j], c2)[2]
            m = dead[:, None]
            carry = (torch.where(m, c2[0], carry[0]), torch.where(m, c2[1], carry[1]))
            feat = torch.where(m, fic[:, -1], feat_next)
            logits_l.append(logits)
            val_l.append(val)
        with torch.no_grad():
            v_extra = ref.ac_head(ctx, W, feat, carry)[1]
        traj = rec["traj"]
        logits = torch.stack(logits_l, 1)
        val = torch.stack(val_l, 1)
        dead = traj["dead"][rows]
        v_next = torch.cat([val[:, 1:].detach(), v_extra[:, None]], 1)
        vb = torch.where(dead, torch.stack(vfin_l, 1), v_next)
        loss, _ = ref.ac_loss(logits, val, traj["act"][rows], traj["rew"][rows],
                              traj["end"][rows].float(), traj["trunc"][rows].float(), vb, lcfg)
        share = n * self.t / count
        return loss * share, (carry[0].detach(), carry[1].detach()), torch.stack(acts, 1)

    def _re_carries(self) -> None:
        """The reward/end LSTM state before each transition, as the reference carries it
        from its own burned-in pool state through the program's transitions."""
        prep = self._prep
        pool = prep["pool"]
        cfg = self.cfg
        blk = int(self.traffic.get("ref_rows", self.b))
        carry = (pool["hx"][:self.b].clone(), pool["cx"][:self.b].clone())
        ctx = ref.Ctx(quant=prep["quant_r"])
        with torch.no_grad(), self.exact():
            for rec in self.recs:
                rec["re_carry"] = []
                for tr in rec["trans"]:
                    rec["re_carry"].append(carry)
                    prev = ref.u8_to_float(tr["obs_buffer"][:, -1:])
                    acts = tr["act"][:, None]
                    h_new, c_new = torch.empty_like(carry[0]), torch.empty_like(carry[1])
                    for i in range(0, self.b, blk):
                        r = slice(i, min(self.b, i + blk))
                        _, _, (h, c) = ref.rew_end(ctx, self.Wr, cfg["rew_end_model"], prev[r],
                                                   acts[r], tr["next_obs"][r, None],
                                                   (carry[0][r], carry[1][r]))
                        h_new[r], c_new[r] = h, c
                    m = tr["dead"][:, None]
                    carry = (torch.where(m, pool["hx"][tr["idx"]], h_new),
                             torch.where(m, pool["cx"][tr["idx"]], c_new))

    def check(self):
        got = self.program_readings()
        lim = self.traffic["limits"]
        return [(k, float(got[k]), float(lim[k])) for k in lim]

    def program_readings(self) -> Dict[str, float]:
        self._prepare()
        self._re_carries()
        res, acts = self._ac_pass()
        prog_acts = torch.stack([rec["traj"]["act"].long() for rec in self.recs])
        self.leaves = {}
        out = compare(self.prog, res, self.leaves)
        out["actions"] = float((acts != prog_acts).float().mean())
        out.update(self._wm_pass([("ref", 127)])["ref"])
        out["state"] = float(self._state_check())
        return out

    def readings(self) -> Dict[str, Dict[str, float]]:
        self._prepare()
        self._re_carries()
        res, acts = self._ac_pass()
        prog_acts = torch.stack([rec["traj"]["act"].long() for rec in self.recs])
        wm = self._wm_pass([("ref", 127), ("control", 7)])
        self.leaves = {}
        prog = compare(self.prog, res, self.leaves)
        prog.update(actions=float((acts != prog_acts).float().mean()), **wm["ref"],
                    state=float(self._state_check()))
        c_res, c_acts = self._ac_pass("fp8")
        control = compare(c_res, res)
        control.update(actions=float((c_acts != acts).float().mean()), **wm["vs_ref"])
        out = {"program": prog, "control": control}
        for fault in self.traffic.get("reference_faults", []):
            out[fault] = compare(self._ac_pass(fault=fault)[0], res)
        out["unchanged"] = compare(Result(self.prog.losses, self.prog.grad,
                                          {k: 0.0 for k in res.change}), res)
        return out

    # -- the step's work, counted from the shapes --------------------------------

    def meta_step(self, ctx) -> None:
        cfg = self.cfg
        b, h, w, c = self.b, *self.frame
        meta = dict(device="meta")
        Wd = {k: torch.empty(s[0], **meta)
              for k, s in ref.param_specs("denoiser", cfg["denoiser"]).items()}
        Wr = {k: torch.empty(s[0], **meta)
              for k, s in ref.param_specs("rew_end_model", cfg["rew_end_model"]).items()}
        Wa = self.meta_weights()
        wm_ctx = ref.Ctx(quant=ref.AllSites(), ops=ctx.ops, trained=False,
                         kinds=[s for s in self.sites.split(",")])
        d = cfg["rew_end_model"]["lstm_dim"]
        z = torch.empty((b, d), **meta)
        feat = ref.ac_encode(ctx, Wa, self.model_cfg, torch.empty((b, h, w, c), **meta))
        carry = (z, z)
        for _ in range(self.t):
            _, _, carry = ref.ac_head(ctx, Wa, feat, carry)
            with torch.no_grad():
                prev = torch.empty((b, self.n, h, w, c), **meta)
                acts = torch.empty((b, self.n), dtype=torch.long, **meta)
                nxt = ref.sample_frame(wm_ctx, Wd, cfg["denoiser"], self.sampler_cfg, prev,
                                       acts, torch.empty((b, h, w, c), **meta))
                ref.rew_end(wm_ctx, Wr, cfg["rew_end_model"], prev[:, -1:], acts[:, -1:],
                            nxt[:, None], (z, z))
            feat = ref.ac_encode(ctx, Wa, self.model_cfg, torch.empty((b, h, w, c), **meta))
            with torch.no_grad():
                ref.ac_head(ctx, Wa, feat, carry)
            fic = torch.empty((b, self.n, feat.shape[1]), **meta)
            c2 = (z, z)
            for j in range(self.n - 1):
                c2 = ref.ac_head(ctx, Wa, fic[:, j], c2)[2]
        with torch.no_grad():
            ref.ac_head(ctx, Wa, feat, carry)


def build(env) -> Cell:
    return Cell(env)
