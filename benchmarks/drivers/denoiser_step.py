"""The denoiser train step (``training.make_denoiser_train_step``) fed by
``StoreBatchIterator`` from a ``DeviceEpisodeStore`` of synthetic episodes, as
static-dataset training feeds it: segments of ``num_steps_conditioning + 1 +
num_autoregressive_steps`` frames drawn uniformly over steps by ``BatchSampler``, the
loss's draws made on the card from the seed and injected. The traffic file gives the
batch, the store's size, the optimizer section and the comparison's limits.

The comparison adds ``batch``: the elements where the program's gathered batch differs
from the segments gathered by the plain code (exact)."""

from __future__ import annotations

import time
from typing import Dict

import torch

from harness.episodes import fill_store, gather, make_episodes
from harness.training import TrainCell
from reference import models as ref


class Cell(TrainCell):
    model = "denoiser"
    sample_weights = None          # static-dataset mode: uniform over steps
    beyond_end = False

    def __init__(self, env) -> None:
        tr = env.traffic
        self.model_cfg = env.config[self.model]
        self.opt_cfg = tr["optimizer"]
        self.sigma_cfg = tr.get("sigma_distribution")
        self.b = int(tr["batch_size"])
        self.shape_step(env)
        super().__init__(env)
        with self.parts("store"):
            self.episodes = make_episodes(int(tr["store_steps"]), self.frame_shape(),
                                          env.config["num_actions"], env.seed, self.dev)
        with self.parts("program"):
            self._build_program(env)

    def frame_shape(self):
        c = self.model_cfg
        return (c["img_size"], c["img_size"], c["inner_model"]["img_channels"])

    def shape_step(self, env) -> None:
        inner = self.model_cfg["inner_model"]
        self.n = inner["num_steps_conditioning"]
        self.t = self.n + 1 + int(env.traffic["num_autoregressive_steps"])
        self.units_per_step = self.b * (self.t - self.n)

    def denoiser_cfg(self, env):
        from diamond_tpu_torch.config import DenoiserConfig, InnerModelConfig

        c = self.model_cfg
        inner = dict(c["inner_model"])
        return DenoiserConfig(inner_model=InnerModelConfig(
            img_channels=inner["img_channels"],
            num_steps_conditioning=inner["num_steps_conditioning"],
            cond_channels=inner["cond_channels"], depths=list(inner["depths"]),
            channels=list(inner["channels"]), attn_depths=list(inner["attn_depths"]),
            num_actions=env.config["num_actions"]),
            sigma_data=c["sigma_data"], sigma_offset_noise=c["sigma_offset_noise"])

    def make_step(self, tx):
        from diamond_tpu_torch.config import SigmaDistributionConfig
        from diamond_tpu_torch.models.denoiser import Denoiser
        from diamond_tpu_torch.training import make_denoiser_train_step

        self.program = Denoiser(self.denoiser_cfg(self.env),
                                getattr(torch, self.env.config["compute_dtype"]))
        return self.program.inner_model, lambda net: make_denoiser_train_step(
            self.program, tx, SigmaDistributionConfig(**self.sigma_cfg))

    def _build_program(self, env) -> None:
        from diamond_tpu_torch import kernels
        from diamond_tpu_torch.data.batch_sampler import BatchSampler
        from diamond_tpu_torch.data.device_store import DeviceEpisodeStore, StoreBatchIterator
        from diamond_tpu_torch.models.agent import configure_opt
        from diamond_tpu_torch.training import TrainState

        if self.dev.type == "cuda":
            with self.parts("kernels_load"):
                kernels.lib()
        o = self.opt_cfg
        tx = configure_opt(o["lr"], o["weight_decay"], o["eps"], o["max_grad_norm"],
                           o["lr_warmup_steps"])
        net, make = self.make_step(tx)
        self.net = net.to(self.dev)
        self.net.load_state_dict(self.W0, strict=True)
        self.state = TrainState.create(self.net, tx)
        self.fn = make(self.net)
        steps = int(self.traffic["store_steps"])
        self.store = DeviceEpisodeStore(steps, self.frame_shape(),
                                        max_episodes=self.episodes.num_episodes + 1,
                                        device=self.dev)
        fill_store(self.store, self.episodes)
        self.sampler = BatchSampler(self.episodes, 0, 1, self.b, self.t, self.sample_weights,
                                    can_sample_beyond_end=self.beyond_end,
                                    seed=self.env.seed % (2 ** 63))
        self.batches = StoreBatchIterator(self.store, self.sampler)

    # -- one step ---------------------------------------------------------------

    def draws(self):
        h, w, c = self.frame_shape()
        s, b, g = self.t - self.n, self.b, self.gen
        return (torch.randn((s, b), generator=g, device=self.dev),
                torch.randn((s, b, 1, 1, c), generator=g, device=self.dev),
                torch.randn((s, b, h, w, c), generator=g, device=self.dev))

    def program_step(self, record: bool, spans: Dict[str, float] = None):
        ids = None
        if record:
            ids = self.sampler.sample
            drawn = []

            def sample():
                out = ids()
                drawn.append(out)
                return out

            self.sampler.sample = sample
        t0 = time.perf_counter()
        batch = next(self.batches)
        if spans is not None:
            spans["batch_wait"] = spans.get("batch_wait", 0.0) + time.perf_counter() - t0
        if self.fault == "half_batch":
            batch.mask_padding[self.b // 2:] = False
        if self.fault == "altered":
            batch.obs[0, -1, 0, 0, 0] ^= 1
        draws, m = self.call(batch)
        loss = m[self.loss_key]
        if not record:
            self.count_nonfinite(loss)
            return None
        self.sampler.sample = ids
        seg = [(s.episode_id, s.start, s.stop) for s in drawn[0]]
        return dict(loss=loss, ids=seg, draws=draws, batch_size=self.b,
                    outputs=self.outputs(batch))

    loss_key = "loss_denoising"

    def call(self, batch):
        """One call of the train step on ``batch``; returns (its draws, its metrics)."""
        from diamond_tpu_torch.models.denoiser import DenoiserDraws

        draws = self.draws()
        self.state, m = self.fn(self.state, batch, draws=DenoiserDraws(*draws))
        return draws, m

    def outputs(self, batch) -> dict:
        return dict(obs=batch.obs, act=batch.act, mask=batch.mask_padding)

    # -- the reference ------------------------------------------------------------

    def reference_loss(self, ctx, W, rec, rows, fault):
        g = self.gathered(rec)
        full = g["mask"]
        if fault == "half_batch":  # the first half's mean
            full = full.clone()
            full[self.b // 2:] = False
        draws = [d[:, rows] for d in rec["draws"]]
        return ref.denoiser_loss(ctx, W, self.model_cfg, self.sigma_cfg,
                                 ref.u8_to_float(g["obs"][rows]), g["act"][rows],
                                 full[rows], draws, full)

    def meta_step(self, ctx) -> None:
        h, w, c = self.frame_shape()
        b, t, s = self.b, self.t, self.t - self.n
        meta = dict(device="meta")
        draws = (torch.empty((s, b), **meta), torch.empty((s, b, 1, 1, c), **meta),
                 torch.empty((s, b, h, w, c), **meta))
        ref.denoiser_loss(ctx, self.meta_weights(), self.model_cfg, self.sigma_cfg,
                          torch.empty((b, t, h, w, c), **meta),
                          torch.empty((b, t), dtype=torch.long, **meta),
                          torch.empty((b, t), dtype=torch.bool, **meta), draws)

    def gathered(self, rec) -> dict:
        return rec.setdefault("gathered", gather(self.episodes, rec["ids"]))

    def extra_checks(self) -> Dict[str, float]:
        bad = 0
        for rec, out in zip(self.recs, self.prog_outputs):
            g = self.gathered(rec)
            bad += sum(int((v != g[k]).sum()) for k, v in out.items() if k in g)
        return {"batch": float(bad)}


def build(env) -> Cell:
    return Cell(env)
