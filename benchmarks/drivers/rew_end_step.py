"""The reward/end model's train step (``training.make_rew_end_train_step``) fed by
``StoreBatchIterator`` from the device store, as the trainer feeds it: segments of
``seq_length`` steps that may run past an episode's end (the padding after a death
takes the episode's true final frame in the loss), drawn uniformly over steps. No draws.

The comparison adds ``batch`` (exact): the program's gathered segments, rewards, ends,
masks and final frames against the plain gather."""

from __future__ import annotations

import torch

from drivers.denoiser_step import Cell as StoreCell
from reference import models as ref


class Cell(StoreCell):
    model = "rew_end_model"
    beyond_end = True
    loss_key = "loss_total"

    def frame_shape(self):
        c = self.model_cfg
        return (c["img_size"], c["img_size"], c["img_channels"])

    def shape_step(self, env) -> None:
        self.t = int(env.traffic["seq_length"])
        self.units_per_step = self.b * (self.t - 1)

    def make_step(self, tx):
        from diamond_tpu_torch.config import RewEndModelConfig
        from diamond_tpu_torch.models.rew_end_model import RewEndModel
        from diamond_tpu_torch.training import make_rew_end_train_step

        c = {k: (list(v) if isinstance(v, list) else v) for k, v in self.model_cfg.items()}
        self.program = RewEndModel(RewEndModelConfig(**c),
                                   getattr(torch, self.env.config["compute_dtype"]))
        return self.program.net, lambda net: make_rew_end_train_step(self.program, tx)

    def call(self, batch):
        self.state, m = self.fn(self.state, batch)
        return None, m

    def outputs(self, batch) -> dict:
        return dict(obs=batch.obs, act=batch.act, rew=batch.rew, end=batch.end,
                    mask=batch.mask_padding, final_obs=batch.final_obs,
                    has_final_obs=batch.has_final_obs)

    def reference_loss(self, ctx, W, rec, rows, fault):
        g = self.gathered(rec)
        full = g["mask"]
        if fault == "half_batch":
            full = full.clone()
            full[self.b // 2:] = False
        lr_, le_ = ref.rew_end_loss(ctx, W, self.model_cfg, ref.u8_to_float(g["obs"][rows]),
                                    g["act"][rows], g["rew"][rows], g["end"][rows],
                                    full[rows], ref.u8_to_float(g["final_obs"][rows]),
                                    g["has_final_obs"][rows], full[:, :-1].float().sum())
        return lr_ + le_

    def meta_step(self, ctx) -> None:
        h, w, c = self.frame_shape()
        b, t = self.b, self.t
        meta = dict(device="meta")
        ref.rew_end_loss(ctx, self.meta_weights(), self.model_cfg,
                         torch.empty((b, t, h, w, c), **meta),
                         torch.empty((b, t), dtype=torch.long, **meta),
                         torch.empty((b, t), **meta), torch.empty((b, t), dtype=torch.long, **meta),
                         torch.empty((b, t), dtype=torch.bool, **meta),
                         torch.empty((b, h, w, c), **meta),
                         torch.empty((b,), dtype=torch.bool, **meta))


def build(env) -> Cell:
    return Cell(env)
