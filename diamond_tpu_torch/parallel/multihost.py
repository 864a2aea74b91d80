"""Process-group set-up and process-local plumbing (diamond_tpu/parallel/multihost.py).

With one process per card, each process already holds its rank's rows of every global
batch and a whole copy of the parameters, so what the JAX package's multi-host layer
assembles into global arrays is here a check and a broadcast:

  (a) ``initialize``: ``torch.distributed.init_process_group`` over
      ``tcp://<coordinator>`` (NCCL; gloo with ``cpu_gloo``, the CPU test fabric);
  (b) ``global_batch_from_local``: the local rows of a batch are the rank's shard; the
      shapes are checked and the global padding mask, which the losses count by, is
      assembled from every rank's rows;
  (c) ``global_replicated_from_full``: rank 0's copy on every rank (a broadcast).

Config surface: ``tpu.distributed.{coordinator, num_processes, process_id, cpu_gloo}``
(configs/trainer.yaml). The training CLI runs one host: it refuses a coordinator and
points here, as the JAX package's does. The dryrun below runs the denoiser step and the
actor-critic step in imagination at any world size; tests/test_torch_multihost.py runs
it at world sizes 2 and 1 and compares. Run a worker by hand (the CPU, gloo):

    python -m diamond_tpu_torch.parallel.multihost <process_id> <num_processes> <port> <outdir>
"""

from __future__ import annotations

import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import DataParallel, replicate


def initialize(coordinator: str, num_processes: int, process_id: int,
               cpu_gloo: bool = False) -> None:
    """Join the process group of ``num_processes`` ranks at ``coordinator`` (host:port)
    as rank ``process_id``: NCCL, or gloo with ``cpu_gloo``. A failure raises; nothing
    falls back to one process."""
    dist.init_process_group("gloo" if cpu_gloo else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def global_batch_from_local(batch, dp: DataParallel):
    """A DeviceBatch of this process's rows -> the same rows as its rank's shard of the
    global batch: every field's leading size checked, the global padding mask
    (``mask_global``) assembled from every rank's rows by one all_reduce."""
    from ..data.segment import DENSE_FIELDS

    b = batch.obs.shape[0]
    for name in DENSE_FIELDS:
        if getattr(batch, name).shape[0] != b:
            raise ValueError(f"global_batch_from_local: {name} has "
                             f"{getattr(batch, name).shape[0]} rows, obs {b}")
    mask = dp.assemble(batch.mask_padding.to(torch.uint8)).bool()
    return replace(batch, mask_global=mask)


def global_replicated_from_full(module: nn.Module, dp: DataParallel) -> nn.Module:
    """Rank 0's parameters and buffers on every rank."""
    return replicate(module, dp)


def _dryrun_worker(process_id: int, num_processes: int, port: int, outdir: str) -> None:
    """One process of the dryrun: a tiny denoiser, two train steps on the global batch
    of 8 (this process's rows), then one actor-critic step in imagination from a whole
    pool of 16; writes the global loss, the gradient norm and the pool pointer."""
    from .. import config as tc
    from ..data.segment import DeviceBatch
    from ..envs.world_model_env import ICPool, ImaginationEngine, make_ic_preparer
    from ..models import ActorCritic, Denoiser, RewEndModel
    from ..models.agent import configure_opt
    from ..models.blocks import init_weights
    from ..training import TrainState, make_ac_train_step, make_denoiser_train_step

    initialize(f"127.0.0.1:{port}", num_processes, process_id, cpu_gloo=True)
    try:
        dp = DataParallel.from_process_group("cpu")
        assert dp.world == num_processes, dp

        den = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(
            img_channels=3, num_steps_conditioning=2, cond_channels=16, depths=[1],
            channels=[8], attn_depths=[0], num_actions=3)))
        init_weights(den.inner_model, torch.Generator().manual_seed(0))
        global_replicated_from_full(den.inner_model, dp)
        tx = configure_opt(1e-4, 1e-4, 1e-8, dp=dp)
        state = TrainState.create(den.inner_model, tx)

        rng = np.random.default_rng(42)  # the global batch (B = 8): this process's rows
        b_global, t = 8, 4
        obs = rng.integers(0, 255, (b_global, t, 8, 8, 3), dtype=np.uint8)
        act = rng.integers(0, 3, (b_global, t)).astype(np.int32)
        rows = dp.rows(b_global)
        per = rows.stop - rows.start
        local = DeviceBatch(
            obs=torch.from_numpy(obs[rows]), act=torch.from_numpy(act[rows]),
            rew=torch.zeros((per, t)), end=torch.zeros((per, t), dtype=torch.int32),
            trunc=torch.zeros((per, t), dtype=torch.int32),
            mask_padding=torch.ones((per, t), dtype=torch.bool),
            final_obs=torch.zeros((per, 8, 8, 3), dtype=torch.uint8),
            has_final_obs=torch.zeros((per,), dtype=torch.bool))
        batch = global_batch_from_local(local, dp)
        step = make_denoiser_train_step(den, tx, tc.SigmaDistributionConfig())
        gen = torch.Generator().manual_seed(7)
        state, metrics = step(state, batch, generator=gen)
        state, metrics = step(state, batch, generator=gen)  # the second moves the weights
        loss = dp.all_reduce_sum(metrics["loss_denoising"].clone())
        out = {"process_id": process_id, "num_processes": num_processes,
               "loss": float(loss), "grad_norm": float(metrics["grad_norm_before_clip"]),
               "step": state.step}

        # the actor-critic step: the pool pointer's global prefix count of deaths
        img, na, d = 8, 3, 16
        rew_end = RewEndModel(tc.RewEndModelConfig(lstm_dim=d, img_size=img, cond_channels=8,
                                                   depths=[1], channels=[8], attn_depths=[0],
                                                   num_actions=na))
        ac = ActorCritic(tc.ActorCriticConfig(lstm_dim=d, img_size=img, channels=[8],
                                              down=[1], num_actions=na))
        for net, seed in ((rew_end.net, 1), (ac.net, 2)):
            init_weights(net, torch.Generator().manual_seed(seed))
            global_replicated_from_full(net, dp)
        prng = np.random.default_rng(7)  # the whole pool on every rank
        pool_obs = torch.from_numpy(prng.integers(0, 255, (16, 2, img, img, 3), dtype=np.uint8))
        pool_act = torch.from_numpy(prng.integers(0, na, (16, 2)).astype(np.int32))
        hx, cx = make_ic_preparer(rew_end)(pool_obs, pool_act)
        pool = ICPool(obs=pool_obs, act=pool_act, hx=hx, cx=cx,
                      ptr=torch.zeros((), dtype=torch.long))
        engine = ImaginationEngine(den, rew_end, ac, tc.WorldModelEnvConfig(
            horizon=4, num_batches_to_preload=1,
            diffusion_sampler=tc.DiffusionSamplerConfig(num_steps_denoising=2)), dp=dp)
        st, pool = engine.initial_state(pool, b_global)
        tx_a = configure_opt(1e-4, 1e-4, 1e-8, dp=dp)
        step_a = make_ac_train_step(engine, ac, tx_a, tc.ActorCriticLossConfig(backup_every=4))
        sa, st, pool, ma = step_a(TrainState.create(ac.net, tx_a), st, pool,
                                  generator=torch.Generator().manual_seed(3))
        out.update({"ac_loss": float(dp.all_reduce_sum(ma["loss_total"].clone())),
                    "ac_grad_norm": float(ma["grad_norm_before_clip"]),
                    "ac_pool_ptr": int(pool.ptr)})
        Path(outdir, f"dryrun_p{process_id}.json").write_text(json.dumps(out))
        print(f"[multihost dryrun] p{process_id}: {out}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _dryrun_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
