"""The data-parallel train steps of diamond_tpu_torch at tests/test_parallel.py's sizes
(B = 8, 16x16 frames, 4 conditioning frames, 3 actions, widths [8, 8]), run on the CPU in
float32 as one rank of a gloo process group, or in one process without a group (world
size 1). Each case builds its models from the JAX package's variables (numpy, handed
over in the inputs file), takes its rank's rows of the global batch and draws, makes two
steps and returns what tests/test_torch_parallel.py compares: the global losses (each
rank's share summed over the ranks), the gradient norms, the gradients of the first
update, the parameters, and for the actor-critic the pool pointer, the imagination
buffers and the deaths of each rank.

A rank, by hand (the inputs file written by the test):

    python tests/torch_dp_worker.py <rank> <world> <port> <workdir>

This module imports no jax.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from diamond_tpu_torch import config as tc
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.device_store import DeviceEpisodeStore
from diamond_tpu_torch.data.segment import DeviceBatch, SegmentId
from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine, RolloutDraws,
                                                    make_ic_preparer)
from diamond_tpu_torch.interop.jax_vars import load_variables
from diamond_tpu_torch.models import ActorCritic, Denoiser, DenoiserDraws, RewEndModel
from diamond_tpu_torch.models.agent import configure_opt
from diamond_tpu_torch.parallel import DataParallel, replicate_pool, shard_device_batch
from diamond_tpu_torch.training import (TrainState, make_ac_train_step,
                                        make_denoiser_train_step,
                                        make_model_free_ac_train_step, make_rew_end_train_step)

IMG, C, NC, NA, D = 16, 3, 4, 3, 32
B = 8
INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
             channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
REW = dict(lstm_dim=D, img_channels=C, img_size=IMG, cond_channels=8, depths=[1, 1],
           channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
AC = dict(lstm_dim=D, img_channels=C, img_size=IMG, channels=[8, 8], down=[1, 1],
          num_actions=NA)
SIGMA = tc.SigmaDistributionConfig(-0.4, 1.2, 2e-3, 20.0)
AC_LOSS = tc.ActorCriticLossConfig(backup_every=4, gamma=0.985, lambda_=0.95,
                                   weight_value_loss=1.0, weight_entropy_loss=0.001)
WM = tc.WorldModelEnvConfig(horizon=4, num_batches_to_preload=1,
                            diffusion_sampler=tc.DiffusionSamplerConfig(num_steps_denoising=2))
# tests/test_parallel.py's optimizers: (lr, weight_decay, eps, max_grad_norm, warmup)
OPT = {"denoiser": (1e-3, 1e-2, 1e-8, 1.0, 0), "rew_end": (1e-3, 1e-2, 1e-8, 100.0, 0),
       "ac": (1e-3, 0.0, 1e-8, 100.0, 0), "model_free": (1e-3, 0.0, 1e-8, 0.5, 0)}


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def params(net) -> dict:
    return {n: p.detach().numpy().copy() for n, p in net.named_parameters()}


def first_update_grads(net, state: TrainState) -> dict:
    """Filled at the first update with the gradients the optimizer steps on (summed
    over the ranks and clipped), by the parameters' names."""
    grads: dict = {}
    names = {p: n for n, p in net.named_parameters()}

    def hook(opt, args, kwargs):
        if not grads:
            grads.update({names[p]: p.grad.detach().numpy().copy()
                          for g in opt.param_groups for p in g["params"]})

    state.opt_state.register_step_pre_hook(hook)
    return grads


def global_metric(dp: DataParallel, x: torch.Tensor) -> float:
    """A step metric summed over the ranks (each holds its share of the global mean)."""
    return float(dp.all_reduce_sum(x.detach().clone()))


def denoiser_batch(inp) -> DeviceBatch:
    b, t_total = inp["act"].shape
    return DeviceBatch(obs=t(inp["obs"]), act=t(inp["act"]), rew=torch.zeros((b, t_total)),
                       end=torch.zeros((b, t_total), dtype=torch.int32),
                       trunc=torch.zeros((b, t_total), dtype=torch.int32),
                       mask_padding=t(inp["mask"]),
                       final_obs=torch.zeros((b, IMG, IMG, C), dtype=torch.uint8),
                       has_final_obs=torch.zeros((b,), dtype=torch.bool))


def run_denoiser(inp, dp: DataParallel, k: int = 1) -> dict:
    """The denoiser step (``k`` micro-steps an update) on the rank's rows of one global
    batch whose padding differs between the halves, one set of global draws a step."""
    den = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**INNER)))
    load_variables(den.inner_model, inp["vars"])
    tx = configure_opt(*OPT["denoiser"], grad_acc_steps=k, dp=dp)
    state = TrainState.create(den.inner_model, tx)
    grads = first_update_grads(den.inner_model, state)
    step = make_denoiser_train_step(den, tx, SIGMA)
    batch = shard_device_batch(denoiser_batch(inp), dp)
    losses, norms = [], []
    for draws in inp["draws"]:
        state, m = step(state, batch, draws=DenoiserDraws(*(t(x) for x in draws)))
        losses.append(global_metric(dp, m["loss_denoising"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return dict(losses=losses, norms=norms, params=params(den.inner_model), grads=grads,
                step=state.step)


def run_rew_end(inp, dp: DataParallel) -> dict:
    """The rew/end step on batches the device store assembles from a dataset every rank
    mirrors whole: the rank's rows, the global mask beside them."""
    model = RewEndModel(tc.RewEndModelConfig(**REW))
    load_variables(model.net, inp["vars"])
    ds = Dataset(Path(inp["dataset"]), "ds", cache_in_ram=True, save_on_disk=False)
    ds.load_from_default_path()
    store = DeviceEpisodeStore(64, (IMG, IMG, C), device="cpu")
    store.sync(ds)
    batch = store.make_batch([SegmentId(*i) for i in inp["ids"]], dp=dp)
    tx = configure_opt(*OPT["rew_end"], dp=dp)
    state = TrainState.create(model.net, tx)
    grads = first_update_grads(model.net, state)
    step = make_rew_end_train_step(model, tx)
    losses, norms = [], []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(global_metric(dp, m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return dict(losses=losses, norms=norms, params=params(model.net), grads=grads,
                mask_rows=batch.mask_padding.numpy(), obs_rows=batch.obs.numpy())


def run_ac(inp, dp: DataParallel) -> dict:
    """The actor-critic step in imagination, two steps from the same pool: the rank's
    env rows, the whole pool, the global draws of each step."""
    ac_vars, d_vars, r_vars = inp["vars"]
    den = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**INNER)))
    rew_end = RewEndModel(tc.RewEndModelConfig(**REW))
    ac = ActorCritic(tc.ActorCriticConfig(**AC))
    for net, v in ((den.inner_model, d_vars), (rew_end.net, r_vars), (ac.net, ac_vars)):
        load_variables(net, v)
    engine = ImaginationEngine(den, rew_end, ac, WM, dp=dp)
    obs, act = t(inp["pool_obs"]), t(inp["pool_act"])
    hx, cx = make_ic_preparer(rew_end)(obs, act)
    pool = replicate_pool(ICPool(obs=obs, act=act, hx=hx, cx=cx,
                                 ptr=torch.zeros((), dtype=torch.long)), dp)
    st, pool = engine.initial_state(pool, B)
    tx = configure_opt(*OPT["ac"], dp=dp)
    state = TrainState.create(ac.net, tx)
    grads = first_update_grads(ac.net, state)
    step = make_ac_train_step(engine, ac, tx, AC_LOSS)
    losses, norms, deaths = [], [], []
    for draws in inp["draws"]:
        state, st, pool, m = step(state, st, pool, draws=RolloutDraws(*(t(x) for x in draws)))
        losses.append(global_metric(dp, m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
        deaths.append(int(m["imagination_deaths"]))
    return dict(losses=losses, norms=norms, params=params(ac.net), grads=grads,
                ptr=int(pool.ptr),
                obs_buffer=st.obs_buffer.numpy(), re_hx=st.re_hx.numpy(), deaths=deaths,
                pool_digest=[x.numpy().copy() for x in (pool.hx, pool.cx)])


def run_model_free(inp, dp: DataParallel) -> dict:
    """The model-free step on the rank's rows of two recordings of the whole batch."""
    ac = ActorCritic(tc.ActorCriticConfig(**AC))
    load_variables(ac.net, inp["vars"])
    tx = configure_opt(*OPT["model_free"], dp=dp)
    state = TrainState.create(ac.net, tx)
    grads = first_update_grads(ac.net, state)
    step = make_model_free_ac_train_step(ac, tx, AC_LOSS)
    losses, norms = [], []
    for rec in inp["recordings"]:
        state, m = step(state, *(dp.take(t(x)) for x in rec))
        losses.append(global_metric(dp, m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return dict(losses=losses, norms=norms, params=params(ac.net), grads=grads)


def run_cases(inputs: dict, dp: DataParallel) -> dict:
    return {"denoiser": run_denoiser(inputs["denoiser"], dp),
            "denoiser_acc": run_denoiser(inputs["denoiser_acc"], dp, k=2),
            "rew_end": run_rew_end(inputs["rew_end"], dp),
            "ac": run_ac(inputs["ac"], dp),
            "model_free": run_model_free(inputs["model_free"], dp)}


def main(rank: int, world: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        inputs = pickle.loads(Path(workdir, "inputs.pkl").read_bytes())
        out = run_cases(inputs, DataParallel.from_process_group("cpu"))
        Path(workdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
