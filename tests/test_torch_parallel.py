"""Data parallelism of diamond_tpu_torch (parallel/, the train steps' global semantics,
the replicated device store, the sharded rollout, the trainer's ranks) on the CPU in
float32: two ranks of a gloo process group (tests/torch_dp_worker.py, spawned once for
the module) against the port at world size 1 and against the JAX package's mesh step
on tests/conftest.py's 8 virtual devices, at tests/test_parallel.py's sizes (B = 8) and
on the same weights (random, nothing zero), inputs and draws (rebuilt from the JAX key
splits). The trainer: two ranks through ``main.launch`` against one process.

Tolerances, each with its reason:
  * the two ranks: gradients, parameters and pool equal bit for bit (every rank clips
    and steps on the same reduced gradient), their losses and norms equal;
  * two ranks against world size 1: losses and norms within 1e-6 relative, the first
    update's gradient within 1e-5 of its leaf's largest |value| (the global sums are
    taken in another order: per rank, then over the ranks; at most 1.4e-6 seen), the
    parameters within 1e-6 of their leaf's largest |value| where the gradient is firm
    (above 1e-2 of its leaf's largest |value|), and everywhere within
    tests/test_parallel.py's parameter tolerance: where a gradient lies at the level of
    the f32 noise (the key bias of an attention block, zero in exact arithmetic), Adam
    divides the noise by itself;
  * against the JAX mesh step, tests/test_parallel.py's: losses and norms rtol 1e-4 /
    atol 1e-5, parameters ``_params_allclose`` (rtol 2e-4, atol 2e-5), the imagination
    buffers 2e-4 / 2e-5, the pool pointer exactly;
  * the two-rank trainer against one process: the same dataset steps, metric rows and
    keys, the losses within 1e-4 relative (f32 sums in other orders over a few epochs
    of steps).
"""

import contextlib
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.checkpoint import load_agent_snapshot as j_load_agent_snapshot
from diamond_tpu.data import Dataset as JDataset, Episode as JEpisode, SegmentId as JSegmentId
from diamond_tpu.data.segment import DeviceBatch as JDeviceBatch
from diamond_tpu.data.segment import collate_segments_to_batch as j_collate
from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import (ActorCritic as JActorCritic, ActorCriticConfig as JACConfig,
                                Agent as JAgent, AgentConfig as JAgentConfig,
                                Denoiser as JDenoiser, DenoiserConfig as JDenoiserConfig,
                                DiffusionSamplerConfig as JSamplerConfig,
                                InnerModelConfig as JInnerConfig, RewEndModel as JRewEnd,
                                RewEndModelConfig as JRewEndConfig,
                                SigmaDistributionConfig as JSigmaConfig)
from diamond_tpu.models.actor_critic import ActorCriticLossConfig as JLossConfig
from diamond_tpu.models.agent import configure_opt as j_configure_opt
from diamond_tpu.parallel import (batch_sharding, make_mesh, replicate as j_replicate,
                                  shard_device_batch as j_shard_batch,
                                  shard_imag_state as j_shard_imag_state,
                                  shard_pool as j_shard_pool)
from diamond_tpu.training import TrainState as JTrainState
from diamond_tpu.training import (make_ac_train_step as j_make_ac_step,
                                  make_denoiser_train_step as j_make_denoiser_step,
                                  make_model_free_ac_train_step as j_make_mf_step,
                                  make_rew_end_train_step as j_make_rew_end_step)
from diamond_tpu_torch import config as tc
from diamond_tpu_torch.checkpoint import load_agent_snapshot
from diamond_tpu_torch.config import load_config
from diamond_tpu_torch.interop.jax_vars import load_variables, variables_to_state_dict
from diamond_tpu_torch.main import launch, plan_devices
from diamond_tpu_torch.envs.world_model_env import ImagState
from diamond_tpu_torch.models import Denoiser, DenoiserDraws
from diamond_tpu_torch.parallel import (DataParallel, select_devices, shard_device_batch,
                                        shard_imag_state)
from diamond_tpu_torch.trainer import Trainer
from diamond_tpu_torch.utils import get_path_agent_ckpt

import torch_dp_worker as w
from test_torch_denoiser_training import jax_draws as denoiser_draws
from test_torch_grad_acc import j_build_tx
from test_trainer_e2e import TINY_OVERRIDES
from torch_port_util import REPO, random_variables, t

B, IMG, C, NC, NA, D = w.B, w.IMG, w.C, w.NC, w.NA, w.D
T_DEN = NC + 2                       # two autoregressive windows
PADS = [6, 5, 4, 2, 0, 0, 0, 0]      # leading padded frames of each row: rank 0's rows only
J_SIGMA = JSigmaConfig(**asdict(w.SIGMA))
J_LOSS = JLossConfig(**asdict(w.AC_LOSS))
DEN_KEYS = (5, 6)
ACC_KEYS = (7, 8, 9, 10)             # four micro-steps (one window), two updates at k = 2
AC_KEYS = (0, 1)
REW_T = 6
REW_STARTS = [0, 3, 7, 14, -2, 5, 11, 16]  # tests/test_parallel.py's windows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_models():
    jd = JDenoiser(JDenoiserConfig(inner_model=JInnerConfig(**w.INNER), sigma_data=0.5,
                                   sigma_offset_noise=0.3))
    jr = JRewEnd(JRewEndConfig(**w.REW))
    ja = JActorCritic(JACConfig(**w.AC))
    return jd, jr, ja


def _rollout_draws(key, num_steps):
    """The JAX rollout's random numbers at the global batch, rebuilt from its key splits
    (tests/test_torch_rollout.py ``jax_draws`` at B = 8)."""
    x_init, g_act, g_rew, g_end = [], [], [], []
    for step_rng in jax.random.split(key, num_steps):
        k_act, k_wm = jax.random.split(step_rng)
        k_sample, k_rew, k_end = jax.random.split(k_wm, 3)
        _, rng_init = jax.random.split(k_sample)
        x_init.append(jax.random.normal(rng_init, (B, IMG, IMG, C)))
        g_act.append(jax.random.gumbel(k_act, (B, NA), jnp.float32))
        g_rew.append(jax.random.gumbel(k_rew, (B, 3), jnp.float32))
        g_end.append(jax.random.gumbel(k_end, (B, 2), jnp.float32))
    return [np.stack([np.asarray(x) for x in z]) for z in (x_init, g_act, g_rew, g_end)]


def _denoiser_inputs(variables, keys, t_total=T_DEN):
    rng = np.random.default_rng(60)
    obs = rng.integers(0, 256, (B, t_total, IMG, IMG, C), dtype=np.uint8)
    act = rng.integers(0, NA, (B, t_total)).astype(np.int32)
    mask = np.ones((B, t_total), bool)
    for i, pad in enumerate(PADS):  # padded as the collate pads: zeros, mask False
        mask[i, :pad] = False
        obs[i, :pad] = 0
        act[i, :pad] = 0
    draws = [[x.numpy() for x in denoiser_draws(jax.random.PRNGKey(k), t_total - NC, B)]
             for k in keys]
    return dict(vars=variables, obs=obs, act=act, mask=mask, draws=draws, keys=keys)


def _recording(seed):
    """tests/test_torch_model_free.py's recording at B = 8: ends and truncations in both
    halves, the reset gate after each, a reset at the first step of one env."""
    rng = np.random.default_rng(seed)
    t_ = w.AC_LOSS.backup_every
    end = np.zeros((B, t_), np.float32)
    trunc = np.zeros((B, t_), np.float32)
    end[0, 1], trunc[1, 2], end[2, 3], end[5, 0], trunc[6, 1] = 1, 1, 1, 1, 1
    reset = np.zeros((B, t_), np.float32)
    reset[:, 1:] = (end + trunc)[:, :-1]
    reset[2, 0] = reset[7, 0] = 1
    return [rng.integers(0, 256, (B, t_, IMG, IMG, C), dtype=np.uint8),
            rng.integers(0, NA, (B, t_)).astype(np.int32),
            rng.choice([-1.0, 0.0, 1.0, 2.0], (B, t_)).astype(np.float32), end, trunc, reset,
            (0.5 * rng.normal(size=(B, D))).astype(np.float32),
            (0.5 * rng.normal(size=(B, D))).astype(np.float32),
            rng.normal(size=(B, t_)).astype(np.float32)]


def _write_dataset(path):
    """tests/test_parallel.py's two episodes of 20 steps, each ending in a death with
    its final frame."""
    rng = np.random.default_rng(1)
    ds = JDataset(path, "ds")
    for _ in range(2):
        end = np.zeros(20, np.uint8)
        end[-1] = 1
        ds.add_episode(JEpisode(
            obs=rng.integers(0, 255, (20, IMG, IMG, C), dtype=np.uint8),
            act=rng.integers(0, NA, 20).astype(np.int32),
            rew=rng.choice([-1.0, 0.0, 1.0], 20).astype(np.float32),
            end=end, trunc=np.zeros(20, np.uint8),
            info={"final_observation": rng.integers(0, 255, (IMG, IMG, C), dtype=np.uint8)}))
    ds.save_to_default_path()
    return ds


def _jax_state(params, tx, mesh):
    """A replicated train state; the steps' outputs are placed back the same way, so that
    each step compiles once."""
    return j_replicate(JTrainState.create(jax.tree_util.tree_map(jnp.array, params), tx), mesh)


def _jax_result(state, losses, norms, **more):
    p = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, state.params)})
    return dict(losses=losses, norms=norms, params={n: v.numpy() for n, v in p.items()},
                **more)


def _jax_diffusion(inp, tx, mesh):
    jd, _, _ = _jax_models()
    step = j_make_denoiser_step(jd, tx, J_SIGMA)
    s = _jax_state(inp["vars"]["params"], tx, mesh)
    consts = j_replicate(inp["vars"].get("constants", {}), mesh)
    b, t_ = inp["act"].shape
    db = j_shard_batch(JDeviceBatch(
        obs=jnp.asarray(inp["obs"]), act=jnp.asarray(inp["act"]), rew=jnp.zeros((b, t_)),
        end=jnp.zeros((b, t_), jnp.int32), trunc=jnp.zeros((b, t_), jnp.int32),
        mask_padding=jnp.asarray(inp["mask"]), final_obs=jnp.zeros((b, IMG, IMG, C), jnp.uint8),
        has_final_obs=jnp.zeros((b,), bool)), mesh)
    losses, norms = [], []
    for k in inp["keys"]:
        s, m = step(s, consts, db, jax.random.PRNGKey(k))
        s = j_replicate(s, mesh)
        losses.append(float(m["loss_denoising"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return _jax_result(s, losses, norms)


def _jax_rew_end(inp, mesh):
    _, jr, _ = _jax_models()
    ds = JDataset(inp["dataset"], "ds")
    ds.load_from_default_path()
    tx = j_configure_opt(*w.OPT["rew_end"])
    step = j_make_rew_end_step(jr, tx)
    s = _jax_state(inp["vars"]["params"], tx, mesh)
    db = j_shard_batch(jax.tree_util.tree_map(jnp.asarray, JDeviceBatch.from_batch(
        j_collate([ds[JSegmentId(*i)] for i in inp["ids"]]))), mesh)
    losses, norms = [], []
    for _ in range(2):
        s, m = step(s, db)
        s = j_replicate(s, mesh)
        losses.append(float(m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return _jax_result(s, losses, norms)


def _jax_ac(inp, mesh):
    jd, jr, ja = _jax_models()
    ac_vars, d_vars, r_vars = inp["vars"]
    engine = jwm.ImaginationEngine(jd, jr, ja, jwm.WorldModelEnvConfig(
        horizon=w.WM.horizon, num_batches_to_preload=1,
        diffusion_sampler=JSamplerConfig(num_steps_denoising=2)))
    obs, act = jnp.asarray(inp["pool_obs"]), jnp.asarray(inp["pool_act"])
    hx, cx = jwm.make_ic_preparer(jr)(r_vars, obs, act)
    pool = jwm.ICPool(obs=obs, act=act, hx=hx, cx=cx, ptr=jnp.asarray(0, jnp.int32))
    st, pool = engine.initial_state(pool, B)
    st, pool = j_shard_imag_state(st, mesh), j_shard_pool(pool, mesh)
    tx = j_configure_opt(*w.OPT["ac"])
    step = j_make_ac_step(engine, ja, tx, J_LOSS)
    s = _jax_state(ac_vars["params"], tx, mesh)
    dv, rv = j_replicate(d_vars, mesh), j_replicate(r_vars, mesh)
    losses, norms = [], []
    for k in AC_KEYS:
        s, st, pool, m = step(s, dv, rv, st, pool, jax.random.PRNGKey(k))
        s = j_replicate(s, mesh)
        st, pool = j_shard_imag_state(st, mesh), j_shard_pool(pool, mesh)
        losses.append(float(m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return _jax_result(s, losses, norms, ptr=int(pool.ptr),
                       obs_buffer=np.asarray(st.obs_buffer))


def _jax_model_free(inp, mesh):
    _, _, ja = _jax_models()
    tx = j_configure_opt(*w.OPT["model_free"])
    step = j_make_mf_step(ja, tx, J_LOSS)
    s = _jax_state(inp["vars"]["params"], tx, mesh)
    losses, norms = [], []
    for rec in inp["recordings"]:
        s, m = step(s, *(jax.device_put(jnp.asarray(x), batch_sharding(mesh)) for x in rec))
        s = j_replicate(s, mesh)
        losses.append(float(m["loss_total"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return _jax_result(s, losses, norms)


def _jax_mesh_steps(inputs, mesh):
    """The JAX package's train steps on the 8-device mesh (tests/test_parallel.py's
    placements), two steps each: losses, norms and parameters (by the port's names).
    The five compile and run on threads of their own."""
    jobs = {"denoiser": (_jax_diffusion, inputs["denoiser"],
                         j_configure_opt(*w.OPT["denoiser"])),
            "denoiser_acc": (_jax_diffusion, inputs["denoiser_acc"],
                             j_build_tx(*w.OPT["denoiser"], 2, False)),
            "rew_end": (_jax_rew_end, inputs["rew_end"]),
            "ac": (_jax_ac, inputs["ac"]),
            "model_free": (_jax_model_free, inputs["model_free"])}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(f, *args, mesh) for k, (f, *args) in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@contextlib.contextmanager
def one_thread():
    """One intra-op thread here and in the processes spawned meanwhile: beside busy test
    processes, oversubscribed ranks crawl."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The five cases at world size 2 (two gloo ranks), at world size 1 and on the JAX
    mesh, from the same inputs."""
    work = tmp_path_factory.mktemp("dp")
    jd, jr, ja = _jax_models()
    d_vars = random_variables(jd.init, img_size=IMG, seed=51)
    r_vars = random_variables(jr.init, seed=52)
    ac_vars = random_variables(ja.init, seed=53)
    _write_dataset(work / "ds")
    rng = np.random.default_rng(0)
    inputs = {
        "denoiser": _denoiser_inputs(d_vars, DEN_KEYS),
        "denoiser_acc": _denoiser_inputs(d_vars, ACC_KEYS, NC + 1),
        "rew_end": dict(vars=r_vars, dataset=str(work / "ds"),
                        ids=[(i % 2, s, s + REW_T) for i, s in enumerate(REW_STARTS)]),
        "ac": dict(vars=(ac_vars, d_vars, r_vars),
                   pool_obs=rng.integers(0, 255, (64, NC, IMG, IMG, C), dtype=np.uint8),
                   pool_act=rng.integers(0, NA, (64, NC)).astype(np.int32),
                   draws=[_rollout_draws(jax.random.PRNGKey(k), w.AC_LOSS.backup_every)
                          for k in AC_KEYS]),
        "model_free": dict(vars=ac_vars, recordings=[_recording(70), _recording(71)]),
    }
    (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port), str(work)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        with one_thread():
            one = w.run_cases(inputs, DataParallel())
        mesh = make_mesh()
        assert len(mesh.devices.ravel()) == 8
        jax_out = _jax_mesh_steps(inputs, mesh)
    finally:
        outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so[-2000:]}\n{se[-4000:]}"
    ranks = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    return dict(inputs=inputs, ranks=ranks, one=one, jax=jax_out)


FIRM = 1e-2


def _ranks_equal(ranks, case):
    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["losses"] == r1["losses"] and r0["norms"] == r1["norms"]
    for key in ("params", "grads"):
        assert r0[key].keys() == r1[key].keys()
        for n in r0[key]:
            np.testing.assert_array_equal(r0[key][n], r1[key][n], err_msg=f"{key} {n}")


def _params_allclose(p1, p2, rtol=2e-4, atol=2e-5):
    """tests/test_parallel.py's parameter check, over the port's names."""
    assert p1.keys() == p2.keys()
    for n in p1:
        np.testing.assert_allclose(p1[n], p2[n], rtol=rtol, atol=atol, err_msg=n)


def _close_to_world_one(two, one):
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(two["norms"], one["norms"], rtol=1e-6)
    assert two["grads"].keys() == one["grads"].keys()
    for n, g in one["grads"].items():
        np.testing.assert_allclose(two["grads"][n], g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=n)
        firm = np.abs(g) > FIRM * np.abs(g).max()
        p = one["params"][n]
        np.testing.assert_allclose(two["params"][n][firm], p[firm], rtol=0,
                                   atol=1e-6 * np.abs(p).max(), err_msg=n)
    _params_allclose(two["params"], one["params"])


def _close_to_jax_mesh(two, j):
    np.testing.assert_allclose(two["losses"], j["losses"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(two["norms"], j["norms"], rtol=1e-4, atol=1e-5)
    _params_allclose(two["params"], j["params"])


def _check_case(runs, case):
    _ranks_equal(runs["ranks"], case)
    two = runs["ranks"][0][case]
    _close_to_world_one(two, runs["one"][case])
    _close_to_jax_mesh(two, runs["jax"][case])
    return two


def test_select_devices():
    """common.devices resolution (tests/test_parallel.py test_select_devices), over 8
    cards."""
    assert select_devices("all", 8) == select_devices(None, 8) == list(range(8))
    assert select_devices(2, 8) == [2]
    assert select_devices([1, 3, 5], 8) == [1, 3, 5]
    with pytest.raises(ValueError, match="out of range"):
        select_devices([0, 99], 8)
    with pytest.raises(ValueError, match="duplicate"):
        select_devices([1, 1], 8)
    with pytest.raises(ValueError, match="empty"):
        select_devices([], 8)


def test_launch_plan_follows_the_jax_trainer(capsys):
    """All selected cards where tpu.data_parallel holds and the batch sizes divide over
    them; else the first, with the JAX trainer's warnings."""
    assert plan_devices(load_config(["common.devices=[1,3]"]), 4) == [1, 3]
    assert "data-parallel over 2 of 4 devices" in capsys.readouterr().out
    assert plan_devices(load_config([]), 1) == [0]
    assert plan_devices(load_config(["denoiser.training.batch_size=6"]), 4) == [0]
    out = capsys.readouterr().out
    assert "do not divide 4 devices" in out and "WARNING: common.devices selected 4" in out
    assert plan_devices(load_config(["tpu.data_parallel=False", "common.devices=[2,3]"]),
                        4) == [2]
    out = capsys.readouterr().out
    assert "only 2 will be used" in out and "running on selected device 2" in out


def test_rows_and_shards():
    """A rank's rows of the global batch; a batch must divide over the ranks."""
    dp = DataParallel()
    x = torch.arange(8)
    assert dp.rows(8) == slice(0, 8) and dp.take(x) is x and dp.assemble(x) is x
    two = DataParallel.__new__(DataParallel)
    two.device, two.group, two.rank, two.world = torch.device("cpu"), None, 1, 2
    assert two.rows(8) == slice(4, 8) and two.take(x).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not divide"):
        two.rows(7)
    inp = _denoiser_inputs(None, ())
    batch = shard_device_batch(w.denoiser_batch(inp), two)
    assert batch.obs.shape[0] == 4 and batch.mask_global.shape == (B, T_DEN)
    assert torch.equal(batch.mask_padding, t(inp["mask"][4:]))
    whole = _port_state()
    st = shard_imag_state(whole, two)
    assert st.obs_buffer.shape[0] == 4 and torch.equal(st.ep_len, whole.ep_len[4:])


def test_host_batches_take_the_ranks_rows(tmp_path):
    """The prefetcher's pack (tpu.device_dataset off): under a data-parallel handle with
    a group, each rank packs its rows of the global batch the host collates, with the
    whole padding mask beside them."""
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.data.prefetch import pack, unpack
    from diamond_tpu_torch.data.segment import SegmentId, collate_segments_to_batch

    _write_dataset(tmp_path / "ds")
    ds = Dataset(tmp_path / "ds", "ds")
    ds.load_from_default_path()
    host = collate_segments_to_batch([ds[SegmentId(i % 2, s, s + REW_T)]
                                      for i, s in enumerate(REW_STARTS)])
    for rank, rows in ((0, slice(0, 4)), (1, slice(4, 8))):
        dp = DataParallel.__new__(DataParallel)
        dp.device, dp.group, dp.rank, dp.world = torch.device("cpu"), object(), rank, 2
        batch = unpack(torch.from_numpy(pack(host, dp)[0]), pack(host, dp)[1])
        for name in ("obs", "act", "rew", "end", "mask_padding", "final_obs", "has_final_obs"):
            np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                          getattr(host, name)[rows], err_msg=name)
        np.testing.assert_array_equal(batch.mask_global.numpy(), host.mask_padding)
    whole = unpack(torch.from_numpy(pack(host)[0]), pack(host)[1])
    assert whole.mask_global is None and whole.obs.shape[0] == B


def _port_state():
    z = torch.zeros
    return ImagState(obs_buffer=z((B, NC, IMG, IMG, C), dtype=torch.uint8),
                     act_buffer=z((B, NC), dtype=torch.int32), re_hx=z((B, D)),
                     re_cx=z((B, D)), ac_hx=z((B, D)), ac_cx=z((B, D)),
                     ep_len=torch.arange(B, dtype=torch.int32))


def test_dp_denoiser_step_matches_one_rank_and_the_jax_mesh(runs):
    """Two denoiser steps on a batch whose padding differs between the halves. A step
    that averaged the ranks' own masked means would miss the global mean: the mean of
    the halves' means is checked to differ from the global loss by ten times the
    tolerance."""
    _check_case(runs, "denoiser")
    inp = runs["inputs"]["denoiser"]
    den = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**w.INNER)))
    load_variables(den.inner_model, inp["vars"])
    obs = t(inp["obs"]).float() / 255 * 2 - 1
    draws = [t(x) for x in inp["draws"][0]]
    halves = []
    with torch.no_grad():
        for rows in (slice(0, 4), slice(4, 8)):
            half_draws = DenoiserDraws(*(x[:, rows] for x in draws))
            halves.append(den.loss(obs[rows], t(inp["act"])[rows], t(inp["mask"])[rows],
                                   w.SIGMA, half_draws)[0].item())
    global_loss = runs["ranks"][0]["denoiser"]["losses"][0]
    # ten times the loss tolerance against the JAX mesh, 1e3 times that against one rank
    assert abs(np.mean(halves) - global_loss) > 10 * 1e-4 * abs(global_loss), \
        (halves, global_loss)


def test_dp_accumulated_denoiser_step(runs):
    """grad_acc_steps = 2: one all_reduce per update, on the accumulated mean, equals
    the JAX mesh step under optax.MultiSteps (each micro-gradient global there)."""
    two = _check_case(runs, "denoiser_acc")
    assert len(two["losses"]) == 4


def test_dp_rew_end_step_from_the_replicated_store(runs):
    """Each rank's store mirrors the whole dataset and gathers its rows of the global
    batch (the host collate's rows), with the global mask beside them."""
    _check_case(runs, "rew_end")
    ids = runs["inputs"]["rew_end"]["ids"]
    ds = JDataset(runs["inputs"]["rew_end"]["dataset"], "ds")
    ds.load_from_default_path()
    host = j_collate([ds[JSegmentId(*i)] for i in ids])
    for r, rows in enumerate((slice(0, 4), slice(4, 8))):
        np.testing.assert_array_equal(runs["ranks"][r]["rew_end"]["obs_rows"], host.obs[rows])
        np.testing.assert_array_equal(runs["ranks"][r]["rew_end"]["mask_rows"],
                                      host.mask_padding[rows])
    counts = host.mask_padding[:, :-1].sum(axis=1)
    assert counts[:4].sum() != counts[4:].sum()  # the halves hold different counts


def test_dp_ac_step_consumes_the_pool_as_one_global_pointer(runs):
    """Two actor-critic steps with deaths in both halves: the pointer advances by the
    global death count, the same on both ranks and as on the mesh; the buffers match."""
    two = _check_case(runs, "ac")
    r0, r1 = runs["ranks"][0]["ac"], runs["ranks"][1]["ac"]
    assert min(r0["deaths"]) > 0 and min(r1["deaths"]) > 0
    assert r0["ptr"] == r1["ptr"] == runs["one"]["ac"]["ptr"] == runs["jax"]["ac"]["ptr"]
    assert r0["ptr"] >= B + sum(r0["deaths"]) + sum(r1["deaths"]) - 1
    for a, b in zip(r0["pool_digest"], r1["pool_digest"]):
        np.testing.assert_array_equal(a, b)  # each rank's pool, built alike
    buf = np.concatenate([r0["obs_buffer"], r1["obs_buffer"]])
    np.testing.assert_array_equal(buf, runs["one"]["ac"]["obs_buffer"])
    np.testing.assert_allclose(buf, runs["jax"]["ac"]["obs_buffer"], rtol=2e-4, atol=2e-5)
    assert two["losses"][0] != two["losses"][1]


def test_dp_model_free_step(runs):
    _check_case(runs, "model_free")


# ---------------------------------------------------------------------------
# The trainer: two ranks through main.launch against one process


TRAINER_OVERRIDES = TINY_OVERRIDES + ["collection.train.num_steps_total=90",
                                      "training.num_final_epochs=1"]


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """One process (on a thread here) and two ranks (spawned), run side by side."""
    one, two = tmp_path_factory.mktemp("one"), tmp_path_factory.mktemp("two")
    cfg = load_config(TRAINER_OVERRIDES)
    trainer = Trainer(cfg, one, run_dir=one, device="cpu")
    errors = []

    def run_one():
        try:
            trainer.run()
        except BaseException as e:  # raised below, on the test's thread
            errors.append(e)

    with one_thread():
        thread = threading.Thread(target=run_one)
        thread.start()
        try:
            launch(cfg, two, two, ["cpu", "cpu"], backend="gloo")
        finally:
            thread.join(timeout=600)
    assert not thread.is_alive() and not errors, errors
    return trainer, one, two


def test_two_rank_trainer_matches_one_process(trainer_runs):
    trainer, one, two = trainer_runs
    rows1, rows2 = _rows(one), _rows(two)
    assert trainer.epoch == 2
    assert [sorted(r) for r in rows2] == [sorted(r) for r in rows1]  # rank 0 alone logs
    steps = [r["train_dataset/num_steps"] for r in rows2 if "train_dataset/num_steps" in r]
    assert steps and steps == [r["train_dataset/num_steps"] for r in rows1
                               if "train_dataset/num_steps" in r]
    losses = [k for k in set().union(*rows1) if "/train/loss" in k or "/test/loss" in k]
    assert any(k.startswith("actor_critic/") for k in losses)
    for k in losses:
        a = [r[k] for r in rows2 if k in r]
        b = [r[k] for r in rows1 if k in r]
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=k)


def test_two_rank_checkpoint_loads_in_both_packages_and_resumes(trainer_runs):
    """The run's snapshot loads in the JAX package and in the port; a resumed two-rank
    run trains one more epoch from the saved state."""
    trainer, _, two = trainer_runs
    path = get_path_agent_ckpt(two / "checkpoints", -1)
    tree, jtree = load_agent_snapshot(path), j_load_agent_snapshot(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal, jtree, tree)
    a = trainer.agent.cfg
    inner = {k: v for k, v in asdict(a.denoiser.inner_model).items()
             if k not in ("num_actions", "is_upsampler")}
    ja = JAgent(JAgentConfig(
        denoiser=JDenoiserConfig(inner_model=JInnerConfig(**inner), sigma_data=0.5,
                                 sigma_offset_noise=0.3),
        rew_end_model=JRewEndConfig(**{k: v for k, v in asdict(a.rew_end_model).items()
                                       if k != "num_actions"}),
        actor_critic=JACConfig(**{k: v for k, v in asdict(a.actor_critic).items()
                                  if k != "num_actions"}), num_actions=a.num_actions))
    ja.load(path)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, ja.variables), tree)

    cfg = load_config(TRAINER_OVERRIDES + ["common.resume=True", "training.num_final_epochs=2"])
    (two / ".run_is_over").unlink(missing_ok=True)
    with one_thread():
        launch(cfg, two, two, ["cpu", "cpu"], backend="gloo")
    rows = _rows(two)
    assert any(r["epoch"] == 3 and "denoiser/train/loss_denoising" in r for r in rows)
    assert get_path_agent_ckpt(two / "checkpoints", -1).name == "agent_epoch_00003.npz"
