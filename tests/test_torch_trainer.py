"""The port's trainer (diamond_tpu_torch/trainer.py) and what it adds to the train steps:
the IC-pool manager against the JAX package's, agent snapshots that load in both
packages, the three modes end to end on the CPU at the tiny sizes of
tests/test_trainer_e2e.py (imagination, model-free, static dataset) with resume, the
logged metric keys against the JAX trainer's, and the int8 recalibration after every
world-model step.

Tolerance: pool segments exactly; the pool's burned-in LSTM state and policy features
rtol = atol = 1e-4 against JAX (f32), exactly between the port's own builds; snapshot
trees exactly, the policy's outputs through them rtol = atol = 1e-4; resumed state bit
for bit."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.checkpoint import load_agent_snapshot as j_load_agent_snapshot
from diamond_tpu.data import BatchSampler as JBatchSampler, Dataset as JDataset
from diamond_tpu.data import Episode as JEpisode
from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import Agent as JAgent
from diamond_tpu_torch.config import load_config
from diamond_tpu_torch.checkpoint import load_agent_snapshot
from diamond_tpu_torch.data.batch_sampler import BatchSampler
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.device_store import DeviceEpisodeStore
from diamond_tpu_torch.envs.world_model_env import (PoolManager, encode_pool_feats,
                                                    make_ic_preparer)
from diamond_tpu_torch.models import Agent
from diamond_tpu_torch.ops import quant
from diamond_tpu_torch.trainer import Trainer
from diamond_tpu_torch.utils import final_protocol_metrics, get_path_agent_ckpt

from test_torch_port import SMALL, _jax_agent_config, _port_agent_config
from test_torch_rollout import IMG, NC, NA, engines  # noqa: F401 (fixture)
from test_trainer_e2e import TINY_OVERRIDES
from torch_port_util import close, random_variables

RTOL = ATOL = 1e-4
POOL, CHUNK = 24, 16

# The keys the JAX trainer writes to metrics.jsonl for TINY_OVERRIDES (a run of
# diamond_tpu.trainer.Trainer on the CPU), less "host_rss_gb": the host RSS guard is not
# ported.
JAX_METRIC_KEYS = {"epoch", "duration", "length", "return"} | {
    f"actor_critic/train/{k}" for k in (
        "grad_norm_before_clip", "imagination_deaths", "loss_actions", "loss_entropy",
        "loss_total", "loss_values", "lr", "num_batch_train_actor_critic", "policy_entropy",
        "pool_refill_wait_s")} | {
    "denoiser/test/loss_denoising", "denoiser/test/num_batch_test_denoiser",
    "denoiser/train/grad_norm_before_clip", "denoiser/train/loss_denoising",
    "denoiser/train/lr", "denoiser/train/num_batch_train_denoiser"} | {
    f"final_{k}" for k in ("num_episodes", "num_episodes_all_collected", "return_mean",
                           "return_mean_all_collected", "return_std")} | {
    f"rew_end_model/{split}/classification_metrics/{what}_{m}_class_{i}"
    for split in ("train", "test") for what, n in (("rew", 3), ("end", 2)) for i in range(n)
    for m in ("f1_score", "precision", "recall")} | {
    f"rew_end_model/{split}/{k}" for split in ("train", "test")
    for k in ("loss_end", "loss_rew", "loss_total")} | {
    "rew_end_model/test/num_batch_test_rew_end_model", "rew_end_model/train/grad_norm_before_clip",
    "rew_end_model/train/lr", "rew_end_model/train/num_batch_train_rew_end_model"} | {
    f"{name}/{k}" for name in ("train_dataset", "test_dataset")
    for k in ("counts/end_0", "counts/end_1", "counts/rew_+1", "counts/rew_-1", "counts/rew__0",
              "episode_id", "num_steps")}


# ---------------------------------------------------------------------------
# The IC-pool manager


@pytest.fixture(scope="module")
def pool_data(tmp_path_factory):
    """One dataset of synthetic episodes, written by the JAX package, read by the port."""
    root = tmp_path_factory.mktemp("pool")
    rng = np.random.default_rng(30)
    jds = JDataset(root / "train", "train_dataset")
    for t in (9, 20, 6, 14, 11):
        end = np.zeros(t, np.uint8)
        end[-1] = 1
        jds.add_episode(JEpisode(obs=rng.integers(0, 256, (t, IMG, IMG, 3), dtype=np.uint8),
                                 act=rng.integers(0, NA, t).astype(np.int32),
                                 rew=rng.choice([-1.0, 0.0, 1.0], t).astype(np.float32),
                                 end=end, trunc=np.zeros(t, np.uint8)))
    jds.save_to_default_path()
    ds = Dataset(root / "train", "train_dataset")
    ds.load_from_default_path()
    return jds, ds


def port_manager(e, ds, seed, **kw):
    sampler = BatchSampler(ds, 0, 1, CHUNK, NC, [0.5, 0.5], seed=seed)
    return PoolManager(e["p"], ds, sampler, POOL, chunk=CHUNK, policy_feats=True, **kw)


def assert_pools_equal(a, b):
    for k in ("obs", "act", "hx", "cx", "feats"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_pool_build_matches_jax(engines, pool_data):  # noqa: F811
    e = engines
    ac_vars, _, r_vars = e["vars"]
    jds, ds = pool_data
    jpm = jwm.PoolManager(e["j"], jds, JBatchSampler(jds, 0, 1, CHUNK, NC, [0.5, 0.5], seed=31),
                          POOL, chunk=CHUNK, background=False, policy_feats=True)
    jpool = jpm.build_pool(r_vars, ac_vars)
    pm = port_manager(e, ds, 31, background=False)
    pool = pm.build_pool()
    np.testing.assert_array_equal(pool.obs.numpy(), np.asarray(jpool.obs))
    np.testing.assert_array_equal(pool.act.numpy(), np.asarray(jpool.act))
    for k in ("hx", "cx", "feats"):
        close(getattr(pool, k), getattr(jpool, k), RTOL, ATOL)
    assert int(pool.ptr) == 0 and pool.size == POOL

    # the same ids gathered from a device store on CPU tensors: the same pool
    store = DeviceEpisodeStore(256, (IMG, IMG, 3), device="cpu")
    store.sync(ds)
    spm = port_manager(e, ds, 31, background=False, store=store)
    assert_pools_equal(spm.build_pool(), pool)


def test_pool_refills_when_needs_refill_says_so(engines, pool_data):  # noqa: F811
    e = engines
    _, ds = pool_data
    pm = port_manager(e, ds, 32, background=False)
    pool, swapped = pm.ensure(None, 8)
    assert swapped
    pool.ptr = torch.tensor(POOL - 8)
    assert not pm.needs_refill(pool, 8)
    same, swapped = pm.ensure(pool, 8)
    assert same is pool and not swapped
    pool.ptr = torch.tensor(POOL - 7)
    assert pm.needs_refill(pool, 8)
    new, swapped = pm.ensure(pool, 8)
    assert swapped and new is not pool and int(new.ptr) == 0


def test_background_build_reads_the_snapshot(engines, pool_data):  # noqa: F811
    """The pool built on the thread equals a synchronous build from the same ids, and it
    used the weights of the kick even though the live ones change in place right after
    it (as AdamW does)."""
    e = engines
    _, ds = pool_data
    pac, pr = e["p"].actor_critic, e["p"].rew_end_model
    ac_before, re_before = copy.deepcopy(pac), copy.deepcopy(pr)
    pm = port_manager(e, ds, 33, background=True)
    try:
        first, _ = pm.ensure(None, 8)  # a synchronous build, then the kick
        with torch.no_grad():
            for p in list(pac.net.parameters()) + list(pr.net.parameters()):
                p.add_(0.5)
        pm.wait_pending()
        bg = pm._next_pool
        assert bg is not None and pm.background_builds == 1
        assert_pools_equal(bg, pm.build_pool(ids=pm.last_ids))

        def by_chunk(fn, *xs):  # as the build calls it, a chunk at a time
            outs = [fn(*(x[i:i + CHUNK] for x in xs)) for i in range(0, POOL, CHUNK)]
            if isinstance(outs[0], tuple):
                return tuple(torch.cat(o) for o in zip(*outs))
            return torch.cat(outs)

        assert torch.equal(by_chunk(lambda o: encode_pool_feats(ac_before, o), bg.obs),
                           bg.feats)
        assert not torch.equal(by_chunk(lambda o: encode_pool_feats(pac, o), bg.obs), bg.feats)
        hx, cx = by_chunk(make_ic_preparer(re_before), bg.obs, bg.act)
        assert torch.equal(hx, bg.hx) and torch.equal(cx, bg.cx)
        assert not torch.equal(by_chunk(make_ic_preparer(pr), bg.obs, bg.act)[0], bg.hx)
    finally:
        pm.wait_pending()
        with torch.no_grad():
            for p in list(pac.net.parameters()) + list(pr.net.parameters()):
                p.sub_(0.5)


def test_failed_background_build_is_raised(engines, pool_data):  # noqa: F811
    e = engines
    _, ds = pool_data
    pm = port_manager(e, ds, 34, background=True)
    sample = pm.sampler.sample
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] > 2:  # the synchronous build's two chunks pass, the thread's fail
            raise OSError("disk gone")
        return sample()
    pm.sampler.sample = flaky
    pool, _ = pm.ensure(None, 8)
    with pytest.raises(RuntimeError, match="background IC-pool build failed"):
        pm.wait_pending()


# ---------------------------------------------------------------------------
# Agent snapshots


def test_snapshots_load_in_both_packages(tmp_path):
    ja = JAgent(_jax_agent_config(SMALL))
    variables = {
        "denoiser": random_variables(ja.denoiser.init, img_size=16, seed=40),
        "rew_end_model": random_variables(ja.rew_end_model.init, seed=41),
        "actor_critic": random_variables(ja.actor_critic.init, seed=42)}
    pa = Agent(_port_agent_config(SMALL), device="cpu")
    pa.load_state_dict(variables)

    # the port writes, the JAX package reads
    pa.save(tmp_path / "port.npz")
    tree = j_load_agent_snapshot(tmp_path / "port.npz")
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, variables)
    ja.load(tmp_path / "port.npz")
    rng = np.random.default_rng(43)
    obs = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    carry = (np.zeros((2, 32), np.float32),) * 2
    jout = ja.actor_critic.predict_act_value(ja.variables["actor_critic"], jnp.asarray(obs),
                                             carry)
    with torch.no_grad():
        pout = pa.actor_critic.head(pa.actor_critic.encode(torch.from_numpy(obs)),
                                    tuple(torch.from_numpy(c) for c in carry))
    close(pout.logits_act, jout.logits_act, RTOL, ATOL)
    close(pout.val, jout.val, RTOL, ATOL)

    # the JAX package writes, the port reads (only the flagged models)
    ja.variables = jax.tree_util.tree_map(lambda x: np.asarray(x) * 2, ja.variables)
    ja.save(tmp_path / "jax.npz")
    pb = Agent(_port_agent_config(SMALL), device="cpu")
    pb.load_state_dict(variables)
    pb.load(tmp_path / "jax.npz", load_denoiser=False)
    got = pb.state_dict()
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["denoiser"], variables["denoiser"])
    for name in ("rew_end_model", "actor_critic"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got[name],
                               jax.tree_util.tree_map(np.asarray, ja.variables[name]))
    assert set(load_agent_snapshot(tmp_path / "jax.npz")) == set(variables)


# ---------------------------------------------------------------------------
# The trainer, end to end on the CPU


def states_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            states_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            states_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def make_trainer(run_dir, overrides=(), keep_saves=False, check_int8=False):
    cfg = load_config(TINY_OVERRIDES + list(overrides))
    trainer = Trainer(cfg, run_dir, run_dir=run_dir, device="cpu")
    trainer.saved = []
    trainer.int8_checks = []
    if keep_saves:
        save = trainer.save_checkpoint

        def save_and_keep():
            save()
            trainer.saved.append(copy.deepcopy(trainer.state_dict()))
        trainer.save_checkpoint = save_and_keep
    if check_int8:
        step = trainer._ac_step

        def checked(*a, **k):
            trainer.int8_checks.append(
                quant.folded_from_current_weights(trainer.agent.denoiser.inner_model)
                and quant.folded_from_current_weights(trainer.agent.rew_end_model.net))
            return step(*a, **k)
        trainer._ac_step = checked
    return trainer


def metrics(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def imagination_run(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("run")
    trainer = make_trainer(run_dir, keep_saves=True, check_int8=True)
    trainer.run()
    return trainer, run_dir


def test_imagination_mode_runs_end_to_end(imagination_run):
    trainer, run_dir = imagination_run
    assert trainer.epoch == trainer.num_epochs_collect + 1 == 3
    assert trainer.train_dataset.num_steps == 120
    rows = metrics(run_dir)
    keys = set().union(*rows)
    assert keys == JAX_METRIC_KEYS, (sorted(keys - JAX_METRIC_KEYS),
                                     sorted(JAX_METRIC_KEYS - keys))
    final = [r for r in rows if "final_return_mean" in r]
    assert len(final) == 1 and final[0]["final_num_episodes"] == 2
    returns = [r["return"] for r in rows if "return" in r and r["epoch"] == 3][-2:]
    assert final[0]["final_return_mean"] == pytest.approx(np.mean(returns))
    ck = run_dir / "checkpoints"
    assert (ck / "state.pt").is_file()
    assert json.loads((ck / "info_for_import_script.json").read_text())["epoch"] == 3
    assert get_path_agent_ckpt(ck, -1).name == "agent_epoch_00003.npz"
    assert (run_dir / "config" / "trainer.json").is_file()
    assert (run_dir / "dataset" / "train" / "info.pt").is_file()
    # the snapshot is the trainer's agent
    states_equal(load_agent_snapshot(get_path_agent_ckpt(ck, -1)), trainer.agent.state_dict())


def test_every_ac_step_rolls_out_on_freshly_folded_int8_weights(imagination_run):
    """The denoiser and the rew/end model train before the AC in every epoch; their int8
    weights are folded at calibration, so each AC step must find them folded from the
    weights as they are (``_quant_step`` tracking; a trainer that calibrates once fails
    from the second epoch on)."""
    trainer, _ = imagination_run
    assert len(trainer.int8_checks) == 6 and all(trainer.int8_checks)
    assert [c["denoiser_step"] for c in trainer.calibrations] == [3, 5, 7]
    assert [c["rew_end_step"] for c in trainer.calibrations] == [3, 5, 7]


def test_resume_equals_the_saved_state(imagination_run):
    trainer, run_dir = imagination_run
    resumed = make_trainer(run_dir, ["common.resume=True"])
    states_equal(trainer.saved[-1], resumed.state_dict())
    assert resumed.epoch == 3 and resumed.train_dataset.num_steps == 120
    # one more epoch on the resumed state
    resumed._cfg.training.num_final_epochs = 2
    resumed.run()
    assert resumed.epoch == 4
    rows = metrics(run_dir)
    assert any(r["epoch"] == 4 and "denoiser/train/loss_denoising" in r for r in rows)


def test_initialization_loads_the_flagged_models(imagination_run, tmp_path):
    trainer, run_dir = imagination_run
    path = get_path_agent_ckpt(run_dir / "checkpoints", -1)
    fresh = make_trainer(tmp_path, [f"initialization.path_to_ckpt={path}",
                                    "initialization.load_denoiser=False", "common.seed=8"])
    snap, got = load_agent_snapshot(path), fresh.agent.state_dict()
    states_equal(got["actor_critic"], snap["actor_critic"])
    states_equal(got["rew_end_model"], snap["rew_end_model"])
    with pytest.raises(AssertionError):
        states_equal(got["denoiser"], snap["denoiser"])


def test_model_free_mode(tmp_path):
    trainer = make_trainer(tmp_path, ["training.model_free=True",
                                      "actor_critic.training.batch_size=2",
                                      "training.num_final_epochs=2", "evaluation.every=10",
                                      "collection.test.num_final_episodes=1",
                                      f"tpu.profile_dir={tmp_path / 'profile'}"])
    trainer.run()
    assert (tmp_path / "profile" / "epoch_1_trace.json").is_file()
    assert trainer.num_epochs_collect == 0 and trainer.epoch == 2
    assert trainer.train_states["actor_critic"].step == 2 + 2
    assert trainer.train_states["denoiser"].step == 0
    lines = (tmp_path / "metrics.jsonl").read_text()
    assert "actor_critic/train/loss_total" in lines and "denoiser/train" not in lines
    assert "final_return_mean" in lines


def test_static_dataset_mode(tmp_path):
    static = tmp_path / "static"
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        ds = JDataset(static / split, f"{split}_dataset")
        for _ in range(4):
            t = 24
            end = np.zeros(t, np.uint8)
            end[-1] = 1
            ds.add_episode(JEpisode(
                obs=rng.integers(0, 255, (t, 16, 16, 3), dtype=np.uint8),
                act=rng.integers(0, 3, t).astype(np.int32),
                rew=rng.choice([-1.0, 0.0, 1.0], t).astype(np.float32),
                end=end, trunc=np.zeros(t, np.uint8),
                info={"final_observation": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)}))
        ds.save_to_default_path()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    trainer = make_trainer(run_dir, [f"static_dataset.path={static}",
                                     "training.num_final_epochs=1", "evaluation.every=1"])
    trainer.run()
    assert trainer.epoch == 1 and trainer.train_dataset.is_static
    lines = (run_dir / "metrics.jsonl").read_text()
    assert "denoiser/train/loss_denoising" in lines and "denoiser/test/loss_denoising" in lines
    assert "actor_critic/train/loss_total" in lines and "train_dataset/" not in lines


def test_host_batches_without_the_device_store(tmp_path):
    """tpu.device_dataset=False: the denoiser and rew/end batches come from the host
    prefetcher."""
    trainer = make_trainer(tmp_path, ["tpu.device_dataset=False",
                                      "training.num_final_epochs=1", "evaluation.every=10"])
    trainer.run()
    assert trainer._device_store is None and trainer.train_states["denoiser"].step == 7


def test_final_protocol_metrics_match_jax():
    from diamond_tpu.trainer import final_protocol_metrics as j_final

    rows = [{"test_dataset/episode_id": i, "return": float(r), "length": 10}
            for i, r in enumerate([1, 2, 3, 0])] + [{"test_dataset/num_steps": 40}]
    for episodes in (3, 4, 6):
        assert final_protocol_metrics(rows, episodes) == j_final(rows, episodes)
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        got, want = final_protocol_metrics([], 3), j_final([], 3)
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] == want[k]) or (np.isnan(got[k]) and np.isnan(want[k]))
