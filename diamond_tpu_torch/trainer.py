"""The training loop (diamond_tpu/trainer.py) on one card, or as one rank of a
data-parallel group (one process per card): collect -> train the denoiser,
the rew/end model and the actor-critic in imagination -> collect test episodes and
evaluate -> log and checkpoint, per epoch.

  * the initial collection runs until the minority rewards reach
    ``collection.train.first_epoch.threshold_rew`` (or its ``max`` steps); its size sets
    the number of collecting epochs, ``training.num_final_epochs`` follow;
  * each component trains ``steps_first_epoch`` micro-steps on epoch 1, else
    ``steps_per_epoch``, after ``start_after_epochs``; the denoiser and rew/end batches
    come from the device episode store (``tpu.device_dataset``) or the host prefetcher;
  * the actor-critic trains in imagination on the world model, from the IC pool of
    ``PoolManager``; with ``tpu.int8_rollout`` the world model runs the static int8
    path, recalibrated on the live imagination buffers whenever the denoiser's or the
    rew/end model's step count moved since its last calibration: the int8 weights are
    folded from the float ones at calibration, so a model that trained since would
    otherwise roll out on its old weights;
  * ``training.model_free``: the actor-critic alone, on recordings of the real env;
    ``static_dataset.path``: no collection, a fixed dataset;
  * the two-stage world model (``agent=csgo``, ``agent.upsampler`` set): the upsampler
    is a fourth component, trained per frame on the dataset's full-resolution segments,
    and the dynamics denoiser trains on their area downsample, made in its step. It
    collects nothing (the policy and the rew/end model work at the low resolution), so
    it needs a static dataset; ``training.wm_only`` trains the denoiser and the
    upsampler alone and evaluates both. Imagination RL with an upsampler is refused, as
    in the JAX package; int8 is calibrated only for imagination, so a wm_only run never
    calibrates;
  * after the last epoch, the final-protocol collection (``final_return_mean``);
  * checkpoints: the full state (``checkpoints/state.pt``, ``torch.save``: weights,
    AdamW moments, step counts, accumulators, counters, both datasets' state), the
    weights-only agent snapshots both packages load (checkpoint.py), the datasets.

The card runs everything unless the caller passes ``device="cpu"`` (the tests). Each
consumer of random numbers has its own generator, seeded from ``common.seed``: numpy
(the samplers, the env seeds), a CPU generator for the initial weights, and on the
device one each for collection, the denoiser's draws, the rollout's noise (and the
calibration's draws), the upsampler's draws and the evaluation's draws.

Data parallelism (``dp``, a ``DataParallel`` of a process group; main.py spawns the
ranks): every rank holds the whole models, optimizer states, datasets' index, device
store and IC pool, seeds every generator alike, and trains on its rows of each global
batch with the JAX package's global semantics (parallel/mesh.py). Rank 0 alone collects
(the initial collection, each epoch's, the test and final ones), evaluates on the full
test batches, logs and writes checkpoints; after a collection it broadcasts the train
dataset's index (the episode files it wrote are read from the run dir by every rank,
one host) and the collecting epochs' count, and every rank syncs its own store. The step
metrics are summed over the ranks once per component (``_materialize_logs``); a barrier
ends each checkpoint, so each epoch. Only the main thread issues collectives, in the
same order on every rank.

Metrics stay on the device during a component's steps and are read with one copy per
key at its end (``_materialize_logs``). ``timings`` holds the wall seconds of each part
of the run (the card synchronised at the parts' boundaries only): one entry for the
initial collection (epoch 0), one per epoch, one for the final collection.

Not ported: the host RSS guard.
"""

from __future__ import annotations

import copy
import os
import random
import shutil
import time
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import Config, save_config
from .coroutines import Collector, EnvLoop, NumToCollect
from .data.batch_sampler import BatchSampler
from .data.dataset import Dataset
from .data.device_store import DeviceEpisodeStore, StoreBatchIterator
from .data.episode import obs_to_float
from .data.prefetch import BatchPrefetcher
from .data.segment import DeviceBatch
from .data.traverser import DatasetTraverser
from .envs.env import make_env
from .envs.world_model_env import ImaginationEngine, PoolManager
from .models.agent import Agent
from .ops import quant
from .parallel import DataParallel, replicate, replicate_pool
from .training import (OptimizerSpec, TrainState, make_ac_train_step,
                       make_denoiser_eval_step, make_denoiser_train_step,
                       make_model_free_ac_train_step, make_rew_end_eval_step,
                       make_rew_end_train_step, make_upsampler_eval_step,
                       make_upsampler_train_step)
from .utils import (Logs, MetricsLogger, count_parameters, final_protocol_metrics,
                    keep_agent_copies_every,
                    process_confusion_matrices_if_any_and_compute_classification_metrics,
                    save_info_for_import_script, set_seed)

POOL_CHUNK = 512
# step metrics equal on every rank (not summed over the ranks)
REPLICATED = frozenset({"grad_norm_before_clip"})


class Trainer:
    def __init__(self, cfg: Config, root_dir: Path, run_dir: Optional[Path] = None,
                 device: Union[str, torch.device] = "cuda",
                 dp: Optional[DataParallel] = None) -> None:
        self._cfg = cfg
        self._root_dir = Path(root_dir)
        self._run_dir = Path(run_dir) if run_dir is not None else Path.cwd()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on an NVIDIA GPU (the "
                               "tests pass device='cpu')")
        self._dp = dp if dp is not None else DataParallel(self.device)
        self._main = self._dp.is_main

        seed = cfg.common.seed if cfg.common.seed is not None else random.randint(0, 10 ** 9)
        seed = self._dp.broadcast_object(seed)  # every rank draws alike
        set_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._gens = {name: torch.Generator(device=self.device).manual_seed(seed + i)
                      for i, name in enumerate(("denoiser", "rollout", "upsampler", "eval"),
                                               start=3)}

        self._is_static_dataset = cfg.static_dataset.path is not None
        self._is_model_free = cfg.training.model_free
        self._wm_only = cfg.training.wm_only
        self._has_upsampler = cfg.agent.upsampler is not None
        self._ds_factor = cfg.agent.downsample_factor
        self._compute_dtype = torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16" \
            else torch.float32
        self._int8_rollout = cfg.tpu.int8_rollout
        self._int8_sites = quant.parse_sites(cfg.tpu.int8_sites)
        self._quant_step = -1     # the denoiser's step count at its last calibration
        self._r_quant_step = -1   # the rew/end model's
        self.calibrations: List[Dict[str, Any]] = []
        if self._int8_rollout:
            self._print("int8 rollout inference enabled (tpu.int8_rollout)")

        self.logger = MetricsLogger(self._run_dir / "metrics.jsonl", asdict(cfg.wandb)) \
            if self._main else None
        self._path_ckpt_dir = self._run_dir / "checkpoints"
        self._path_state_ckpt = self._path_ckpt_dir / "state.pt"
        if not cfg.common.resume and self._main:
            self._path_ckpt_dir.mkdir(exist_ok=False, parents=True)
            save_config(cfg, self._run_dir / "config" / "trainer.json")
            src, src_copy = self._root_dir / "diamond_tpu_torch", self._run_dir / "src"
            if src.is_dir() and not src_copy.exists():
                shutil.copytree(src, src_copy,
                                ignore=shutil.ignore_patterns("build", "__pycache__"))

        # datasets: rank 0's on disk; the other ranks read its episode files
        p = Path(cfg.static_dataset.path) if self._is_static_dataset \
            else self._run_dir / "dataset"
        self.train_dataset = Dataset(p / "train", "train_dataset",
                                     cache_in_ram=cfg.training.cache_in_ram,
                                     save_on_disk=self._main)
        self.test_dataset = Dataset(p / "test", "test_dataset", cache_in_ram=True,
                                    save_on_disk=self._main)
        self.train_dataset.load_from_default_path()
        self.test_dataset.load_from_default_path()
        if self._is_static_dataset:
            self.train_dataset.is_static = True
        if self._has_upsampler and not self._is_static_dataset:
            raise ValueError(
                "two-stage (agent.upsampler) training collects nothing itself — the "
                "policy/reward nets live at the dynamics (low) resolution and cannot act "
                "on full-res env frames; set static_dataset.path (the csgo operating "
                "mode, with training.wm_only=True)")

        # envs (host side)
        train_env = make_env(num_envs=cfg.collection.train.num_envs, **asdict(cfg.env.train))
        test_env = make_env(num_envs=cfg.collection.test.num_envs, **asdict(cfg.env.test))
        num_actions = int(test_env.num_actions)

        # agent
        agent_cfg = copy.deepcopy(cfg.agent)
        agent_cfg.num_actions = num_actions
        agent_cfg.__post_init__()
        self.agent = Agent(agent_cfg, self._compute_dtype, device=self.device,
                           generator=torch.Generator().manual_seed(seed))
        self.model_names = self.agent.model_names
        init = cfg.initialization
        if init.path_to_ckpt is not None:
            self.agent.load(Path(init.path_to_ckpt), load_denoiser=init.load_denoiser,
                            load_rew_end_model=init.load_rew_end_model,
                            load_actor_critic=init.load_actor_critic)
        for net in self.agent.nets.values():
            replicate(net, self._dp)

        if not self._is_static_dataset and self._main:
            self._train_collector = Collector(train_env, self.agent.actor_critic,
                                              self.train_dataset,
                                              epsilon=cfg.collection.train.epsilon, seed=seed)
            self._test_collector = Collector(test_env, self.agent.actor_critic,
                                             self.test_dataset,
                                             epsilon=cfg.collection.test.epsilon,
                                             reset_every_collect=True, seed=seed + 1)

        # optimizers, train steps
        self._opt_specs = {name: OptimizerSpec.from_cfg(getattr(cfg, name).optimizer,
                                                        getattr(cfg, name).training,
                                                        cfg.tpu.grad_acc_sum)
                           for name in self.model_names}
        self._tx = {name: spec.build(self._dp) for name, spec in self._opt_specs.items()}
        self._sigma_cfg = cfg.denoiser.sigma_distribution
        self._loss_cfg = cfg.actor_critic.actor_critic_loss
        self.engine = ImaginationEngine(self.agent.denoiser, self.agent.rew_end_model,
                                        self.agent.actor_critic, cfg.world_model_env,
                                        dp=self._dp)
        self._denoiser_step = make_denoiser_train_step(self.agent.denoiser,
                                                       self._tx["denoiser"], self._sigma_cfg,
                                                       self._ds_factor)
        if self._has_upsampler:
            up_sigma = cfg.upsampler.sigma_distribution
            self._upsampler_step = make_upsampler_train_step(
                self.agent.upsampler, self._tx["upsampler"], up_sigma)
            self._upsampler_eval = make_upsampler_eval_step(self.agent.upsampler, up_sigma)
        self._rew_end_step = make_rew_end_train_step(self.agent.rew_end_model,
                                                     self._tx["rew_end_model"])
        self._ac_step = make_ac_train_step(self.engine, self.agent.actor_critic,
                                           self._tx["actor_critic"], self._loss_cfg)
        if self._is_model_free:
            rl_env = make_env(num_envs=cfg.actor_critic.training.batch_size,
                              **asdict(cfg.env.train))
            self._rl_env_loop = EnvLoop(rl_env, self.agent.actor_critic, epsilon=0.0,
                                        seed=seed + 2)
            self._mf_ac_step = make_model_free_ac_train_step(
                self.agent.actor_critic, self._tx["actor_critic"], self._loss_cfg)
        self._denoiser_eval = make_denoiser_eval_step(self.agent.denoiser, self._sigma_cfg,
                                                      self._ds_factor)
        self._rew_end_eval = make_rew_end_eval_step(self.agent.rew_end_model)
        self.train_states: Dict[str, TrainState] = {
            name: TrainState.create(self.agent.nets[name], self._tx[name])
            for name in self.model_names}

        # data pipelines
        self._seq_len_denoiser = (cfg.agent.denoiser.inner_model.num_steps_conditioning + 1
                                  + cfg.denoiser.training.num_autoregressive_steps)
        self._batch_sources: Dict[str, Any] = {}
        self._device_store: Optional[DeviceEpisodeStore] = None
        if cfg.tpu.device_dataset and not self._is_model_free:
            cap = cfg.tpu.device_dataset_capacity
            if cap is None:
                budget = int(cfg.collection.train.num_steps_total)
                if self._is_static_dataset:
                    budget = max(budget, self.train_dataset.num_steps)
                cap = int(1.25 * budget) + 2048
            size = cfg.env.train.size
            self._device_store = DeviceEpisodeStore(int(cap), (size, size, 3),
                                                    device=self.device)
            if self.train_dataset.num_episodes:
                self._device_store.sync(self.train_dataset)

        # imagination (made when the actor-critic first trains)
        self._imag_state = None
        self._pool = None
        self._pool_manager: Optional[PoolManager] = None

        # counters
        self.epoch = 0
        self.num_epochs_collect: Optional[int] = None
        self.num_episodes_test = 0
        self.num_batch_train = {name: 0 for name in self.model_names}
        self.num_batch_test = {name: 0 for name in self.model_names}
        self.timings: List[Dict[str, Any]] = []
        self._timing: Dict[str, Any] = {}

        if cfg.common.resume:
            self.load_state_checkpoint()
        else:
            self.save_checkpoint()

        for name, net in self.agent.nets.items():
            self._print(f"{count_parameters(net)} parameters in {name}")
        self._print(self.train_dataset)
        self._print(self.test_dataset)

    # -- helpers --------------------------------------------------------------

    def _print(self, *args: Any) -> None:
        """Rank 0 prints."""
        if self._main:
            print(*args)

    def _timed(self, key: str, t0: float) -> None:
        """Add the wall seconds since ``t0`` (the card synchronised) to this part's
        ``key``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._timing[key] = self._timing.get(key, 0.0) + time.perf_counter() - t0

    def _calibrate_if_stale(self) -> None:
        """With tpu.int8_rollout: calibrate the denoiser (one sampling pass) and the
        rew/end model (one step on an adjacent pair of frames) on the live imagination
        buffers where its step count moved since its last calibration."""
        if not self._int8_rollout:
            return
        d_step = self.train_states["denoiser"].step
        r_step = self.train_states["rew_end_model"].step
        if d_step == self._quant_step and r_step == self._r_quant_step:
            return
        t0 = time.perf_counter()
        st = self._imag_state
        obs_f = obs_to_float(st.obs_buffer)
        if d_step != self._quant_step:
            # the sampler's initial latents at the global batch, this rank's rows
            b, dp = obs_f.shape[0], self._dp
            x_init = dp.take(torch.randn((b * dp.world,) + tuple(obs_f.shape[2:]),
                                         generator=self._gens["rollout"], device=self.device))
            self.engine.sampler.calibrate(obs_f, st.act_buffer, self._int8_sites,
                                          x_init=x_init, dp=dp)
            self._quant_step = d_step
        if r_step != self._r_quant_step:
            self.agent.rew_end_model.calibrate(obs_f[:, -2:-1], st.act_buffer[:, -2:-1],
                                               obs_f[:, -1:], self._int8_sites, dp=self._dp)
            self._r_quant_step = r_step
        self._timed("recalibration_s", t0)
        self.calibrations.append(dict(epoch=self.epoch, denoiser_step=d_step,
                                      rew_end_step=r_step))
        self._print(f"int8 recalibrated at denoiser step {d_step}, rew/end step {r_step} "
                    f"({time.perf_counter() - t0:.2f} s)")

    def _batches(self, name: str):
        """The endless batch iterator of ``name``'s training."""
        if name not in self._batch_sources:
            cfg = self._cfg
            c = getattr(cfg, name).training
            seq_length = self._seq_len_denoiser if name == "denoiser" else c.seq_length
            weights = None if (self._is_static_dataset
                               and cfg.static_dataset.ignore_sample_weights) \
                else list(c.sample_weights)
            sampler = BatchSampler(self.train_dataset, 0, 1, c.batch_size, seq_length,
                                   weights, can_sample_beyond_end=(name == "rew_end_model"),
                                   seed=int(self._np_rng.integers(0, 2 ** 31 - 1)))
            if self._device_store is not None:
                self._batch_sources[name] = StoreBatchIterator(self._device_store, sampler,
                                                               self._dp)
            else:
                self._batch_sources[name] = iter(BatchPrefetcher(
                    self.train_dataset, sampler, workers=cfg.training.num_workers_data_loaders,
                    device=self.device, dp=self._dp))
        return self._batch_sources[name]

    def _ensure_imagination(self) -> None:
        cfg = self._cfg
        c = cfg.actor_critic.training
        if self._has_upsampler:
            raise ValueError(
                "imagination RL with a two-stage world model needs a low-res IC pool — "
                "not supported; set training.wm_only=True (or training.model_free=True)")
        if self._pool_manager is None:
            weights = None if (self._is_static_dataset
                               and cfg.static_dataset.ignore_sample_weights) \
                else list(c.sample_weights)
            n_cond = cfg.agent.denoiser.inner_model.num_steps_conditioning
            sampler = BatchSampler(self.train_dataset, 0, 1, POOL_CHUNK, n_cond, weights,
                                   seed=int(self._np_rng.integers(0, 2 ** 31 - 1)))
            pool_size = cfg.world_model_env.num_batches_to_preload * c.batch_size
            self._pool_manager = PoolManager(self.engine, self.train_dataset, sampler,
                                             pool_size, chunk=POOL_CHUNK,
                                             store=self._device_store,
                                             policy_feats=cfg.tpu.pool_policy_feats)
        max_consumption = self._loss_cfg.backup_every * c.batch_size + c.batch_size
        self._pool, swapped = self._pool_manager.ensure(self._pool, max_consumption)
        if swapped:
            self._pool = replicate_pool(self._pool, self._dp)
        if self._imag_state is None:
            self._imag_state, self._pool = self.engine.initial_state(self._pool, c.batch_size)

    # -- main loop ------------------------------------------------------------

    def run(self) -> None:
        cfg = self._cfg
        to_log: Logs = []

        if self.epoch == 0:
            if self._is_model_free or self._is_static_dataset:
                self.num_epochs_collect = 0
            else:
                self._timing = {"epoch": 0}
                t0 = time.perf_counter()
                if self._main:
                    self.num_epochs_collect, logs = self.collect_initial_dataset()
                    to_log += logs
                self.num_epochs_collect = self._dp.broadcast_object(self.num_epochs_collect)
                self._share_train_dataset()
                self._timed("collect_s", t0)
                self._timing["collect_steps"] = self.train_dataset.num_steps
                self.timings.append(self._timing)

        num_epochs = self.num_epochs_collect + cfg.training.num_final_epochs
        profile_dir = cfg.tpu.profile_dir

        while self.epoch < num_epochs:
            self.epoch += 1
            self._timing = {"epoch": self.epoch}
            start_time = time.time()
            self._print(f"\nEpoch {self.epoch} / {num_epochs}\n")

            prof = None
            if profile_dir and self.epoch == 1 and self._main:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()

            should_collect_train = (not self._is_model_free and not self._is_static_dataset
                                    and self.epoch <= self.num_epochs_collect)
            if should_collect_train:
                if self._pool_manager is not None:
                    # the pool builder samples the train dataset: let it finish first
                    self._pool_manager.wait_pending()
                t0 = time.perf_counter()
                n0 = self.train_dataset.num_steps
                if self._main:
                    to_log += self._train_collector.send(
                        NumToCollect(steps=cfg.collection.train.steps_per_epoch))
                self._share_train_dataset()
                self._timed("collect_s", t0)
                self._timing["collect_steps"] = self.train_dataset.num_steps - n0

            if cfg.training.should:
                to_log += self.train_agent()

            should_test = (cfg.evaluation.should and self.epoch % cfg.evaluation.every == 0
                           and self._main)
            if should_test and not self._is_static_dataset:
                t0 = time.perf_counter()
                to_log += self.collect_test()
                self._timed("test_collect_s", t0)
            if should_test and not self._is_model_free:
                t0 = time.perf_counter()
                to_log += self.test_agent()
                self._timed("eval_s", t0)

            if prof is not None:
                prof.stop()
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(profile_dir) / "epoch_1_trace.json"))

            to_log.append({"duration": (time.time() - start_time) / 3600})
            if self.logger is not None:
                self.logger.log(to_log, self.epoch)
            to_log = []
            t0 = time.perf_counter()
            self.save_checkpoint()
            self._timed("checkpoint_s", t0)
            if self._pool_manager is not None:
                pm = self._pool_manager
                self._timing.update(pool_builds=pm.builds, pool_swaps=pm.swaps)
            self.timings.append(self._timing)

        if not self._is_static_dataset and self._main:
            t0 = time.perf_counter()
            self._timing = {"epoch": "final"}
            self.logger.log(self.collect_test(final=True), self.epoch)
            self._timed("test_collect_s", t0)
            self.timings.append(self._timing)
        if self._pool_manager is not None:
            self._pool_manager.wait_pending()
        self._dp.barrier()  # the ranks end with rank 0's final protocol

    # -- collection -----------------------------------------------------------

    def _share_train_dataset(self) -> None:
        """After rank 0 collected: its train dataset's index on every rank (the episode
        files it wrote are read from the shared run dir)."""
        if self._dp.world == 1:
            return
        sd = self._dp.broadcast_object(self.train_dataset.state_dict() if self._main else None)
        if not self._main:
            self.train_dataset.load_state_dict(sd)

    def collect_initial_dataset(self):
        """Collect until the minority rewards reach the threshold (at least ``min``, at
        most ``max`` steps). Returns (collecting epochs left, logs)."""
        self._print("\nInitial collect\n")
        to_log: Logs = []
        c = self._cfg.collection.train
        min_steps, steps_per_epoch = c.first_epoch.min, c.steps_per_epoch
        max_steps, threshold_rew = c.first_epoch.max, c.first_epoch.threshold_rew
        assert min_steps % steps_per_epoch == 0

        steps = min_steps
        while True:
            to_log += self._train_collector.send(NumToCollect(steps=steps))
            num_steps = self.train_dataset.num_steps
            total_minority_rew = sum(sorted(self.train_dataset.counts_rew)[:-1])
            if total_minority_rew >= threshold_rew:
                break
            if max_steps is not None and num_steps >= max_steps:
                self._print("Reached the specified maximum for initial collect")
                break
            self._print(f"Minority reward: {total_minority_rew}/{threshold_rew} "
                        "-> Keep collecting\n")
            steps = steps_per_epoch

        self._print("\nSummary of initial collect:")
        self._print(f"Num steps: {num_steps} / {c.num_steps_total}")
        remaining = c.num_steps_total - num_steps
        assert remaining % steps_per_epoch == 0
        return remaining // steps_per_epoch, to_log

    def collect_test(self, final: bool = False) -> Logs:
        c = self._cfg.collection.test
        episodes = c.num_final_episodes if final else c.num_episodes
        td = self.test_dataset
        td.clear()
        to_log = self._test_collector.send(NumToCollect(episodes=episodes))
        key_ep_id = f"{td.name}/episode_id"
        to_log = [{k: v + self.num_episodes_test if k == key_ep_id else v
                   for k, v in d.items()} for d in to_log]
        self._print(f"\nSummary of {'final' if final else 'test'} collect: "
                    f"{td.num_episodes} episodes ({td.num_steps} steps)")
        self.num_episodes_test += episodes
        if final:
            to_log.append(final_protocol_metrics(to_log, episodes))
            self._print(to_log[-1])
        return to_log

    # -- training -------------------------------------------------------------

    def train_agent(self) -> Logs:
        to_log: Logs = []
        if self._device_store is not None:  # mirror the episodes collected since
            self._device_store.sync(self.train_dataset)
        if self._is_model_free:
            names = ["actor_critic"]
        elif self._wm_only:
            names = [n for n in self.model_names if n in ("denoiser", "upsampler")]
        else:
            names = list(self.model_names)
        for name in names:
            c = getattr(self._cfg, name).training
            if self.epoch > c.start_after_epochs:
                steps = c.steps_first_epoch if self.epoch == 1 else c.steps_per_epoch
                t0 = time.perf_counter()
                to_log += self.train_component(name, steps)
                self._timed(f"{name}_s", t0)
                self._timing[f"{name}_steps"] = c.grad_acc_steps * steps
        return to_log

    def train_component(self, name: str, steps: int) -> Logs:
        c = getattr(self._cfg, name).training
        num_steps = c.grad_acc_steps * steps  # micro-steps
        to_log: Logs = []
        spec = self._opt_specs[name]
        if name == "denoiser":
            step = self.denoiser_train_step
        elif name == "upsampler":
            step = self.upsampler_train_step
        elif name == "rew_end_model":
            step = self.rew_end_train_step
        elif self._is_model_free:
            step = self.model_free_train_step
        else:
            step = self.ac_train_step
            self._timing["pool_refill_wait_s"] = 0.0
        for _ in range(num_steps):
            self._finish_step_metrics(name, step(), to_log, spec)
        out = self._materialize_logs(to_log, self._dp)
        process_confusion_matrices_if_any_and_compute_classification_metrics(out)
        return [{f"{name}/train/{k}": v for k, v in d.items()} for d in out]

    def denoiser_train_step(self) -> Dict[str, Any]:
        """One denoiser step on the next batch; the metrics stay on the device."""
        ts, metrics = self._denoiser_step(self.train_states["denoiser"],
                                          next(self._batches("denoiser")),
                                          generator=self._gens["denoiser"])
        self.train_states["denoiser"] = ts
        return metrics

    def upsampler_train_step(self) -> Dict[str, Any]:
        """One upsampler step on the next batch of full-resolution segments."""
        ts, metrics = self._upsampler_step(self.train_states["upsampler"],
                                           next(self._batches("upsampler")),
                                           generator=self._gens["upsampler"])
        self.train_states["upsampler"] = ts
        return metrics

    def rew_end_train_step(self) -> Dict[str, Any]:
        ts, metrics = self._rew_end_step(self.train_states["rew_end_model"],
                                         next(self._batches("rew_end_model")))
        self.train_states["rew_end_model"] = ts
        return metrics

    def ac_train_step(self) -> Dict[str, Any]:
        """One actor-critic step in imagination: the pool refilled where it must be, the
        int8 world model recalibrated where a world-model step count moved."""
        self._ensure_imagination()
        self._calibrate_if_stale()
        ts, self._imag_state, self._pool, metrics = self._ac_step(
            self.train_states["actor_critic"], self._imag_state, self._pool,
            generator=self._gens["rollout"])
        self.train_states["actor_critic"] = ts
        pm = self._pool_manager
        metrics = dict(metrics, pool_refill_wait_s=pm.last_refill_wait_s)
        self._timing["pool_refill_wait_s"] = \
            self._timing.get("pool_refill_wait_s", 0.0) + pm.last_refill_wait_s
        pm.last_refill_wait_s = 0.0
        return metrics

    def model_free_train_step(self) -> Dict[str, Any]:
        """One actor-critic step on ``backup_every`` steps of the real env."""
        obs, act, rew, end, trunc, _, _, val_boot, _ = self._rl_env_loop.send(
            self._loss_cfg.backup_every)
        ex = self._rl_env_loop.last_extras
        take = self._dp.take  # every rank steps the whole batch of envs alike
        as_t = lambda x: take(torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
        ts, metrics = self._mf_ac_step(
            self.train_states["actor_critic"], as_t(obs), as_t(act),
            as_t(rew.astype(np.float32)), as_t(end), as_t(trunc), as_t(ex["reset_mask"]),
            take(ex["hx0"]), take(ex["cx0"]), take(val_boot))
        self.train_states["actor_critic"] = ts
        return metrics

    def _finish_step_metrics(self, name: str, metrics: Dict, to_log: Logs,
                             spec: OptimizerSpec) -> None:
        metrics = dict(metrics)
        metrics[f"num_batch_train_{name}"] = self.num_batch_train[name]
        self.num_batch_train[name] += 1
        metrics["lr"] = spec.lr_at(self.num_batch_train[name] - 1)
        to_log.append(metrics)

    @staticmethod
    def _materialize_logs(to_log: Logs, dp: Optional[DataParallel] = None) -> Logs:
        """Device tensors to host values: the values of one key (a nested dict's keys
        apart) are stacked on the device and copied with one transfer. With a
        data-parallel ``dp`` the ranks' shares are summed first, every key but the
        gradient norm (the same on every rank) by one all_reduce."""
        is_dev = lambda v: isinstance(v, torch.Tensor)
        per_key: Dict[Any, list] = {}
        for d in to_log:
            for k, v in d.items():
                if isinstance(v, dict):
                    for kk, vv in v.items():
                        if is_dev(vv):
                            per_key.setdefault((k, kk), []).append(vv)
                elif is_dev(v):
                    per_key.setdefault(k, []).append(v)
        stacked = {k: torch.stack([v.detach().float() for v in vs])
                   for k, vs in per_key.items()}
        if dp is not None:
            dp.all_reduce_sum_flat([v for k, v in stacked.items() if k not in REPLICATED])
        fetched = {k: v.cpu().numpy() for k, v in stacked.items()}
        counters = {k: 0 for k in fetched}

        def take(key):
            i = counters[key]
            counters[key] += 1
            return fetched[key][i]

        out = []
        for d in to_log:
            row = {}
            for k, v in d.items():
                if isinstance(v, dict):
                    row[k] = {kk: (take((k, kk)) if is_dev(vv) else np.asarray(vv))
                              for kk, vv in v.items()}
                elif is_dev(v):
                    val = take(k)
                    row[k] = float(val) if val.ndim == 0 else val
                else:
                    row[k] = v
            out.append(row)
        return out

    def test_agent(self) -> Logs:
        """The denoiser's and rew/end model's losses (and the upsampler's; under wm_only
        not the rew/end model's) over the test episodes, gathered from a device store of
        their own (made anew each evaluation)."""
        to_log: Logs = []
        names = ["denoiser", "rew_end_model"] + (["upsampler"] if self._has_upsampler else [])
        if self._wm_only:
            names.remove("rew_end_model")
        test_store = None
        if self._device_store is not None and self.test_dataset.num_episodes:
            size = self._cfg.env.train.size
            test_store = DeviceEpisodeStore(self.test_dataset.num_steps + 8, (size, size, 3),
                                            device=self.device)
            test_store.sync(self.test_dataset)
        for name in names:
            c = getattr(self._cfg, name).training
            if self.epoch <= c.start_after_epochs:
                continue
            seq_length = self._seq_len_denoiser if name == "denoiser" else c.seq_length
            traverser = DatasetTraverser(self.test_dataset, c.batch_size, seq_length,
                                         pad_to_batch=True)
            batches = (test_store.make_batch(ids, masked)
                       for ids, masked in traverser.iter_batches_ids()) \
                if test_store is not None else \
                (DeviceBatch.from_batch(b, self.device) for b in traverser)
            logs: Logs = []
            for db in batches:
                if name == "denoiser":
                    metrics = self._denoiser_eval(db, generator=self._gens["eval"])
                elif name == "upsampler":
                    metrics = self._upsampler_eval(db, generator=self._gens["eval"])
                else:
                    metrics = self._rew_end_eval(db)
                metrics = dict(metrics)
                metrics[f"num_batch_test_{name}"] = self.num_batch_test[name]
                self.num_batch_test[name] += 1
                logs.append(metrics)
            logs = self._materialize_logs(logs)
            process_confusion_matrices_if_any_and_compute_classification_metrics(logs)
            to_log += [{f"{name}/test/{k}": v for k, v in d.items()} for d in logs]
        return to_log

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The full resume state, copied to the host."""
        cpu = lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

        def opt_sd(opt):
            sd = opt.state_dict()
            return {"state": {i: {k: cpu(v) for k, v in s.items()}
                              for i, s in sd["state"].items()},
                    "param_groups": copy.deepcopy(sd["param_groups"])}

        return {
            "train_states": {name: {"net": {k: cpu(v) for k, v in ts.net.state_dict().items()},
                                    "opt_state": opt_sd(ts.opt_state),
                                    "step": ts.step,
                                    "acc": None if ts.acc is None else [cpu(a) for a in ts.acc]}
                             for name, ts in self.train_states.items()},
            "epoch": self.epoch,
            "num_epochs_collect": self.num_epochs_collect,
            "num_episodes_test": self.num_episodes_test,
            "num_batch_train": dict(self.num_batch_train),
            "num_batch_test": dict(self.num_batch_test),
            "train_dataset": self.train_dataset.state_dict(),
            "test_dataset": self.test_dataset.state_dict(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for name in self.model_names:
            tss = sd["train_states"][name]
            ts = self.train_states[name]
            ts.net.load_state_dict(tss["net"], strict=True)
            quant.strip(ts.net)  # folded from other weights: calibrated again
            ts.opt_state.load_state_dict(tss["opt_state"])
            ts.step = int(tss["step"])
            ts.acc = None if tss["acc"] is None else [a.to(self.device) for a in tss["acc"]]
        self.epoch = sd["epoch"]
        self.num_epochs_collect = sd["num_epochs_collect"]
        self.num_episodes_test = sd["num_episodes_test"]
        self.num_batch_train = dict(sd["num_batch_train"])
        self.num_batch_test = dict(sd["num_batch_test"])
        self.train_dataset.load_state_dict(sd["train_dataset"])
        self.test_dataset.load_state_dict(sd["test_dataset"])
        if self._device_store is not None and self.train_dataset.num_episodes:
            self._device_store.sync(self.train_dataset)

    def load_state_checkpoint(self) -> None:
        self.load_state_dict(torch.load(self._path_state_ckpt, map_location="cpu",
                                        weights_only=False))

    def save_checkpoint(self) -> None:
        """The full state (written to a temporary file, then renamed over the old one), the
        datasets' state, this epoch's agent snapshot and the import script's info, by
        rank 0; then every rank waits for it."""
        if self._main:
            self._write_checkpoint()
        self._dp.barrier()

    def _write_checkpoint(self) -> None:
        tmp = self._path_state_ckpt.with_suffix(".tmp")
        torch.save(self.state_dict(), tmp)
        os.replace(tmp, self._path_state_ckpt)
        self.train_dataset.save_to_default_path()
        self.test_dataset.save_to_default_path()
        keep_agent_copies_every(self.agent.state_dict(), self.epoch, self._path_ckpt_dir,
                                every=self._cfg.checkpointing.save_agent_every,
                                num_to_keep=self._cfg.checkpointing.num_to_keep)
        save_info_for_import_script(self.epoch, self._cfg.wandb.name, self._path_ckpt_dir)
