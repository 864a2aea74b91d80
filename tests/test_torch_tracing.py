"""The port's program spans (diamond_tpu_torch/tracing.py) and the IC-pool manager's
counters, on the CPU at a tiny size: one actor-critic train step in imagination under
``torch.profiler`` holds each span the stated number of times, nested as stated and
never inside one of its own name; without a profiler the same step records nothing and
gives bit-identical loss and parameters; a pool manager counts the bytes it gathers
exactly, and the seconds its builds and its callers' waits take."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diamond_tpu_torch import config as tc
from diamond_tpu_torch import tracing
from diamond_tpu_torch.data.batch_sampler import BatchSampler
from diamond_tpu_torch.data.dataset import Dataset
from diamond_tpu_torch.data.episode import Episode
from diamond_tpu_torch.envs.world_model_env import (ImaginationEngine, PoolManager,
                                                    draw_rollout_noise)
from diamond_tpu_torch.models import ActorCritic, Denoiser, RewEndModel
from diamond_tpu_torch.models.agent import configure_opt
from diamond_tpu_torch.models.blocks import init_weights
from diamond_tpu_torch.training import TrainState, make_ac_train_step

IMG, C, NC, NA, D = 16, 3, 4, 3, 16
B, T, POOL, CHUNK = 4, 3, 24, 8
INNER = dict(img_channels=C, num_steps_conditioning=NC, cond_channels=16, depths=[1, 1],
             channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
REW = dict(lstm_dim=D, img_channels=C, img_size=IMG, cond_channels=8, depths=[1, 1],
           channels=[8, 8], attn_depths=[0, 0], num_actions=NA)
AC = dict(lstm_dim=D, img_channels=C, img_size=IMG, channels=[8, 8], down=[1, 1],
          num_actions=NA)
TOP = ("pool::ensure", "ac::rollout", "ac::loss", "train::backward", "train::update")
IN_ROLLOUT = ("wm::transition", "ac::policy", "ac::reset")


def dataset() -> Dataset:
    rng = np.random.default_rng(5)
    ds = Dataset("unused", "train_dataset", cache_in_ram=True, save_on_disk=False)
    for n in (9, 20, 6, 14):
        end = np.zeros(n, np.uint8)
        end[-1] = 1
        ds.add_episode(Episode(obs=rng.integers(0, 256, (n, IMG, IMG, C), dtype=np.uint8),
                               act=rng.integers(0, NA, n).astype(np.int32),
                               rew=rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32),
                               end=end, trunc=np.zeros(n, np.uint8)))
    return ds


def make_engine() -> ImaginationEngine:
    den = Denoiser(tc.DenoiserConfig(inner_model=tc.InnerModelConfig(**INNER)))
    eng = ImaginationEngine(den, RewEndModel(tc.RewEndModelConfig(**REW)),
                            ActorCritic(tc.ActorCriticConfig(**AC)),
                            tc.WorldModelEnvConfig(horizon=2, diffusion_sampler=tc.
                                                   DiffusionSamplerConfig(num_steps_denoising=2)))
    g = torch.Generator().manual_seed(0)
    for net in (den.inner_model, eng.rew_end_model.net, eng.actor_critic.net):
        init_weights(net, g)
    with torch.no_grad():  # the zero-init heads would leave most gradients zero
        for p in eng.actor_critic.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return eng


def manager(eng, ds, seed=7, **kw) -> PoolManager:
    sampler = BatchSampler(ds, 0, 1, CHUNK, NC, [0.5, 0.5], seed=seed)
    return PoolManager(eng, ds, sampler, POOL, chunk=CHUNK, policy_feats=True, **kw)


class Setup:
    """An engine, its pool manager (synchronous builds), the imagination state, the AC
    step and its draws: everything one step needs, from fixed seeds."""

    def __init__(self, ds) -> None:
        self.eng = make_engine()
        self.pm = manager(self.eng, ds, background=False)
        self.consumption = T * B + B
        self.pool, _ = self.pm.ensure(None, self.consumption)
        self.st, self.pool = self.eng.initial_state(self.pool, B)
        tx = configure_opt(1e-3, 0.0, 1e-8, 100.0, 0)
        self.state = TrainState.create(self.eng.actor_critic.net, tx)
        self.step = make_ac_train_step(self.eng, self.eng.actor_critic, tx,
                                       tc.ActorCriticLossConfig(backup_every=T))
        self.draws = draw_rollout_noise(T, B, (IMG, IMG, C), NA,
                                        torch.Generator().manual_seed(3), "cpu")

    def run(self):
        self.pool, _ = self.pm.ensure(self.pool, self.consumption)
        self.state, self.st, self.pool, m = self.step(self.state, self.st, self.pool,
                                                      draws=self.draws)
        return m["loss_total"]


def events(prof):
    """{name: [(start_ns, end_ns, thread), ...]} of the trace's CPU ranges."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU"):
            s = e.start_ns()
            out.setdefault(e.name(), []).append((s, s + e.duration_ns(), e.start_thread_id()))
    return out


def inside(inner, outer) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b, _ in outer)


@pytest.fixture(scope="module")
def traced():
    ds = dataset()
    plain, prof_run = Setup(ds), Setup(ds)
    loss_plain = plain.run()
    assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss_prof = prof_run.run()
    return plain, prof_run, loss_plain, loss_prof, events(prof)


def test_an_ac_step_holds_each_span_as_often_as_stated(traced):
    *_, ev = traced
    counts = {n: len(ev.get(n, [])) for n in TOP + IN_ROLLOUT}
    # the policy: the first frame's features, then per imagined step the main eval, the
    # final frame's value and the burn-in after the reset, then the bootstrap value
    assert counts == {"pool::ensure": 1, "ac::rollout": 1, "ac::loss": 1,
                      "train::backward": 1, "train::update": 1, "wm::transition": T,
                      "ac::policy": 2 + 3 * T, "ac::reset": T}, counts


def test_the_spans_nest_as_stated(traced):
    *_, ev = traced
    for name in IN_ROLLOUT:
        assert all(inside(s, ev["ac::rollout"]) for s in ev[name]), name
    tops = sorted(s for n in TOP for s in ev[n])
    assert all(a[1] <= b[0] for a, b in zip(tops, tops[1:])), "top-level spans overlap"
    assert all(inside(s, ev["train::update"]) for s in ev["Optimizer.step#AdamW.step"])
    for name in TOP + IN_ROLLOUT:  # never a span in one of its own name
        spans = sorted(ev[name])
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), name
    # the rollout's spans are disjoint from each other
    inner = sorted(s for n in IN_ROLLOUT for s in ev[n])
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))


def test_without_a_profiler_a_step_records_nothing_and_gives_the_same_numbers(traced):
    plain, prof_run, loss_plain, loss_prof, _ = traced
    assert tracing.span("ac::rollout") is tracing.span("train::update")  # the shared no-op
    assert torch.equal(loss_plain, loss_prof)
    for (k, a), (_, b) in zip(plain.state.net.state_dict().items(),
                              prof_run.state.net.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(plain.st.obs_buffer, prof_run.st.obs_buffer)
    assert int(plain.pool.ptr) == int(prof_run.pool.ptr)


def test_the_pool_manager_counts_its_bytes_builds_and_waits():
    ds = dataset()
    eng = make_engine()
    pm = manager(eng, ds, background=True)
    sample = pm.sampler.sample

    def slow_on_the_build_thread():  # the background build takes a while: a real wait
        if threading.current_thread().name == "diamond-pool-builder":
            time.sleep(0.05)
        return sample()

    pm.sampler.sample = slow_on_the_build_thread
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=tracing.all_threads()) as prof:
        pool, _ = pm.ensure(None, 8)  # a synchronous build, then the kick
        pm.wait_pending()
    assert pm.builds == 2 and pm.background_builds == 1
    per_segment = NC * IMG * IMG * C * 1 + NC * 4  # uint8 frames, int32 actions
    assert pm.gather_bytes == 2 * POOL * per_segment
    assert pm.build_s > 0.15 and pm.build_cpu_s > 0  # three slow chunks on the thread
    assert pm.build_cpu_s < pm.build_s  # the thread slept: CPU time is not wall time
    assert pm.wait_s > 0.03
    ev = events(prof)
    assert len(ev["pool::wait"]) == 1 and len(ev["pool::ensure"]) == 1
    builds = ev["pool::build"]
    assert inside(builds[0], ev["pool::ensure"])
    if tracing.all_threads() is not None:  # the build thread is recorded too
        assert len(builds) == 2 and len({s[2] for s in builds}) == 2
    # a swap waits on the build thread through wait_pending: counted once, as a wait
    waited = pm.wait_s
    pool.ptr = torch.tensor(POOL)
    pm.ensure(pool, 8)
    assert pm.swaps == 2 and pm.wait_s >= waited
    pm.wait_pending()


def test_concurrent_builds_lose_no_count():
    """Builds on more threads than cores, the interpreter switching threads as often as
    it can: every build and every byte is counted."""
    import sys

    ds = dataset()
    pm = manager(make_engine(), ds, background=False)
    pm.build_pool()
    ids, per_build = pm.last_ids, pm.gather_bytes
    n = 12
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=pm.build_pool, kwargs=dict(ids=ids))
                   for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert pm.builds == n + 1 and pm.gather_bytes == (n + 1) * per_build
