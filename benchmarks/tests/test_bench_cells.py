"""Every cell driven on the CPU at a size a test run holds: the harness's whole run but
its look for a chip, against the plain reference; the control (the reference in the
next lower precision in the program's place) fails a compared number; each fault the
cell can have, planted underneath the timed path, makes ``correct`` false; equal seeds
make equal traffic; nothing the run loads is JAX or the JAX package.

    python -m pytest benchmarks/tests -q
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import bench  # noqa: E402
from harness.episodes import make_episodes  # noqa: E402

MAN = bench.manifest()
# cells whose drivers and traffic are kept though BENCHMARK.json leaves them out (PERF.md,
# Open questions: the denoiser's rate has no bound that holds on both fast and slow
# hosts; the rew/end step meets the program's action-embedding gradient), driven here
# all the same, with the end-to-end metric they report
LEFT_OUT = [{"name": "atari-denoiser-step-b512", "config": "atari-default",
             "traffic": "denoiser-b512-seg6", "chips": 1, "why": "left out"},
            {"name": "atari-rew-end-step-b256", "config": "atari-default",
             "traffic": "rew-end-b256-seq19", "chips": 1, "why": "left out"}]
LEFT_OUT_E2E = [{"name": "wm_train_frames_per_s", "unit": "frames/s", "better": "higher",
                 "bound": 0.25, "source": "host_clock",
                 "workloads": [w["name"] for w in LEFT_OUT]}]
MAN = dict(MAN, workloads=MAN["workloads"] + LEFT_OUT,
           end_to_end=MAN["end_to_end"] + LEFT_OUT_E2E)
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2 ** 33 + 7  # more than 32 signed bits


def tiny(workload: str):
    """The cell's configuration and traffic at a test's size: the same models at
    widths [8, 8], 16x16 frames, a handful of rows."""
    _, cfg, tr = bench.resolve(workload, MAN)
    cfg = copy.deepcopy(cfg)
    cfg["img_size"] = 16
    cfg["denoiser"]["img_size"] = 16
    cfg["denoiser"]["inner_model"].update(channels=[8, 8], depths=[1, 1], attn_depths=[0, 0],
                                          cond_channels=16)
    cfg["rew_end_model"].update(img_size=16, channels=[8, 8], depths=[1, 1],
                                attn_depths=[0, 0], cond_channels=8, lstm_dim=16)
    cfg["actor_critic"].update(img_size=16, channels=[8, 8], down=[1, 1], lstm_dim=16)
    tr = dict(tr, batch_size=6, store_steps=3000, trace_steps=1, ref_rows=4)
    if "seq_length" in tr:
        tr["seq_length"] = min(tr["seq_length"], 5)
    if tr["driver"] == "ac_step":
        cfg["world_model_env"].update(num_batches_to_preload=40)
        tr.update(pool_chunk=48,
                  actor_critic_loss=dict(tr["actor_critic_loss"], backup_every=4))
    return cfg, tr


def run_tiny(workload: str, fault=None, trace=False):
    cfg, tr = tiny(workload)
    return bench.run(workload, SEED, 0.2, trace, "cpu", MAN, cfg, fault=fault, traffic=tr)


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_prints_the_contracts_keys(workload):
    out = run_tiny(workload)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0
    _, _, tr = bench.resolve(workload, MAN)
    assert set(out["metrics"]) == {tr["metric"], "setup_s"}
    assert all(c["value"] == 0 for name, c in out["checks"].items()
               if name in ("batch", "state"))


@pytest.mark.parametrize("workload", CELLS)
def test_the_traced_run_reads_each_listed_metric_it_can_on_the_cpu(workload):
    out = run_tiny(workload, trace=True)
    _, _, tr = bench.resolve(workload, MAN)
    listed = {m["name"] for m in MAN["per_layer"]
              if m["moves"] == tr["metric"] and workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) <= listed
    # on the CPU no kernel runs: the launch count and the idle share are still read
    assert {n for n in listed if n.startswith(("launch_calls", "device_idle"))} \
        <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out


FAULTS = {"unchanged": ("change",), "half_batch": ("loss", "grad"),
          "altered": ("batch", "state", "frame", "cond")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_makes_correct_false(workload, fault):
    out = run_tiny(workload, fault=fault)
    over = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert not out["correct"] and set(over) & set(FAULTS[fault]), out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_a_compared_number(workload):
    cfg, tr = tiny(workload)
    wl, _, _ = bench.resolve(workload, MAN)
    driver = bench.load_file(BENCH / "drivers" / f"{tr['driver']}.py", "bench_driver_test")
    env = bench.Env(wl, cfg, tr, SEED, torch.device("cpu"), bench.Parts(lambda: None))
    cell = driver.build(env)
    cell.warm_up()
    cell.release()
    got = cell.readings()
    lim = tr["limits"]
    assert any(got["control"][k] > lim[k] for k in got["control"] if k in lim), got
    assert got["unchanged"]["change"] > lim["change"]


def test_equal_seeds_make_equal_traffic():
    a = make_episodes(2000, (8, 8, 3), 4, SEED, "cpu")
    b = make_episodes(2000, (8, 8, 3), 4, SEED, "cpu")
    c = make_episodes(2000, (8, 8, 3), 4, SEED + 1, "cpu")
    for k in ("obs", "act", "rew", "end", "trunc", "final_obs"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    assert (a.lengths == b.lengths).all() and (a.has_final == b.has_final).all()
    assert not torch.equal(a.obs, c.obs)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh process (the test process may hold anything): whole small runs of
    every cell, untraced and traced (the per-layer readers loaded), then the top-level
    names of every loaded module."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from harness import bench\n"
        "sys.path.insert(0, %r); import test_bench_cells as t\n"
        "[t.run_tiny(w, trace=tr) for w in t.CELLS for tr in (False, True)]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(BENCH), str(ROOT), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "diamond_tpu_torch" in tops
    assert not tops & set(bench.FORBIDDEN), tops & set(bench.FORBIDDEN)


def test_a_reader_that_loads_jax_leaves_the_run_without_a_result(monkeypatch):
    """The look for JAX comes last: after the readers and the reference comparison."""
    import types

    load = bench.load_file

    def load_and_jax(path, name):
        mod = load(path, name)
        if name.startswith("bench_metric_"):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return mod

    monkeypatch.setattr(bench, "load_file", load_and_jax)
    with pytest.raises(SystemExit) as e:
        run_tiny("atari-ac-step-b512", trace=True)
    assert e.value.code != 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_cell_on_the_card_at_a_small_size(cuda):
    cfg, tr = tiny("atari-denoiser-step-b512")
    out = bench.run("atari-denoiser-step-b512", SEED, 0.5, False, "cuda", MAN, cfg,
                    traffic=tr)
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    assert out["checks"]["batch"]["value"] == 0
