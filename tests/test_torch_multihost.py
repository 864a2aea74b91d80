"""The multi-process dryrun of diamond_tpu_torch (parallel/multihost.py), the counterpart
of tests/test_multihost.py: the same denoiser step and actor-critic step in imagination,
run by two processes over a gloo process group on the CPU, reproduce the single-process
run (one rank), and the two processes agree with each other exactly. The training CLI
refuses a process group across hosts, as the JAX CLI does.

Tolerances, each with its reason: the two processes' numbers equal (one reduced gradient,
one global loss); two processes against one: tests/test_multihost.py's (loss 1e-5,
gradient norm 1e-4, actor-critic loss 1e-4 and its gradient norm 1e-3 relative; the
sums are taken in another order), the pool pointer exactly.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from diamond_tpu_torch.main import main as cli_main
from diamond_tpu_torch.parallel import global_batch_from_local

from torch_port_util import REPO


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(process_id, num_processes, port, outdir):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "diamond_tpu_torch.parallel.multihost", str(process_id),
         str(num_processes), str(port), str(outdir)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two processes and one process, all started together."""
    two, one = tmp_path_factory.mktemp("two"), tmp_path_factory.mktemp("one")
    port2, port1 = _free_port(), _free_port()
    procs = [(two, _spawn(i, 2, port2, two)) for i in range(2)]
    procs.append((one, _spawn(0, 1, port1, one)))
    outs = [p.communicate(timeout=300) for _, p in procs]
    for (_, p), (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so[-2000:]}\n{se[-3000:]}"
    read = lambda d, i: json.loads((d / f"dryrun_p{i}.json").read_text())  # noqa: E731
    return [read(two, 0), read(two, 1)], [read(one, 0)]


def test_two_processes_match_one(groups):
    two, one = groups
    assert all(r["num_processes"] == 2 and r["step"] == 2 for r in two)
    assert one[0]["num_processes"] == 1 and one[0]["step"] == 2
    # both processes hold the same global numbers
    for k in ("loss", "grad_norm", "ac_loss", "ac_grad_norm", "ac_pool_ptr"):
        assert two[0][k] == two[1][k], k
    # the pool pointer: initial_state's batch and the deaths of both halves, one global
    # scalar
    assert two[0]["ac_pool_ptr"] == one[0]["ac_pool_ptr"] >= 8
    np.testing.assert_allclose(two[0]["loss"], one[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["grad_norm"], one[0]["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["ac_loss"], one[0]["ac_loss"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["ac_grad_norm"], one[0]["ac_grad_norm"], rtol=1e-3)


def test_global_batch_from_local_checks_the_rows():
    """The local rows must share one leading size; one process: the global mask is the
    rows' own."""
    import torch

    from diamond_tpu_torch.data.segment import DeviceBatch
    from diamond_tpu_torch.parallel import DataParallel

    def batch(b_obs, b):
        return DeviceBatch(obs=torch.zeros((b_obs, 2, 4, 4, 3), dtype=torch.uint8),
                           act=torch.zeros((b, 2), dtype=torch.int32), rew=torch.zeros((b, 2)),
                           end=torch.zeros((b, 2), dtype=torch.int32),
                           trunc=torch.zeros((b, 2), dtype=torch.int32),
                           mask_padding=torch.tensor([[True, False]] * b),
                           final_obs=torch.zeros((b, 4, 4, 3), dtype=torch.uint8),
                           has_final_obs=torch.zeros((b,), dtype=torch.bool))

    got = global_batch_from_local(batch(3, 3), DataParallel())
    assert torch.equal(got.mask_global, got.mask_padding)
    with pytest.raises(ValueError, match="rows"):
        global_batch_from_local(batch(3, 2), DataParallel())


def test_cli_refuses_a_process_group_across_hosts(tmp_path, capsys):
    """tpu.distributed.coordinator: the CLI exits non-zero with the JAX CLI's pointer to
    the train-step layer, before it looks for a card or makes a run dir."""
    with pytest.raises(SystemExit, match="parallel.multihost.initialize") as e:
        cli_main(["env=fake", "tpu.distributed.coordinator=10.0.0.1:1234",
                  "tpu.distributed.num_processes=2", "--run-dir", str(tmp_path / "run")])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "run").exists()
