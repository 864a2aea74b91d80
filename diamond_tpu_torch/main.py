"""The training CLI (diamond_tpu/main.py):

    python -m diamond_tpu_torch.main env=fake common.seed=1 [key=value ...] [--run-dir DIR]

Each run owns a run dir (``outputs/<date>/<time>`` unless ``--run-dir`` says
otherwise) holding its metrics, checkpoints, datasets and resolved config
(``config/trainer.json``). ``common.resume=True`` resumes the run in ``--run-dir`` (or
the working directory) from that saved config and its last checkpoint; a finished run
(``.run_is_over``) is not run again. The trainer runs on the card: without a CUDA
device the CLI exits non-zero before it starts.

Data parallelism: ``common.devices`` selects the cards ("all" by default). With
``tpu.data_parallel`` (the default), more than one card and every batch size divisible
by their count, the CLI spawns one process per card; each sets its card, joins an NCCL
process group over ``tcp://127.0.0.1:<free port>`` and runs a ``Trainer`` with the
group's ``DataParallel`` (parallel/mesh.py). Otherwise one process trains on the first
selected card, with the JAX trainer's warnings. A failed NCCL initialisation fails the
run; nothing falls back to one process. ``tpu.distributed.coordinator`` (a process group
across hosts) is refused, as the JAX CLI refuses it.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Union


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train DIAMOND (PyTorch + CUDA)")
    parser.add_argument("overrides", nargs="*", help="config overrides, key=value")
    parser.add_argument("--run-dir", type=Path, default=None,
                        help="run directory (default: outputs/<date>/<time>)")
    return parser.parse_args(argv)


DISTRIBUTED_REFUSAL = (
    "tpu.distributed.* is not supported by the training CLI: the Trainer is single-host. "
    "Multi-host data parallelism is available at the train-step layer — initialize with "
    "parallel.multihost.initialize and feed this process's rows via "
    "global_batch_from_local / global_replicated_from_full (see parallel/multihost.py and "
    "tests/test_torch_multihost.py).")


def plan_devices(cfg, count: Optional[int] = None) -> List[int]:
    """The card indices the run trains on: every card ``common.devices`` selects where
    ``tpu.data_parallel`` is on and every batch size divides over them, else the first
    (with the JAX trainer's messages). ``count``: the cards visible (the CUDA count by
    default)."""
    import torch

    from .parallel import select_devices

    count = torch.cuda.device_count() if count is None else count
    devices = select_devices(cfg.common.devices, count)
    n = len(devices)
    if cfg.tpu.data_parallel and n > 1:
        names = ["denoiser", "rew_end_model", "actor_critic"] + \
            (["upsampler"] if cfg.agent.upsampler is not None else [])
        batch_sizes = [getattr(cfg, m).training.batch_size for m in names]
        if all(b % n == 0 for b in batch_sizes):
            print(f"data-parallel over {n} of {count} devices")
            return devices
        print(f"tpu.data_parallel requested but batch sizes {batch_sizes} do not divide {n} "
              "devices — running replicated on one device")
    if n > 1:
        print(f"WARNING: common.devices selected {n} devices but only {devices[0]} will be "
              f"used (unused: {devices[1:]}); set tpu.data_parallel=True with batch sizes "
              f"divisible by {n} to use all of them")
    if devices[0] != 0:
        print(f"running on selected device {devices[0]}")
    return devices[:1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, devices: List[str], init_method: str, backend: str, cfg,
            root_dir: Path, run_dir: Path) -> None:
    """One rank of a data-parallel run: its device set, the process group joined, its
    Trainer run; the group is destroyed however the run ends."""
    import torch
    import torch.distributed as dist

    from .parallel import DataParallel
    from .trainer import Trainer

    device = torch.device(devices[rank])
    if device.type == "cuda":
        # NCCL (and broadcast_object_list under it) stages through the current device
        torch.cuda.set_device(device)
    else:  # ranks on the CPU share the host's cores (or OMP_NUM_THREADS)
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    dist.init_process_group(backend, init_method=init_method, world_size=len(devices),
                            rank=rank)
    try:
        Trainer(cfg, root_dir, run_dir=run_dir, device=device,
                dp=DataParallel.from_process_group(device)).run()
    finally:
        dist.destroy_process_group()


def launch(cfg, root_dir: Path, run_dir: Path,
           devices: Sequence[Union[str, "torch.device"]], backend: str = "nccl") -> None:
    """Train on ``devices``: one device in this process, no process group; more than one
    in one spawned process each, over a ``backend`` process group (NCCL on the cards;
    the CPU tests pass gloo and CPU devices). A rank's failure is raised here."""
    import torch.multiprocessing as mp

    from .trainer import Trainer

    if len(devices) == 1:
        Trainer(cfg, root_dir, run_dir=run_dir, device=devices[0]).run()
        return
    mp.spawn(_worker, nprocs=len(devices), join=True,
             args=([str(d) for d in devices], f"tcp://127.0.0.1:{_free_port()}", backend,
                   cfg, Path(root_dir), Path(run_dir)))


def main(argv=None) -> int:
    import torch

    from .config import load_config, read_config
    from .utils import skip_if_run_is_over

    args = parse_args(argv)
    # resume reads the run's saved, resolved config: the original overrides need not
    # be passed again
    wants_resume = any(o.replace(" ", "") in ("common.resume=True", "common.resume=true")
                       for o in args.overrides)
    base = None
    if wants_resume:
        saved = (args.run_dir if args.run_dir is not None else Path.cwd()) / "config" \
            / "trainer.json"
        if saved.is_file():
            base = read_config(saved)
    cfg = load_config(args.overrides, base=base)
    if cfg.tpu.distributed.coordinator:
        raise SystemExit(DISTRIBUTED_REFUSAL)
    if not torch.cuda.is_available():
        print("diamond_tpu_torch.main: no CUDA device; the trainer runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    devices = [torch.device("cuda", i) for i in plan_devices(cfg)]

    root_dir = Path(__file__).resolve().parents[1]
    if args.run_dir is not None:
        run_dir = args.run_dir
    elif cfg.common.resume:
        run_dir = Path.cwd()
    else:
        now = datetime.datetime.now()
        run_dir = Path("outputs") / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")
    run_dir.mkdir(parents=True, exist_ok=True)
    os.chdir(run_dir)

    @skip_if_run_is_over
    def run() -> None:
        launch(cfg, root_dir, Path.cwd(), devices)

    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
