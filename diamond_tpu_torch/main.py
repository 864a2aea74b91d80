"""The training CLI (diamond_tpu/main.py):

    python -m diamond_tpu_torch.main env=fake common.seed=1 [key=value ...] [--run-dir DIR]

Each run owns a run dir (``outputs/<date>/<time>`` unless ``--run-dir`` says
otherwise) holding its metrics, checkpoints, datasets and resolved config
(``config/trainer.json``). ``common.resume=True`` resumes the run in ``--run-dir`` (or
the working directory) from that saved config and its last checkpoint; a finished run
(``.run_is_over``) is not run again. The trainer runs on the card: without a CUDA
device the CLI exits non-zero before it starts.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from pathlib import Path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train DIAMOND (PyTorch + CUDA)")
    parser.add_argument("overrides", nargs="*", help="config overrides, key=value")
    parser.add_argument("--run-dir", type=Path, default=None,
                        help="run directory (default: outputs/<date>/<time>)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from .config import load_config, read_config
    from .utils import skip_if_run_is_over

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("diamond_tpu_torch.main: no CUDA device; the trainer runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1

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
        from .trainer import Trainer

        Trainer(cfg, root_dir, run_dir=Path.cwd()).run()

    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
