"""The play app (diamond_tpu/play.py): play inside the world model or the real envs, by
hand or under the policy, record what is played, or browse recorded datasets.

    python -m diamond_tpu_torch.play [--run-dir DIR] [-r] [-d] [--int8] [-p --game GAME]

Modes:
  * default: human (or policy, toggled with 'm') control of [world-model, real-test,
    real-train] envs, cycled with the bracket keys;
  * ``--dataset-mode`` (``-d``): a read-only browser over the run's ``dataset/*``;
  * ``--record`` (``-r``): played episodes are written into ``dataset/rec_*``;
  * ``--pretrained`` (``-p``): DIAMOND's published Atari-100k agent and its config from
    the HF Hub (eloialonso/diamond), converted by ``interop/reference_ckpt.py``;
  * ``--int8``: the world model (the dynamics denoiser, the rew/end model and a
    two-stage agent's upsampler) calibrated for the static int8 path at start-up.

The run dir is a training run's (``python -m diamond_tpu_torch.main``): its resolved
config ``config/trainer.json`` and its newest agent snapshot
``checkpoints/agent_versions/*.npz`` (the JAX package's snapshots load too, given the
run's config as ``trainer.json``). The world model's ICs come from ``-n`` real steps
collected at start-up with the policy. The models compute in the config's
``tpu.compute_dtype``.

``build_app`` builds the app on a device and returns it without pygame (the card's
machine has none: play is driven headless there, as ``chip_smoke.py`` does); ``main``
runs it in the pygame window. Play runs on the card: without CUDA ``main`` exits
non-zero before it builds anything, but ``--dataset-mode`` touches no device.
"""

from __future__ import annotations

import argparse
import copy
import sys
from dataclasses import asdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

HUB_REPO = "eloialonso/diamond"
SEED_DATASET = "play_seed"
IC_BATCH = 8             # the IC sampler's batch, and the ICs the int8 calibration sees
SEED = 0
CALIBRATION_SEED = 11


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Play DIAMOND (PyTorch + CUDA)")
    p.add_argument("--run-dir", type=Path, default=Path("."))
    p.add_argument("-p", "--pretrained", action="store_true",
                   help="download a pretrained DIAMOND agent from the HF Hub")
    p.add_argument("-d", "--dataset-mode", action="store_true")
    p.add_argument("-r", "--record", action="store_true")
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--size", type=int, default=640, help="render size (pixels)")
    p.add_argument("-n", "--num-steps-initial-collect", type=int, default=1000)
    p.add_argument("--game", type=str, default=None,
                   help="with --pretrained: Atari-100k game name, e.g. Breakout")
    p.add_argument("--horizon", type=int, default=50,
                   help="world-model horizon during play")
    p.add_argument("--int8", action="store_true",
                   help="calibrate the world model for the static int8 path at start-up "
                        "(two-stage models calibrate every stage)")
    p.add_argument("--smoke", type=int, default=0,
                   help="headless smoke: run N frames and exit (SDL_VIDEODRIVER=dummy)")
    return p.parse_args(argv)


def download_pretrained(game: str) -> Path:
    """The published agent of ``game`` from the HF Hub."""
    from huggingface_hub import hf_hub_download

    return Path(hf_hub_download(repo_id=HUB_REPO, filename=f"atari_100k/models/{game}.pt"))


def _yaml_overrides(prefix: str, tree: Dict[str, Any], known: Any) -> List[str]:
    """A published config group as ``key=value`` overrides of the port's config:
    Hydra's ``_target_`` keys dropped, ``${...}`` interpolations left to be derived, keys
    the port's config does not have ignored (the JAX package reads only its fields)."""
    from .config import _get

    out = []
    for k, v in tree.items():
        key = f"{prefix}.{k}"
        if k == "_target_" or (isinstance(v, str) and "${" in v):
            continue
        try:
            _get(known, key)
        except (AttributeError, IndexError, ValueError, TypeError):
            continue
        if isinstance(v, dict):
            out += _yaml_overrides(key, v, known)
        else:
            out.append(f"{key}={v!r}")
    return out


def compose_pretrained_config(game: str):
    """With ``--pretrained``, the published run's agent and env config groups (from the
    hub) replace the local ones, and the env id is pinned to ``game``: the resolved
    config of ``env=atari``, their values and ``env.train.id``."""
    import yaml
    from huggingface_hub import hf_hub_download

    from .config import Config, load_config

    overrides = ["env=atari"]
    known = Config()
    for group, filename in (("agent", "atari_100k/config/agent/default.yaml"),
                            ("env", "atari_100k/config/env/atari.yaml")):
        tree = yaml.safe_load(Path(hf_hub_download(HUB_REPO, filename)).read_text()) or {}
        overrides += _yaml_overrides(group, tree, known)
    return load_config(overrides + [f"env.train.id={game}NoFrameskip-v4"])


def run_config(run_dir: Path):
    """The run's resolved config (``config/trainer.json``), else the defaults. A run dir
    whose config is only a JAX ``trainer.yaml`` is refused: the port reads no YAML, and
    defaults that differ from the checkpoint's widths would mislead."""
    from .config import load_config, read_config

    cfg_dir = Path(run_dir) / "config"
    if (cfg_dir / "trainer.json").is_file():
        return load_config(base=read_config(cfg_dir / "trainer.json"))
    if (cfg_dir / "trainer.yaml").is_file():
        raise ValueError(f"{cfg_dir / 'trainer.yaml'} is a JAX run's config: the port reads "
                         "only config/trainer.json (write the run's resolved config there)")
    return load_config()


class LowResPolicy:
    """A two-stage agent's actor-critic as the seed collector (coroutines/EnvLoop) drives
    it on the real env's full-resolution frames: through their area downsample snapped to
    the uint8 grid, the frames it sees in the world model and in PlayEnv."""

    def __init__(self, actor_critic: Any, factor: int) -> None:
        self.ac, self.factor = actor_critic, factor
        self.cfg, self.net = actor_critic.cfg, actor_critic.net

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        from .models.denoiser import downsample_avg, quantize_to_uint8_grid

        return self.ac.encode(quantize_to_uint8_grid(downsample_avg(obs, self.factor)))

    def head(self, feat: torch.Tensor, carry):
        return self.ac.head(feat, carry)


def calibrate_int8(engine: Any, agent: Any, provider: Any, sites: Any,
                   generator: Optional[torch.Generator] = None) -> Dict[str, dict]:
    """The play-time world model on the static int8 path: calibrate the dynamics
    denoiser (one sampling pass), the rew/end model (one step on the last pair of
    frames) and a two-stage agent's upsampler (one pass on the last frames, upsampled)
    on IC_BATCH ICs from ``provider``, area-downsampled for the low-resolution stages;
    ``sites`` as ``tpu.int8_sites``. Installs the "quant" collections in the models and
    returns them by model name."""
    from .data.episode import obs_to_float
    from .envs.wm_env_stateful import to_low_res
    from .models.denoiser import upsample_frame
    from .models.diffusion_sampler import DiffusionSampler

    dev = next(agent.denoiser.inner_model.parameters()).device
    f = agent.cfg.downsample_factor
    obs_u8, act, _, _ = provider(IC_BATCH)
    obs_f = obs_to_float(to_low_res(torch.from_numpy(np.asarray(obs_u8)).to(dev), f))
    act = torch.from_numpy(np.asarray(act, np.int32)).to(dev)
    colls = {"denoiser": engine.sampler.calibrate(obs_f, act, sites, generator=generator),
             "rew_end_model": agent.rew_end_model.calibrate(obs_f[:, -2:-1], act[:, -2:-1],
                                                            obs_f[:, -1:], sites)}
    if agent.upsampler is not None:
        up = DiffusionSampler(agent.upsampler, engine.sampler.cfg)
        colls["upsampler"] = up.calibrate(upsample_frame(obs_f[:, -1], f)[:, None], None,
                                          sites, generator=generator)
    return colls


def build_app(args: argparse.Namespace, device: Union[str, torch.device] = "cuda"):
    """The app of ``args`` on ``device``: the ``PlayEnv``, or in ``--dataset-mode`` the
    ``DatasetEnv`` (no device). SEED seeds the seed collection, the IC sampler and the
    world model's and the policy's draws."""
    from .data.dataset import Dataset

    run_dir = Path(args.run_dir)
    cfg = run_config(run_dir)

    if args.dataset_mode:
        from .game.dataset_env import DatasetEnv

        datasets = []
        for p in sorted(q for q in (run_dir / "dataset").iterdir() if q.is_dir()):
            d = Dataset(p, p.name)
            d.load_from_default_path()
            datasets.append(d)
        return DatasetEnv(datasets, keymap_name=cfg.env.keymap)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: play runs on an NVIDIA GPU (the tests pass "
                           "device='cpu')")
    from .coroutines import Collector, NumToCollect
    from .data.batch_sampler import BatchSampler
    from .envs.env import make_env
    from .envs.wm_env_stateful import WorldModelEnv, make_dataset_ic_provider
    from .envs.world_model_env import ImaginationEngine
    from .game.play_env import NamedEnv, PlayEnv
    from .models.agent import Agent
    from .utils import get_path_agent_ckpt

    game = None
    if args.pretrained:  # the published run's agent and env configs, before anything is built
        game = args.game or cfg.env.train.id.replace("NoFrameskip-v4", "")
        cfg = compose_pretrained_config(game)

    train_env = make_env(num_envs=1, **asdict(cfg.env.train))
    test_env = make_env(num_envs=1, **asdict(cfg.env.test))
    agent_cfg = copy.deepcopy(cfg.agent)
    agent_cfg.num_actions = int(test_env.num_actions)
    agent_cfg.__post_init__()
    compute_dtype = torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16" else torch.float32
    agent = Agent(agent_cfg, compute_dtype, device=device)

    if args.pretrained:
        from .interop.reference_ckpt import load_reference_checkpoint

        variables = load_reference_checkpoint(download_pretrained(game),
                                              img_size=cfg.env.train.size,
                                              ac_down=list(cfg.agent.actor_critic.down))
        agent.load_state_dict(variables, list(variables))
        print(f"loaded pretrained {game} from the HF Hub")
    else:
        ckpt = get_path_agent_ckpt(run_dir / "checkpoints", epoch=-1)
        agent.load(ckpt)
        print(f"loaded {ckpt}")

    # the world model's ICs: real experience, collected with the policy
    factor = agent.cfg.downsample_factor
    policy = LowResPolicy(agent.actor_critic, factor) if factor > 1 else agent.actor_critic
    seed_ds = Dataset(run_dir / "dataset" / SEED_DATASET, SEED_DATASET, cache_in_ram=True,
                      save_on_disk=False)
    collector = Collector(test_env, policy, seed_ds, seed=SEED, verbose=False)
    print(f"collecting {args.num_steps_initial_collect} real steps to seed the world model…")
    collector.send(NumToCollect(steps=args.num_steps_initial_collect))

    wm_cfg = copy.deepcopy(cfg.world_model_env)  # the play env's horizon keys change it
    wm_cfg.horizon = args.horizon
    engine = ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic, wm_cfg)
    n_cond = cfg.agent.denoiser.inner_model.num_steps_conditioning
    ic_sampler = BatchSampler(seed_ds, 0, 1, batch_size=IC_BATCH, seq_length=n_cond, seed=SEED)
    provider = make_dataset_ic_provider(seed_ds, ic_sampler, agent.rew_end_model,
                                        downsample_factor=factor)

    if args.int8:
        print("calibrating int8 world-model inference…")
        gen = torch.Generator(device=device).manual_seed(CALIBRATION_SEED)
        calibrate_int8(engine, agent, provider, cfg.tpu.int8_sites, gen)
    wm_env = WorldModelEnv(engine, provider, num_envs=1, seed=SEED,
                           return_denoising_trajectory=args.record, upsampler=agent.upsampler)

    envs = [NamedEnv("world_model", wm_env), NamedEnv("test", test_env),
            NamedEnv("train", train_env)]
    return PlayEnv(agent, envs, cfg.env.keymap, args.fps, record_mode=args.record,
                   record_dir=run_dir / "dataset", seed=SEED)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.dataset_mode and not torch.cuda.is_available():
        print("diamond_tpu_torch.play: no CUDA device; play runs on an NVIDIA GPU "
              "(--dataset-mode needs none)", file=sys.stderr)
        return 1
    from .game.game import Game

    app = build_app(args)
    Game(app, size=(args.size, args.size), fps=args.fps).run(max_steps=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
