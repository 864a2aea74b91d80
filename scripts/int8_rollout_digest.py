#!/usr/bin/env python3
"""Digests of the int8 imagination rollouts of the full-size Breakout agent, as
chip_smoke.py builds it (seeded random weights, the 1,024-segment synthetic pool, int8
sites calibrated on the live buffers): its actions, rewards and ends, and the frames the
state holds after each rollout, over a warm-up and two rollouts at B = 32, T = 15, from
seed 0.

Run it against two checkouts of the repo in one call on the card (``--root`` names the
checkout whose package and chip_smoke.py it imports; each builds its own kernels): equal
digests mean the two trees' rollouts agree bit for bit. It also counts K6's launches.

    python3 scripts/int8_rollout_digest.py [--root DIR]   # on a CUDA GPU

Prints one line ``[digest] {...}`` (JSON).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def digest(*tensors) -> str:
    """A digest of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_rollout_digest: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import AgentConfig, RuntimeConfig, WorldModelEnvConfig
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine,
                                                        encode_pool_feats, make_ic_preparer)
    from diamond_tpu_torch.models import Agent

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    rt, cfg, wm_cfg = RuntimeConfig(), AgentConfig(), WorldModelEnvConfig()
    gen = torch.Generator().manual_seed(cs.SEED)
    agent = Agent(cfg, getattr(torch, rt.compute_dtype), generator=gen)
    for net in agent.nets.values():
        cs.perturb_zero_leaves(net, gen)
    engine = ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic, wm_cfg)
    rng = np.random.default_rng(cs.SEED)
    n_cond = cfg.denoiser.inner_model.num_steps_conditioning
    size, ch = cfg.rew_end_model.img_size, cfg.denoiser.inner_model.img_channels
    obs_u8 = torch.from_numpy(rng.integers(0, 256, (cs.POOL_SIZE, n_cond, size, size, ch),
                                           dtype=np.uint8)).to(dev)
    act = torch.from_numpy(rng.integers(0, cfg.num_actions, (cs.POOL_SIZE, n_cond))
                           .astype(np.int32)).to(dev)
    hx, cx = make_ic_preparer(agent.rew_end_model)(obs_u8, act)
    feats = torch.cat([encode_pool_feats(agent.actor_critic, obs_u8[i:i + 512])
                       for i in range(0, cs.POOL_SIZE, 512)]) if rt.pool_policy_feats else None
    pool = ICPool(obs=obs_u8, act=act, hx=hx, cx=cx,
                  ptr=torch.zeros((), dtype=torch.long, device=dev), feats=feats)
    st, pool = engine.initial_state(pool, cs.BATCH)
    rgen = torch.Generator(device=dev).manual_seed(cs.SEED)
    obs_f = obs_to_float(st.obs_buffer)
    engine.sampler.calibrate(obs_f, st.act_buffer, rt.int8_sites, generator=rgen)
    agent.rew_end_model.calibrate(obs_f[:, -2:-1], st.act_buffer[:, -2:-1], obs_f[:, -1:],
                                  rt.int8_sites)
    ops.matmul_int8.launches = 0
    ops.matmul_int8.shapes.clear()
    parts = []
    for _ in range(1 + cs.TIMED_ROLLOUTS):
        traj, st, pool = engine.rollout(st, pool, cs.HORIZON, generator=rgen)
        parts.append((traj["act"], traj["rew"], traj["end"], st.obs_buffer.clone()))
    torch.cuda.synchronize()
    out = dict(root=str(args.root), card=cs.nvidia_smi(),
               actions=digest(*(p[0] for p in parts)), rewards=digest(*(p[1] for p in parts)),
               ends=digest(*(p[2] for p in parts)), frames=digest(*(p[3] for p in parts)),
               k6_launches=ops.matmul_int8.launches)
    print("[digest] " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
