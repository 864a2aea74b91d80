#!/usr/bin/env python3
"""Chip smoke test of diamond_tpu_torch: the imagination rollout of the full-size Breakout
agent on one NVIDIA GPU, through the port's hand-written CUDA kernels.

    python3 chip_smoke.py              # from the repo root, on a machine with a CUDA GPU

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero and prints no
result line):
  1. build the kernels from kernels/csrc (nvcc, sm_90a) and load them;
  2. the card's name and power limit (nvidia-smi);
  3. the full-size agent (configs/agent/default.yaml widths, 4 Breakout actions) with
     random weights from a seed, bf16 compute; a pool of 1024 synthetic uint8 segments
     burned in through make_ic_preparer, with precomputed policy features
     (tpu.pool_policy_feats); initial_state, one warm-up and two timed rollouts at
     B=32, T=15, 3 Euler steps -> env_frames/s (bench.py's imagination_fps_batch32_n3);
     then one rollout on the other pool branch (features encoded per reset), and one
     under torch.profiler: the device's busy and idle share and the time by kernel;
  4. the launch counts of the three kernels over the timed main path, each > 0;
  5. each kernel against its plain PyTorch version at every shape and dtype the rollout
     sent it, and in f32 (TF32 off), with times;
  6. the trajectory's sanity, and a small full-width rollout in f32 on the card against
     the same rollout through the plain versions on the CPU.
The last line is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
BATCH, HORIZON = 32, 15
POOL_SIZE = 1024
TIMED_ROLLOUTS = 2
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "adagn_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                   "diamond_tpu/ops/fused_norms.py:97"),
    "groupnorm_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                       "diamond_tpu/ops/fused_norms.py:65"),
    "conv3x3": ("diamond_tpu_torch/kernels/csrc/conv3x3.cu", "diamond_tpu/ops/conv3x3.py:33"),
}
# max |kernel - plain| allowed, as a share of max(1, max |plain|): f32 sums in another
# order (TF32 off on both sides); bf16 outputs are rounded once on both sides and may
# differ by one bf16 ulp (1/128 relative), so 2 ulps are allowed.
TOL = {"float32": {"adagn_silu": 1e-4, "groupnorm_silu": 1e-4, "conv3x3": 1e-3},
       "bfloat16": {"adagn_silu": 1 / 64, "groupnorm_silu": 1 / 64, "conv3x3": 1 / 64}}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA graph and
    replayed, so that host launch overhead (which bounds small calls timed eagerly) is
    left out. Inputs are reused, so they sit in L2 when they fit, as in the rollout,
    where each op reads what the previous one just wrote."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def cudnn_bf16_conv(x, w, b, stride):
    """The library's bf16 conv on the same NHWC data (cuDNN, channels-last), for scale."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    None if b is None else b.to(x.dtype), stride=stride, padding=1)


def perturb_zero_leaves(net, gen) -> None:
    """Give every all-zero weight (zero-init output convs, attention out_proj, actor and
    critic heads) small random values, so that every layer shapes the rollout."""
    import torch

    with torch.no_grad():
        for p in net.parameters():
            if p.dim() > 1 and not p.any():
                fan_in = p[..., 0].numel()
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / fan_in ** 0.5)


def make_inputs(name, sig, dtype, gen):
    """Random inputs of one recorded call signature, on the card, in ``dtype``."""
    import torch

    dev = "cuda"
    if name == "conv3x3":
        shape, cout, stride, has_bias, _ = sig
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = ((torch.rand((3, 3, shape[-1], cout), generator=gen, device=dev) * 2 - 1)
             / (9 * shape[-1]) ** 0.5).to(dtype)
        b = 0.1 * torch.randn(cout, generator=gen, device=dev) if has_bias else None
        return (x, w, b, stride)
    shape, _, silu = sig
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    g = max(1, c // 32)
    if name == "adagn_silu":
        return (x, 0.5 * torch.randn((shape[0], 2 * c), generator=gen, device=dev), g, silu)
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
    return (x, scale, 0.1 * torch.randn(c, generator=gen, device=dev), g, silu)


def compare_kernels(shapes, launches, num_rollouts):
    """Each kernel against its plain version at the recorded signatures (bf16 as the
    rollout ran them, and the same shapes in f32). Returns the JSON rows."""
    import torch
    from diamond_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, details = [], []
    for name, (source, replaces) in KERNELS.items():
        kernel, plain = getattr(ops, name), getattr(ops, name + "_plain")
        err = {"float32": 0.0, "bfloat16": 0.0}
        ms = plain_ms = 0.0
        for sig, count in sorted(shapes[name].items(), key=lambda kv: str(kv[0])):
            for dt_name in ("bfloat16", "float32"):
                args = make_inputs(name, sig, getattr(torch, dt_name), gen)
                y, ref = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                scale = max(1.0, ref.float().abs().max().item())
                e = (y.float() - ref.float()).abs().max().item()
                check(bool(torch.isfinite(y.float()).all()), f"{name} {sig} {dt_name}: non-finite")
                check(e <= TOL[dt_name][name] * scale,
                      f"{name} {sig} {dt_name}: max abs err {e} > {TOL[dt_name][name]} * {scale}")
                err[dt_name] = max(err[dt_name], e)
                t_k = cuda_time_ms(lambda: kernel(*args))
                t_p = cuda_time_ms(lambda: plain(*args))
                if dt_name == "bfloat16":  # the rollout's dtype: weight by its call count
                    ms += count * t_k / num_rollouts
                    plain_ms += count * t_p / num_rollouts
                extra = {}
                if name == "conv3x3" and dt_name == "bfloat16":
                    extra["cudnn_bf16_ms"] = cuda_time_ms(lambda: cudnn_bf16_conv(*args))
                details.append(dict(kernel=name, signature=str(sig), dtype=dt_name,
                                    calls_per_rollout=count / num_rollouts, max_abs_err=e,
                                    ref_max=scale, ms=t_k, plain_ms=t_p, **extra))
                log(f"[compare] {name} {sig} {dt_name}: err {e:.3g} (tol "
                    f"{TOL[dt_name][name] * scale:.3g}) kernel {t_k:.4f} ms plain {t_p:.4f} ms"
                    + "".join(f" {k} {v:.4f}" for k, v in extra.items()))
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=err["bfloat16"],
                         max_abs_err_f32=err["float32"], ms=ms, plain_ms=plain_ms,
                         shapes=len(shapes[name])))
    return rows, details


def sanity(traj, st, pool, ptr_before, num_actions) -> None:
    import torch

    check(st.obs_buffer.dtype == torch.uint8, "frames are not uint8")
    check(set(traj["rew"].unique().tolist()) <= {-1.0, 0.0, 1.0}, "rewards outside {-1,0,1}")
    check(set(traj["end"].unique().tolist()) <= {0, 1}, "ends outside {0,1}")
    check(int(traj["act"].min()) >= 0 and int(traj["act"].max()) < num_actions, "bad actions")
    for k in ("logits_act", "val", "val_final", "val_bootstrap"):
        check(bool(torch.isfinite(traj[k]).all()), f"non-finite {k}")
    for k in ("re_hx", "re_cx", "ac_hx", "ac_cx"):
        check(bool(torch.isfinite(getattr(st, k)).all()), f"non-finite state {k}")
    check(int(pool.ptr) > ptr_before, "the pool pointer did not move")


def reference_check(agent, st, pool, wm_cfg):
    """A B=2, T=2 full-width rollout in f32 on the card (kernels, TF32 off) against the
    same rollout on the CPU (plain versions), same weights and draws, pool features
    encoded per reset. Actions, rewards and ends must agree exactly, logits and values to
    1e-3, frames to one grid level in at most 1% of the values."""
    import torch
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImagState, ImaginationEngine,
                                                        draw_rollout_noise)
    from diamond_tpu_torch.models import Agent

    b, t = 2, 2
    outs = []
    draws = draw_rollout_noise(t, b, tuple(st.obs_buffer.shape[2:]), agent.cfg.num_actions,
                               torch.Generator().manual_seed(SEED + 2), torch.device("cpu"))
    for dev in ("cuda", "cpu"):
        a = Agent(agent.cfg, torch.float32, device=dev)
        for name, net in a.nets.items():
            net.load_state_dict(agent.nets[name].state_dict())
        eng = ImaginationEngine(a.denoiser, a.rew_end_model, a.actor_critic, wm_cfg)
        s = ImagState(**{k: getattr(st, k)[:b].to(dev) for k in st.__dataclass_fields__})
        p = ICPool(obs=pool.obs[:8].to(dev), act=pool.act[:8].to(dev), hx=pool.hx[:8].to(dev),
                   cx=pool.cx[:8].to(dev), ptr=torch.zeros((), dtype=torch.long, device=dev))
        traj, s, p = eng.rollout(s, p, t, draws=type(draws)(*(d.to(dev) for d in draws)))
        if dev == "cuda":
            torch.cuda.synchronize()
        outs.append(({k: v.cpu() for k, v in traj.items()}, s.obs_buffer.cpu()))
    (tg, og), (tc, oc) = outs
    for k in ("act", "rew", "end", "trunc"):
        check(torch.equal(tg[k], tc[k]), f"reference check: {k} differs card vs CPU")
    err = max((tg[k] - tc[k]).abs().max().item() for k in ("logits_act", "val", "val_bootstrap"))
    check(err <= 1e-3, f"reference check: logits/values differ by {err}")
    d = (og.long() - oc.long()).abs()
    share = (d > 0).float().mean().item()
    check(int(d.max()) <= 1 and share <= 0.01, f"reference check: frames differ {d.max()} {share}")
    log(f"[reference] B={b} T={t} f32 card vs CPU plain: actions/rewards/ends equal, "
        f"max logit/value diff {err:.3g}, frames off by one level in {share:.4%} of values")


def profile_rollout(engine, st, pool, gen) -> None:
    """One rollout under torch.profiler: device busy time (the sum of its kernels' times;
    one stream, so they do not overlap) against the wall time, and the kernels by time.
    The profiler slows the host, so the idle share it shows is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.rollout(st, pool, HORIZON, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] one rollout: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {launches} cudaLaunchKernel calls")
    for e in kernels[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x {e.key[:90]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from diamond_tpu_torch import kernels, ops
    from diamond_tpu_torch.config import AgentConfig, RuntimeConfig, WorldModelEnvConfig
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine,
                                                        encode_pool_feats, make_ic_preparer)
    from diamond_tpu_torch.models import Agent

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    how = "found built" if kernels.library_path().exists() else "built"
    lib_path = kernels.build()
    kernels.lib()
    log(f"[build] {how} {lib_path} in {time.perf_counter() - t0:.1f} s")
    smi = nvidia_smi()
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    rt = RuntimeConfig()
    cfg = AgentConfig()
    wm_cfg = WorldModelEnvConfig()
    dtype = getattr(torch, rt.compute_dtype)
    gen = torch.Generator().manual_seed(SEED)
    agent = Agent(cfg, dtype, generator=gen)
    for net in agent.nets.values():
        perturb_zero_leaves(net, gen)
        net.to(dev)
    engine = ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic, wm_cfg)

    rng = np.random.default_rng(SEED)
    n_cond = cfg.denoiser.inner_model.num_steps_conditioning
    size, ch = cfg.rew_end_model.img_size, cfg.denoiser.inner_model.img_channels
    obs_u8 = torch.from_numpy(rng.integers(0, 256, (POOL_SIZE, n_cond, size, size, ch),
                                           dtype=np.uint8)).to(dev)
    act = torch.from_numpy(rng.integers(0, cfg.num_actions, (POOL_SIZE, n_cond))
                           .astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    hx, cx = make_ic_preparer(agent.rew_end_model)(obs_u8, act)
    feats = None
    if rt.pool_policy_feats:
        feats = torch.cat([encode_pool_feats(agent.actor_critic, obs_u8[i:i + 512])
                           for i in range(0, POOL_SIZE, 512)])
    torch.cuda.synchronize()
    log(f"[pool] {POOL_SIZE} segments burned in (and policy features) in "
        f"{time.perf_counter() - t0:.2f} s")
    pool = ICPool(obs=obs_u8, act=act, hx=hx, cx=cx,
                  ptr=torch.zeros((), dtype=torch.long, device=dev), feats=feats)
    st, pool = engine.initial_state(pool, BATCH)
    ptr_before = int(pool.ptr)

    # the main path: warm-up + timed rollouts, counted
    for name in KERNELS:
        getattr(ops, name).launches = 0
        getattr(ops, name).shapes.clear()
    rgen = torch.Generator(device=dev).manual_seed(SEED)
    traj, st, pool = engine.rollout(st, pool, HORIZON, generator=rgen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        traj, st, pool = engine.rollout(st, pool, HORIZON, generator=rgen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    fps = BATCH * HORIZON * TIMED_ROLLOUTS / secs
    log(f"[rollout] imagination_fps_batch32_n3 = {fps:.1f} env_frames/s "
        f"({secs / TIMED_ROLLOUTS * 1e3:.1f} ms per B={BATCH} T={HORIZON} rollout, "
        f"{rt.compute_dtype}, pool features precomputed) on {smi}")
    log(f"[launches] over {1 + TIMED_ROLLOUTS} rollouts: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    sanity(traj, st, pool, ptr_before, cfg.num_actions)

    # the other pool branch: policy features of each reset's context encoded in the step
    ptr_before = int(pool.ptr)
    pool_nf = ICPool(obs=pool.obs, act=pool.act, hx=pool.hx, cx=pool.cx, ptr=pool.ptr)
    t0 = time.perf_counter()
    traj2, st2, pool_nf = engine.rollout(st, pool_nf, HORIZON, generator=rgen)
    torch.cuda.synchronize()
    log(f"[rollout] features encoded per reset: {BATCH * HORIZON / (time.perf_counter() - t0):.1f}"
        f" env_frames/s (one rollout, warm)")
    sanity(traj2, st2, pool_nf, ptr_before, cfg.num_actions)
    log(f"[sanity] frames uint8, rewards {sorted(traj['rew'].unique().tolist())}, ends "
        f"{sorted(traj['end'].unique().tolist())}, finite logits/values/states, pool pointer "
        f"{ptr_before} -> {int(pool_nf.ptr)}, deaths per rollout {int(traj['dead'].sum())}")

    profile_rollout(engine, st, pool, rgen)

    rows, details = compare_kernels(shapes, launches, 1 + TIMED_ROLLOUTS)
    rollout_ms = secs / TIMED_ROLLOUTS * 1e3
    for r in rows:
        log(f"[kernel] {r['name']}: {r['launches']} launches, {r['shapes']} shapes, "
            f"{r['ms']:.2f} ms of device time per rollout (plain {r['plain_ms']:.2f} ms), "
            f"rollout {rollout_ms:.1f} ms")
    reference_check(agent, st, pool, wm_cfg)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, fps=fps, rollout_ms=rollout_ms, kernels=rows, details=details), indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
