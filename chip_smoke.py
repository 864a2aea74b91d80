#!/usr/bin/env python3
"""Chip smoke test of diamond_tpu_torch: the imagination rollout of the full-size Breakout
agent on one NVIDIA GPU, bf16 and static int8 (the production default), through the
port's hand-written CUDA kernels.

    python3 chip_smoke.py              # from the repo root, on a machine with a CUDA GPU

Phases (each ends in torch.cuda.synchronize(); any failure exits non-zero and prints no
result line):
  1. build the kernels from kernels/csrc (one nvcc per source, in parallel, sm_90a) and
     load them;
  2. the card's name and power limit (nvidia-smi);
  3. the full-size agent (configs/agent/default.yaml widths, 4 Breakout actions) with
     random weights from a seed, bf16 compute; a pool of 1024 synthetic uint8 segments
     burned in through make_ic_preparer, with precomputed policy features
     (tpu.pool_policy_feats);
  4. the bf16 path: launch counts set to 0, one warm-up and two timed rollouts at B=32,
     T=15, 3 Euler steps -> env_frames/s (bench.py's imagination_fps_batch32_n3), counts
     read (K1-K3 each > 0, K4/K5 none); one rollout on the other pool branch (features
     encoded per reset); one under torch.profiler (device busy and idle share);
  5. calibration of the static int8 path on the live buffers as bench.py does
     (RuntimeConfig.int8_sites), then the int8 path the same way (K4, K5 each > 0), its
     other pool branch and its profile; then both paths timed in turns (bf16, int8,
     int8, bf16, three rounds), and the host-device synchronisations of one rollout of
     each;
  6. one full-size world-model step int8 against bf16 from the same state and x_init:
     the frame difference in grid levels (a figure, not a check);
  7. each kernel against its plain PyTorch version at every shape and dtype its path
     sent it, and in f32 (TF32 off), with device times, bounds and library yardsticks;
     K4's per-sample epilogue at the int8 path's norm shapes;
  8. the trajectories' sanity, and small full-width rollouts in f32 on the card against
     the same rollouts through the plain versions on the CPU, bf16 path and int8 path.
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

# kernel -> (source, the TPU kernel it replaces, the rollout path that launches it)
KERNELS = {
    "adagn_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                   "diamond_tpu/ops/fused_norms.py:97", "bf16"),
    "groupnorm_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                       "diamond_tpu/ops/fused_norms.py:65", "bf16"),
    "conv3x3": ("diamond_tpu_torch/kernels/csrc/conv3x3.cu", "diamond_tpu/ops/conv3x3.py:33",
                "bf16"),
    "adagn_silu_q8": ("diamond_tpu_torch/kernels/csrc/fused_q8.cu",
                      "diamond_tpu/ops/fused_q8.py:55", "int8"),
    "groupnorm_silu_q8": ("diamond_tpu_torch/kernels/csrc/fused_q8.cu",
                          "diamond_tpu/ops/fused_q8.py:55", "int8"),
    "conv3x3_int8": ("diamond_tpu_torch/kernels/csrc/conv3x3_q8.cu",
                     "diamond_tpu/ops/quant.py:161", "int8"),
}
# max |kernel - plain| allowed, as a share of max(1, max |plain|): f32 sums in another
# order (TF32 off on both sides); bf16 outputs are rounded once on both sides and may
# differ by one bf16 ulp (1/128 relative), so 2 ulps are allowed. The int8 conv is exact
# (int8 sums, then the same IEEE f32 steps). The quantizing norms are held in codes:
# at most 1 apart (a multiply-add the kernel fuses moves a value across a rounding
# boundary), in at most CODE_SHARE of the elements.
TOL = {"float32": {"adagn_silu": 1e-4, "groupnorm_silu": 1e-4, "conv3x3": 1e-3,
                   "conv3x3_int8": 0.0},
       "bfloat16": {"adagn_silu": 1 / 64, "groupnorm_silu": 1 / 64, "conv3x3": 1 / 64,
                    "conv3x3_int8": 0.0}}
CODE_SHARE = 1e-3
# The H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and dense
# operations/s by type; the norms' element-wise work runs on the CUDA cores in f32.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "int8_tensor": 1979e12, "f32_simt": 67e12}


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


def library_call(name, args):
    """The one PyTorch call that computes the kernel's function, where there is one, as a
    yardstick: cuDNN's conv for K3, F.group_norm for K2 without SiLU. None otherwise."""
    import torch.nn.functional as F

    if name == "conv3x3":
        return lambda: cudnn_bf16_conv(*args)
    if name == "groupnorm_silu" and not args[4]:
        x, scale, bias, g, _ = args
        return lambda: F.group_norm(x.permute(0, 3, 1, 2), g, scale.to(x.dtype),
                                    bias.to(x.dtype), eps=1e-5)
    return None


def bound(name, args):
    """(bytes time, operations time) in ms of one call: each input read once, each output
    written once, over HBM's rate; the operations the function needs over the peak of
    their type (f32 element-wise counts: statistics 3, normalize + affine 4, SiLU 4,
    quantize 4 per element; a conv 2 * M * Cout * 9 * Cin)."""
    import torch

    x = args[0]
    n, es = x.numel(), x.element_size()
    b, c = x.shape[0], x.shape[-1]
    if name in ("adagn_silu", "groupnorm_silu"):
        silu = args[-1]
        ops = n * (3 + 4 + 4 * silu)
        byts = 2 * n * es + (b * 2 * c * 4 if name == "adagn_silu" else 2 * c * 4)
        kind = "f32_simt"
    elif name in ("adagn_silu_q8", "groupnorm_silu_q8"):
        ops = n * (3 + 4 + 4 + 4)
        byts = n * es + n + (b * 2 * c * 4 if name == "adagn_silu_q8" else 2 * c * 4) + c * 4
        kind = "f32_simt"
    elif name == "norm_affine_silu_q8":
        ops = n * (4 + 4 + 1 + 4)
        byts = n * es + 4 * b * c * 4 + n + b * 4
        kind = "f32_simt"
    else:  # conv3x3 (x, w, bias, stride); conv3x3_int8 (x, w_q, w_scale, act_max, bias,
        #                                              stride, out_dtype, sample_scale)
        q8 = name == "conv3x3_int8"
        w, stride = args[1], args[5] if q8 else args[3]
        cin, cout = w.shape[2], w.shape[3]
        m = b * ((x.shape[1] - 1) // stride + 1) * ((x.shape[2] - 1) // stride + 1)
        ops = 2 * m * cout * 9 * cin
        out_es = (2 if args[6] == torch.bfloat16 else 4) if q8 else es
        small = [a for a in (args[2:5] + args[7:] if q8 else args[2:3])
                 if isinstance(a, torch.Tensor)]  # scales, bias, act_max
        byts = (n * es + w.numel() * w.element_size() + m * cout * out_es
                + sum(a.numel() * a.element_size() for a in small))
        kind = "int8_tensor" if q8 else "bf16_tensor"
    return byts / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3


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
    """Random inputs of one recorded call signature, on the card, in ``dtype`` (an int8
    input stays int8 codes)."""
    import torch
    from diamond_tpu_torch import ops

    dev = "cuda"
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    if name == "conv3x3":
        shape, cout, stride, has_bias, _ = sig
        x = rnd(*shape).to(dtype)
        w = ((torch.rand((3, 3, shape[-1], cout), generator=gen, device=dev) * 2 - 1)
             / (9 * shape[-1]) ** 0.5).to(dtype)
        return (x, w, 0.1 * rnd(cout) if has_bias else None, stride)
    if name == "conv3x3_int8":
        shape, x_dtype, cout, stride, has_bias, has_ss, _ = sig
        if x_dtype == "torch.int8":
            x, am = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                  dtype=torch.int8), None
        else:
            x = rnd(*shape).to(dtype)
            am = x.float().abs().amax(dim=(0, 1, 2)) * 0.95
        wq = torch.randint(-127, 128, (3, 3, shape[-1], cout), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(cout, generator=gen, device=dev) * 1e-3 + 1e-4
        ss = torch.rand((shape[0], 1), generator=gen, device=dev) + 0.1 if has_ss else None
        return (x, wq, ws, am, 0.1 * rnd(cout) if has_bias else None, stride, dtype, ss)
    shape, _, *silu = sig
    c = shape[-1]
    x = (2 * rnd(*shape) + 0.5).to(dtype)
    g = max(1, c // 32)
    if name in ("adagn_silu", "adagn_silu_q8"):
        ss = 0.5 * rnd(shape[0], 2 * c)
        if name == "adagn_silu":
            return (x, ss, g, silu[0])
        am = ops.adagn_silu_plain(x, ss, g).float().abs().amax(dim=(0, 1, 2)) * 0.95
        return (x, ss, g, am)
    scale, bias = 1 + 0.1 * rnd(c), 0.1 * rnd(c)
    if name == "groupnorm_silu":
        return (x, scale, bias, g, silu[0])
    am = ops.groupnorm_silu_plain(x, scale, bias, g).float().abs().amax(dim=(0, 1, 2)) * 0.95
    return (x, scale, bias, g, am)


def code_err(q, ref) -> float:
    """Largest code difference; fails on more than one, or in more than CODE_SHARE."""
    d = (q.int() - ref.int()).abs()
    check(int(d.max()) <= 1 and (d > 0).float().mean().item() <= CODE_SHARE,
          f"codes differ by {int(d.max())} in {(d > 0).float().mean().item():.2e} of elements")
    return float(d.max())


def compare_one(name, kernel, plain, args, dt_name):
    """Run kernel and plain version on args; check; return the max abs error."""
    import torch
    from diamond_tpu_torch import ops

    y, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if name in ("adagn_silu_q8", "groupnorm_silu_q8"):
        # the static epilogue equals quantize(K1/K2 kernel output) code for code
        base = ops.adagn_silu if name == "adagn_silu_q8" else ops.groupnorm_silu
        check(torch.equal(y, ops.quantize_static(base(*args[:-1]), args[-1])),
              f"{name}: codes differ from quantize({base.__name__} kernel)")
        return code_err(y, ref)
    check(bool(torch.isfinite(y.float()).all()), f"{name} {dt_name}: non-finite")
    scale = max(1.0, ref.float().abs().max().item())
    e = (y.float() - ref.float()).abs().max().item()
    check(e <= TOL[dt_name][name] * scale,
          f"{name} {dt_name}: max abs err {e} > {TOL[dt_name][name]} * {scale}")
    return e


def compare_kernels(shapes, launches, num_rollouts):
    """Each kernel against its plain version at the recorded signatures of its path
    (as the rollout ran them, and the same shapes in f32), timed, with its bound and
    library yardstick; times and bounds per rollout weight each signature by its calls.
    K4's per-sample epilogue runs at the int8 path's AdaGN shapes. Returns the JSON
    rows and the per-signature details."""
    import torch
    from diamond_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, details = [], []
    for name, (source, replaces, path) in KERNELS.items():
        kernel, plain = getattr(ops, name), getattr(ops, name + "_plain")
        err = {"float32": 0.0, "bfloat16": 0.0}
        tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, ms_where_library=0.0, cudnn_bf16_ms=0.0,
                   per_sample_ms=0.0, per_sample_plain_ms=0.0)
        has_library = False
        for sig, count in sorted(shapes[path][name].items(), key=lambda kv: str(kv[0])):
            run_dtype = sig[-1] if name.startswith("conv") else sig[1]  # as the path ran it
            for dt_name in ("bfloat16", "float32"):
                as_run = run_dtype == f"torch.{dt_name}"
                args = make_inputs(name, sig, getattr(torch, dt_name), gen)
                e = compare_one(name, kernel, plain, args, dt_name)
                err[dt_name] = max(err[dt_name], e)
                t_k = cuda_time_ms(lambda: kernel(*args))
                t_p = cuda_time_ms(lambda: plain(*args))
                row = dict(kernel=name, signature=str(sig), dtype=dt_name,
                           calls_per_rollout=count / num_rollouts, max_abs_err=e, ms=t_k,
                           plain_ms=t_p)
                if as_run:  # the rollout's dtype: weight by its call count
                    w = count / num_rollouts
                    t_b, t_o = bound(name, args)
                    row.update(bytes_ms=t_b, ops_ms=t_o, bound_ms=max(t_b, t_o))
                    tot["ms"] += w * t_k
                    tot["plain_ms"] += w * t_p
                    tot["bytes_ms"] += w * t_b
                    tot["ops_ms"] += w * t_o
                    tot["bound_ms"] += w * max(t_b, t_o)
                    lib = library_call(name, args)
                    if lib is not None:
                        has_library = True
                        row["library_ms"] = cuda_time_ms(lib)
                        tot["library_ms"] += w * row["library_ms"]
                        tot["ms_where_library"] += w * t_k
                    if name == "conv3x3_int8":
                        x, wq, ws, am, bias, stride = args[:6]
                        xb = (x.float() if x.dtype == torch.int8 else x).to(torch.bfloat16)
                        wb = wq.to(torch.bfloat16)
                        row["cudnn_bf16_ms"] = cuda_time_ms(
                            lambda: cudnn_bf16_conv(xb, wb, bias, stride))
                        tot["cudnn_bf16_ms"] += w * row["cudnn_bf16_ms"]
                if name == "adagn_silu_q8":  # K4's per-sample epilogue at the same shapes
                    x, ss, g, _ = args
                    c = x.shape[-1]
                    mean_c, inv_c = ops.group_stats_channels(x, g)
                    pargs = (x, mean_c, inv_c, 1 + ss[:, :c], ss[:, c:])
                    qt, ref = ops.norm_affine_silu_q8(*pargs), ops.norm_affine_silu_q8_plain(*pargs)
                    torch.cuda.synchronize()
                    rel = ((qt.scale - ref.scale).abs() / ref.scale).max().item()
                    check(rel <= 1e-5, f"norm_affine_silu_q8 {sig}: scale rel err {rel}")
                    row["per_sample_code_err"] = code_err(qt.q, ref.q)
                    row["per_sample_ms"] = cuda_time_ms(lambda: ops.norm_affine_silu_q8(*pargs))
                    row["per_sample_plain_ms"] = cuda_time_ms(
                        lambda: ops.norm_affine_silu_q8_plain(*pargs))
                    pb, po = bound("norm_affine_silu_q8", pargs)
                    row["per_sample_bound_ms"] = max(pb, po)
                    if as_run:
                        tot["per_sample_ms"] += count / num_rollouts * row["per_sample_ms"]
                        tot["per_sample_plain_ms"] += (count / num_rollouts
                                                       * row["per_sample_plain_ms"])
                details.append(row)
                log(f"[compare] {name} {sig} {dt_name}: err {e:.3g} kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms" + "".join(f" {k} {row[k]:.4f}" for k in (
                        "bound_ms", "library_ms", "cudnn_bf16_ms", "per_sample_ms")
                        if k in row))
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=launches[path][name], max_abs_err=err["bfloat16"],
                     ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                     bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
                     library_ms=tot["library_ms"] if has_library else None,
                     max_abs_err_f32=err["float32"], path=path,
                     launches_by_path={p: launches[p][name] for p in launches},
                     shapes=len(shapes[path][name]))
        if has_library and name == "groupnorm_silu":
            entry["library_covers"] = "silu=False calls only"
            entry["ms_where_library"] = tot["ms_where_library"]
        if name == "conv3x3_int8":
            entry["cudnn_bf16_ms"] = tot["cudnn_bf16_ms"]  # a bf16 conv, not the int8 one
        if name == "adagn_silu_q8":
            entry["per_sample_epilogue"] = dict(ms=tot["per_sample_ms"],
                                                plain_ms=tot["per_sample_plain_ms"])
        rows.append(entry)
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


def reference_check(agent, st, pool, wm_cfg, int8_sites=None):
    """A B=2, T=2 full-width rollout in f32 on the card (kernels, TF32 off) against the
    same rollout on the CPU (plain versions), same weights and draws, pool features
    encoded per reset. bf16 path (``int8_sites`` None): actions, rewards and ends agree
    exactly, logits and values to 1e-3, frames to one grid level in at most 1% of the
    values. int8 path: the card's f32 agent is calibrated on its buffers and the CPU
    agent gets the same collection; actions, rewards and ends agree exactly (a value one
    ulp from a rounding boundary lands on another int8 code, and flipped codes cascade,
    so logits and frames are reported, not held to the f32 bounds)."""
    import torch
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImagState, ImaginationEngine,
                                                        draw_rollout_noise)
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.ops import quant

    b, t = 2, 2
    outs, colls = [], {}
    draws = draw_rollout_noise(t, b, tuple(st.obs_buffer.shape[2:]), agent.cfg.num_actions,
                               torch.Generator().manual_seed(SEED + 2), torch.device("cpu"))
    for dev in ("cuda", "cpu"):
        a = Agent(agent.cfg, torch.float32, device=dev)
        for name, net in a.nets.items():
            net.load_state_dict(agent.nets[name].state_dict())
        eng = ImaginationEngine(a.denoiser, a.rew_end_model, a.actor_critic, wm_cfg)
        s = ImagState(**{k: getattr(st, k)[:b].to(dev) for k in st.__dataclass_fields__})
        if int8_sites is not None:
            nets = {"d": a.denoiser.inner_model, "r": a.rew_end_model.net}
            if dev == "cuda":
                obs_f = obs_to_float(s.obs_buffer)
                eng.sampler.calibrate(obs_f, s.act_buffer, int8_sites, x_init=draws.x_init[0].to(dev))
                a.rew_end_model.calibrate(obs_f[:, -2:-1], s.act_buffer[:, -2:-1], obs_f[:, -1:],
                                          int8_sites)
                colls = {k: quant.collection(n) for k, n in nets.items()}
            else:
                for k, n in nets.items():
                    quant.install(n, colls[k])
        p = ICPool(obs=pool.obs[:8].to(dev), act=pool.act[:8].to(dev), hx=pool.hx[:8].to(dev),
                   cx=pool.cx[:8].to(dev), ptr=torch.zeros((), dtype=torch.long, device=dev))
        traj, s, p = eng.rollout(s, p, t, draws=type(draws)(*(d.to(dev) for d in draws)))
        if dev == "cuda":
            torch.cuda.synchronize()
        outs.append(({k: v.cpu() for k, v in traj.items()}, s.obs_buffer.cpu()))
    (tg, og), (tc, oc) = outs
    path = "bf16 path" if int8_sites is None else f"int8 path ({int8_sites})"
    for k in ("act", "rew", "end", "trunc"):
        check(torch.equal(tg[k], tc[k]), f"reference check, {path}: {k} differs card vs CPU")
    err = max((tg[k] - tc[k]).abs().max().item() for k in ("logits_act", "val", "val_bootstrap"))
    d = (og.long() - oc.long()).abs()
    share = (d > 0).float().mean().item()
    if int8_sites is None:
        check(err <= 1e-3, f"reference check: logits/values differ by {err}")
        check(int(d.max()) <= 1 and share <= 0.01, f"reference check: frames differ {d.max()} {share}")
    log(f"[reference] {path}, B={b} T={t} f32 card vs CPU plain: actions/rewards/ends equal, "
        f"max logit/value diff {err:.3g}, frames off by up to {int(d.max())} level(s) in "
        f"{share:.4%} of values")
    return dict(max_logit_value_diff=err, frame_max_levels=int(d.max()), frame_share=share)


def profile_rollout(engine, st, pool, gen, label) -> dict:
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
    (OUT_DIR / f"chip_smoke_profile_{label}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] {label} rollout: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {launches} cudaLaunchKernel calls")
    for e in kernels[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x {e.key[:90]}")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=launches,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels[:12]])


def drive(engine, st, pool, gen, label, smi):
    """The main path of one dtype: every launch count set to 0, one warm-up and the timed
    rollouts, the counts and call signatures read. Returns (traj, st, pool, signatures,
    result)."""
    import torch
    from diamond_tpu_torch import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0
        getattr(ops, name).shapes.clear()
    traj, st, pool = engine.rollout(st, pool, HORIZON, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_ROLLOUTS):
        traj, st, pool = engine.rollout(st, pool, HORIZON, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    fps = BATCH * HORIZON * TIMED_ROLLOUTS / secs
    log(f"[rollout] {label}: imagination_fps_batch32_n3 = {fps:.1f} env_frames/s "
        f"({secs / TIMED_ROLLOUTS * 1e3:.1f} ms per B={BATCH} T={HORIZON} rollout, pool "
        f"features precomputed) on {smi}")
    log(f"[launches] {label}, over {1 + TIMED_ROLLOUTS} rollouts: {launches}")
    for name, (_, _, path) in KERNELS.items():
        if path == label:
            check(launches[name] > 0, f"{name} was not launched on the {label} path")
    return traj, st, pool, shapes, dict(fps=fps, rollout_ms=secs / TIMED_ROLLOUTS * 1e3,
                                        launches=launches)


def other_branch(engine, st, pool, gen, num_actions, label) -> float:
    """One rollout with the policy features of each reset's context encoded in the step."""
    import torch
    from diamond_tpu_torch.envs.world_model_env import ICPool

    ptr_before = int(pool.ptr)
    pool_nf = ICPool(obs=pool.obs, act=pool.act, hx=pool.hx, cx=pool.cx, ptr=pool.ptr)
    t0 = time.perf_counter()
    traj, st2, pool_nf = engine.rollout(st, pool_nf, HORIZON, generator=gen)
    torch.cuda.synchronize()
    fps = BATCH * HORIZON / (time.perf_counter() - t0)
    log(f"[rollout] {label}, features encoded per reset: {fps:.1f} env_frames/s (one rollout, "
        f"warm)")
    sanity(traj, st2, pool_nf, ptr_before, num_actions)
    log(f"[sanity] {label}: frames uint8, rewards {sorted(traj['rew'].unique().tolist())}, "
        f"ends {sorted(traj['end'].unique().tolist())}, finite logits/values/states, pool "
        f"pointer {ptr_before} -> {int(pool_nf.ptr)}, deaths {int(traj['dead'].sum())}")
    return fps


def set_int8(nets, colls, on: bool) -> None:
    """Install the calibrated collections (int8 path) or drop them (bf16 path)."""
    from diamond_tpu_torch.ops import quant

    for n, c in zip(nets, colls):
        quant.install(n, c if on else {})


def sync_points(engine, st, pool, gen) -> dict:
    """One rollout under torch.cuda's sync debug mode: the host-device synchronisations
    it makes, by the line of Python that made them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.rollout(st, pool, HORIZON, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def alternate(engine, agent, colls, st, pool, gen, rounds: int = 3) -> dict:
    """Rollout times of the two paths in turns (bf16, int8, int8, bf16) within one call,
    so that the host's drift falls on both; env_frames/s per rollout."""
    import torch

    nets = [agent.denoiser.inner_model, agent.rew_end_model.net]
    fps = {"bf16": [], "int8": []}
    for _ in range(rounds):
        for label in ("bf16", "int8", "int8", "bf16"):
            set_int8(nets, colls, label == "int8")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st, pool = engine.rollout(st, pool, HORIZON, generator=gen)
            torch.cuda.synchronize()
            fps[label].append(BATCH * HORIZON / (time.perf_counter() - t0))
    set_int8(nets, colls, True)
    out = {}
    for label, v in fps.items():
        v = sorted(v)
        out[label] = dict(median=v[len(v) // 2], min=v[0], max=v[-1], runs=fps[label])
        log(f"[alternate] {label}: imagination_fps_batch32_n3 median {v[len(v) // 2]:.1f} "
            f"(min {v[0]:.1f}, max {v[-1]:.1f}) env_frames/s over {len(v)} rollouts in turns")
    return out


def int8_vs_bf16_step(engine, agent, st, gen) -> dict:
    """One full-size world-model step from the same state and x_init, int8 (the installed
    collections) against bf16 (the same models without them): the next frame's difference
    in grid levels. A figure for PERF.md, not a check."""
    import torch
    from diamond_tpu_torch.ops import quant

    nets = [agent.denoiser.inner_model, agent.rew_end_model.net]
    colls = [quant.collection(n) for n in nets]
    x_init = torch.randn(tuple(st.obs_buffer.shape[:1]) + tuple(st.obs_buffer.shape[2:]),
                         generator=gen, device="cuda")
    g3, g2 = (torch.zeros((BATCH, k), device="cuda") for k in (3, 2))
    act = st.act_buffer[:, -1]
    frames = []
    for int8 in (True, False):
        set_int8(nets, colls, int8)
        _, next_obs, *_ = engine._wm_transition(st, act, x_init, g3, g2)
        frames.append(torch.round((next_obs.float() + 1) * 127.5))
    set_int8(nets, colls, True)
    d = (frames[0] - frames[1]).abs()
    out = dict(max_levels=int(d.max()), share_within_6=(d <= 6).float().mean().item(),
               share_equal=(d == 0).float().mean().item(), mean_levels=d.mean().item())
    log(f"[int8-vs-bf16] one world-model step, same state and x_init: frames differ by up to "
        f"{out['max_levels']} grid levels (mean {out['mean_levels']:.3f}); "
        f"{out['share_within_6']:.4%} within 6 levels, {out['share_equal']:.4%} equal")
    return out


def num_sites(coll: dict) -> int:
    return sum(num_sites(v) if isinstance(v, dict) else k == "act_scale" for k, v in coll.items())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from diamond_tpu_torch import kernels
    from diamond_tpu_torch.config import AgentConfig, RuntimeConfig, WorldModelEnvConfig
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine,
                                                        encode_pool_feats, make_ic_preparer)
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.ops import quant

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
    check(rt.int8_rollout, "RuntimeConfig.int8_rollout is off: the int8 path is not the default")
    cfg = AgentConfig()
    wm_cfg = WorldModelEnvConfig()
    dtype = getattr(torch, rt.compute_dtype)
    gen = torch.Generator().manual_seed(SEED)
    agent = Agent(cfg, dtype, generator=gen)  # on the card
    for net in agent.nets.values():
        perturb_zero_leaves(net, gen)
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
    rgen = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # the bf16 path
    ptr_before = int(pool.ptr)
    shapes = {}
    traj, st, pool, shapes["bf16"], results["bf16"] = drive(engine, st, pool, rgen, "bf16", smi)
    check(all(results["bf16"]["launches"][n] == 0 for n, k in KERNELS.items() if k[2] == "int8"),
          "an int8 kernel ran on the uncalibrated (bf16) path")
    sanity(traj, st, pool, ptr_before, cfg.num_actions)
    results["bf16"]["other_branch_fps"] = other_branch(engine, st, pool, rgen, cfg.num_actions,
                                                       "bf16")
    results["bf16"]["profile"] = profile_rollout(engine, st, pool, rgen, "bf16")

    # calibration on the live buffers (bench.py:131-136), then the int8 path
    t0 = time.perf_counter()
    obs_f = obs_to_float(st.obs_buffer)
    d_coll = engine.sampler.calibrate(obs_f, st.act_buffer, rt.int8_sites, generator=rgen)
    r_coll = agent.rew_end_model.calibrate(obs_f[:, -2:-1], st.act_buffer[:, -2:-1],
                                           obs_f[:, -1:], rt.int8_sites)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    log(f"[calibrate] sites {rt.int8_sites!r}: {num_sites(d_coll)} denoiser sites, "
        f"{num_sites(r_coll)} rew/end sites, in {calib_s:.2f} s")
    ptr_before = int(pool.ptr)
    traj, st, pool, shapes["int8"], results["int8"] = drive(engine, st, pool, rgen, "int8", smi)
    sanity(traj, st, pool, ptr_before, cfg.num_actions)
    results["int8"]["calibration_s"] = calib_s
    results["int8"]["other_branch_fps"] = other_branch(engine, st, pool, rgen, cfg.num_actions,
                                                       "int8")
    results["int8"]["profile"] = profile_rollout(engine, st, pool, rgen, "int8")
    log(f"[rollout] imagination_fps_batch32_n3: int8 {results['int8']['fps']:.1f} vs bf16 "
        f"{results['bf16']['fps']:.1f} env_frames/s on {smi}")
    colls = [quant.collection(agent.denoiser.inner_model), quant.collection(agent.rew_end_model.net)]
    results["alternate"] = alternate(engine, agent, colls, st, pool, rgen)
    for label in ("bf16", "int8"):
        set_int8([agent.denoiser.inner_model, agent.rew_end_model.net], colls, label == "int8")
        results[label]["sync_points"] = sync_points(engine, st, pool, rgen)
        log(f"[sync] {label} rollout: {sum(results[label]['sync_points'].values())} host-device "
            f"synchronisations {results[label]['sync_points']}")
    results["int8_vs_bf16_step"] = int8_vs_bf16_step(engine, agent, st, rgen)

    launches = {p: results[p]["launches"] for p in ("bf16", "int8")}
    rows, details = compare_kernels(shapes, launches, 1 + TIMED_ROLLOUTS)
    for r in rows:
        log(f"[kernel] {r['name']}: {r['launches']} launches on the {r['path']} path, "
            f"{r['shapes']} shapes, {r['ms']:.2f} ms of device time per rollout (plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.2f} ms by {r['bound_by']}"
            + (f", library {r['library_ms']:.2f} ms" if r["library_ms"] is not None else "")
            + ")")
    results["reference_bf16"] = reference_check(agent, st, pool, wm_cfg)
    results["reference_int8"] = reference_check(agent, st, pool, wm_cfg, rt.int8_sites)

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        card=smi, results=results, kernels=rows, details=details), indent=1, default=str))
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
