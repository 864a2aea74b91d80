#!/usr/bin/env python3
"""Chip smoke test of diamond_tpu_torch: the imagination rollout of the full-size Breakout
agent on one NVIDIA GPU, bf16 and static int8 (the production default), the
actor-critic train step in imagination on the int8 world model, the denoiser train
step, the rew/end train step fed from the device episode store, the model-free
actor-critic step, three epochs of the whole trainer, the two-stage (csgo) world
model (play at batch 1, its train steps, its wm_only trainer), the play app and the
train steps through data parallelism (an NCCL group, two gloo ranks), through the port's
hand-written CUDA kernels.

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
     (RuntimeConfig.int8_sites), then the int8 path the same way (K4, K5, K6 each > 0), its
     other pool branch and its profile (no torch._int_mm, no more round or clamp ops than
     the bf16 rollout's); then both paths timed in turns (bf16, int8,
     int8, bf16, three rounds), and the host-device synchronisations of one rollout of
     each;
  6. one full-size world-model step int8 against bf16 from the same state and x_init:
     the frame difference in grid levels (a figure, not a check);
  6b. the actor-critic train step (training.make_ac_train_step, B=32, T=15, bf16
     actor-critic, the int8-calibrated world model, warmup 0): counts set to 0, one
     warm-up and AC_STEPS timed steps -> ms per step, training env_frames/s, the
     backward kernels' launches (K2's backward, K3's data and weight gradients each
     > 0), peak memory; loss and gradient norm finite, the actor-critic's weights
     moved, the world model's unchanged and without gradients; one step profiled (kernel
     launch calls at most those of a step whose K2 backward still made a second launch,
     less those launches, and no cast or sum under the norm backwards) and one under the
     sync debug mode;
  6c. the denoiser train step (training.make_denoiser_train_step, B=32 segments of 6
     frames: two autoregressive windows, bf16 compute, trainer.yaml's denoiser optimizer
     with warmup 0) on a deep copy of the agent's denoiser: counts set to 0, one warm-up
     and DEN_STEPS timed steps -> ms per step, training samples/s, launches per step of
     each kernel (held to the counts the module tree gives: K1 and its backward, K2 and
     its backward, K3 with its data gradient (stride 1, and stride 2's own kernel) and
     weight gradient, stride 2 and the bias gradient apart), peak memory; one step
     profiled (device busy, the backward Functions' CPU time per call, kernel launch
     calls at most those of a conv backward that still summed the bias and interleaved
     and flipped at stride 2 and of norm backwards that still made K2's second launch
     and cast their affine gradients, less those launches, and no bias sum, zero
     interleave or stride-2 flip under the conv's backward, no cast or sum under the
     norm backwards), one under the sync debug mode; every parameter gets a finite
     gradient and moves, the agent's denoiser stays untouched; the host cost of each
     backward piece per call;
  6d. the rew/end train step (training.make_rew_end_train_step, B=32, T=19, bf16,
     trainer.yaml's rew/end optimizer with warmup 0) on a deep copy of the agent's
     rew/end model, fed by StoreBatchIterator: a Dataset of 10,000 seeded synthetic
     steps (deaths with their final frames) mirrored into a DeviceEpisodeStore on the
     card, segments drawn with trainer.yaml's weights and can_sample_beyond_end, the
     store's batch held to the host collate; counts set to 0, one warm-up and REW_STEPS
     timed steps -> ms per step, rew/end training frames/s (B x (T - 1) / step),
     launches per step held to the encoder's module tree, peak memory; one step
     profiled, one under the sync debug mode (none allowed), every leaf's gradient
     finite and every weight moved, the eval step, two steps with grad_acc_steps = 2
     (the weights move on the second only), the agent's rew/end model untouched;
  6e. the model-free AC step (training.make_model_free_ac_train_step, B=32, T=15, bf16)
     on seeded recorded tensors with resets, on a deep copy of the actor-critic: counts
     set to 0, one warm-up and MF_STEPS timed steps, launches held to the trunk's module
     tree, one step profiled, none synchronising, every weight moved;
  6f. the trainer (diamond_tpu_torch.trainer.Trainer, what `python -m
     diamond_tpu_torch.main` runs) on env=fake at the full default widths (B = 32 for
     every component, horizon 15, 3 Euler steps, bf16, int8 rollout, device store), cut
     to three epochs (TRAINER_OVERRIDES): counts set to 0, the run, the counts read
     (every kernel > 0); the wall seconds of each part of each epoch (collection and
     its env steps/s, each component's ms per step, IC-pool builds and swaps and
     pool_refill_wait_s, recalibration, test collection, evaluation, checkpoint), the
     final-protocol metrics; the rew/end windows that reach an episode's end (> 0);
     every AC step on int8 weights folded after the last world-model step; the last
     background IC pool against a synchronous rebuild from its ids and weight snapshot
     (1/64 of the largest |value|); the agent snapshot loaded into a fresh Agent (equal
     outputs); a resumed Trainer equal to the last saved state bit for bit; the
     host-device syncs of one step of each component (none for the denoiser and rew/end
     steps, the pool pointer's read for the AC step);
  6g. the two-stage (csgo) world model at agent/csgo.yaml's widths (the dynamics U-Net
     at 16x16, the upsampler's at 64x64, 4 actions, bf16, 3 Euler steps both stages):
     play through ``WorldModelEnv`` with the upsampler at num_envs = 1 on
     bench_two_stage.py's synthetic IC provider, bf16 and int8 (the three nets calibrated
     as bench_two_stage.py does) in turns, 3 warm-up steps then 60 steps x 3 of each, every
     chunk counted -> ``two_stage_play_fps_batch1`` per path, syncs per step over one
     horizon, one step profiled; a few f32 play steps on the card against the CPU (same
     weights, ICs and draws: rewards and ends equal, frames within one grid level); the
     upsampler step (B 16 x T 2 at 64x64) and the two-stage denoiser step (B 32, frames
     downsampled in the step) with launches held to the module tree and no sync; the
     wm_only trainer on a static dataset of fake-env episodes (two epochs with
     evaluation, its snapshot in a fresh Agent, resume bit for bit, no sync in its steps);
  6h. the play app (diamond_tpu_torch.play, headless: the card has no pygame) for the
     default Atari agent and the csgo agent at their full widths on env=fake: a run dir
     written for each (config/trainer.json and a snapshot of seeded random weights), the
     app built through ``play.build_app`` as ``play --run-dir <run> --horizon 50 --int8``
     (1,000 seed steps), then the PlayEnv driven directly: bf16 and int8, human
     (scripted actions) and policy control, 3 warm-up then 60 frames x 3 of each in
     turns, every chunk counted -> ``play_fps_batch1`` (best, median), ms, host-device
     syncs and kernel launch calls per frame, device busy and idle share per frame of
     five profiled frames; the horizon down and up, a cycle through the real envs;
     ``play -r`` until two episodes are recorded and ``play -d`` browsing them; a few
     policy-controlled f32 frames of the default agent card vs CPU (actions, rewards and
     ends equal);
  6i. data parallelism (diamond_tpu_torch.parallel) on a fresh agent made as in 3: the
     denoiser (six rows' first window padded), rew/end (store-fed), actor-critic (int8
     world model calibrated through the group, from a whole pool) and model-free steps,
     two updates each on the rank's rows of the global B = 32 batches and draws, (a)
     through an NCCL process group at world size 1, counts set to 0 and read (every
     kernel > 0): bit for bit against the path without a group (which repeats bit for
     bit), the bytes each update reduces, the host-device syncs of a step (none but the
     AC step's), the NCCL kernels' device time in a profiled step; (b) two spawned ranks
     on the one card over gloo, 16 rows each: gradients, parameters and losses equal bit
     for bit across the ranks, within tolerance of (a)'s path without a group (losses
     1e-4, the AC step's 1e-3, the first update's gradients 1e-2 of their leaf's largest
     |value|, parameters within Adam's bound), the pool pointer and the pool equal, each
     rank's launches of every kernel > 0;
  7. each kernel against its plain PyTorch version at every shape and dtype its paths
     sent it (the backward kernels: those of the four train steps), and in f32
     (TF32 off), with device times, bounds and library yardsticks (the weight gradient
     also its bias gradient's error); the backward kernels repeat bit for bit; K1/K2
     forward with the moments output gives the same y as without, and the moments
     (written by the forward kernel and fed to the norm backwards) agree with the
     plain ones;
     the share of the bound; for the 3x3 convs also the ratio to cuDNN's bf16 conv and
     the blocks of the launch plan, for the norms the cluster size and blocks of theirs;
     K4's per-sample epilogue at the int8 path's norm shapes; K6 also against the separate
     ops it replaced and torch._int_mm on the same codes, with its launch plan
     (ops/matmul_plan.py), and its 64² projection also with L2 flushed before each call
     (its x and y fill L2); K7, on no path, at the
     denoiser's 3x3 shapes (DRIVEN_ONLY): its codes and scale, and the conv through K5,
     bit for bit;
  8. the trajectories' sanity, and small full-width rollouts in f32 on the card against
     the same rollouts through the plain versions on the CPU, bf16 path and int8 path;
     the actor-critic's gradient (trunk and heads) on the same frames and carries, card
     against CPU, and a B=2, T=2 f32 AC-step loss and gradient card against CPU; a B=2,
     two-window f32 denoiser loss, its gradients and its fed-back frame card against CPU;
     a B=2 f32 rew/end loss (with the final-obs swap), its confusion matrices and
     gradients, and a B=2 f32 model-free AC loss and gradients, card against CPU.
The last line is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

SEED = 0
BATCH, HORIZON = 32, 15
POOL_SIZE = 1024
TIMED_ROLLOUTS = 2
AC_STEPS = 3
DEN_STEPS = 3
REW_STEPS = 3
MF_STEPS = 3
# the rew/end step's dataset: about what the first epoch's collection leaves
# (trainer.yaml collection.train.first_epoch: 5,000 to 10,000 steps)
DATASET_STEPS = 10_000
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# kernel -> (source, the TPU kernel it replaces, the paths that launch it: rollout paths
# and train steps, the first of them the one its line of the kernels table reports)
KERNELS = {
    "adagn_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                   "diamond_tpu/ops/fused_norms.py:97",
                   ("bf16", "denoiser_step", "rew_end_step", "trainer", "ts_play_bf16",
                    "ts_up_step", "ts_den_step", "ts_trainer", "play_default_bf16",
                    "play_csgo_bf16")),
    "groupnorm_silu": ("diamond_tpu_torch/kernels/csrc/fused_norms.cu",
                       "diamond_tpu/ops/fused_norms.py:65",
                       ("bf16", "denoiser_step", "rew_end_step", "mf_ac_step", "trainer",
                        "ts_play_bf16", "ts_up_step", "ts_den_step", "ts_trainer",
                        "play_default_bf16", "play_default_int8", "play_csgo_bf16",
                        "play_csgo_int8")),
    "conv3x3": ("diamond_tpu_torch/kernels/csrc/conv3x3.cu", "diamond_tpu/ops/conv3x3.py:33",
                ("bf16", "denoiser_step", "rew_end_step", "mf_ac_step", "trainer",
                 "ts_play_bf16", "ts_play_int8", "ts_up_step", "ts_den_step", "ts_trainer",
                 "play_default_bf16", "play_default_int8", "play_csgo_bf16", "play_csgo_int8")),
    "adagn_silu_q8": ("diamond_tpu_torch/kernels/csrc/fused_q8.cu",
                      "diamond_tpu/ops/fused_q8.py:55", ("int8", "trainer", "ts_play_int8",
                                                         "play_default_int8", "play_csgo_int8")),
    "groupnorm_silu_q8": ("diamond_tpu_torch/kernels/csrc/fused_q8.cu",
                          "diamond_tpu/ops/fused_q8.py:55", ("int8", "trainer", "ts_play_int8",
                                                             "play_default_int8",
                                                             "play_csgo_int8")),
    "conv3x3_int8": ("diamond_tpu_torch/kernels/csrc/conv3x3_q8.cu",
                     "diamond_tpu/ops/quant.py:161", ("int8", "trainer", "ts_play_int8",
                                                      "play_default_int8", "play_csgo_int8")),
    # the int8 sites' products: 1x1 convs, dense layers, LSTM gates (XLA on the TPU)
    "matmul_int8": ("diamond_tpu_torch/kernels/csrc/matmul_q8.cu",
                    "diamond_tpu/ops/quant.py:190", ("int8", "trainer", "ts_play_int8",
                                                     "play_default_int8", "play_csgo_int8")),
    # the activation side of the dynamic-scale int8 conv (quant.conv3x3_q8, XLA on the
    # TPU), on no path: phase 7 alone drives it, at DRIVEN_ONLY's signatures
    "absmax_quantize_q8": ("diamond_tpu_torch/kernels/csrc/quantize_q8.cu",
                           "diamond_tpu/ops/quant.py:212", ()),
    # the backward of K2's custom_vjp (the XLA VJP of _gn_silu_ref on the TPU)
    "groupnorm_silu_bwd": ("diamond_tpu_torch/kernels/csrc/gn_bwd.cu",
                           "diamond_tpu/ops/fused_norms.py:155",
                           ("ac_step", "denoiser_step", "rew_end_step", "mf_ac_step", "trainer",
                            "ts_up_step", "ts_den_step", "ts_trainer")),
    # K3's gradients (XLA's VJP of the 3x3 conv on the TPU): the data gradient at stride 1
    # (K3 on dy) and at stride 2 (a kernel of its own), the weight and bias gradients
    "conv3x3_dgrad": ("diamond_tpu_torch/kernels/csrc/conv3x3.cu",
                      "diamond_tpu/ops/conv3x3.py:33",
                      ("ac_step", "denoiser_step", "rew_end_step", "mf_ac_step", "trainer",
                       "ts_up_step", "ts_den_step", "ts_trainer")),
    "conv3x3_dgrad_s2": ("diamond_tpu_torch/kernels/csrc/conv3x3_dgrad_s2.cu",
                         "diamond_tpu/ops/conv3x3.py:33",
                         ("denoiser_step", "rew_end_step", "trainer", "ts_up_step", "ts_den_step",
                          "ts_trainer")),
    "conv3x3_wgrad": ("diamond_tpu_torch/kernels/csrc/conv3x3_wgrad.cu",
                      "diamond_tpu/ops/conv3x3.py:33",
                      ("ac_step", "denoiser_step", "rew_end_step", "mf_ac_step", "trainer",
                       "ts_up_step", "ts_den_step", "ts_trainer")),
    # the backward of K1's custom_vjp (the XLA VJP of _adagn_silu_ref on the TPU)
    "adagn_silu_bwd": ("diamond_tpu_torch/kernels/csrc/gn_bwd.cu",
                       "diamond_tpu/ops/fused_norms.py:187",
                       ("denoiser_step", "rew_end_step", "trainer", "ts_up_step", "ts_den_step",
                        "ts_trainer")),
}
BACKWARD = ("groupnorm_silu_bwd", "conv3x3_dgrad", "conv3x3_wgrad")
# the kernels of the int8 path, none of which the bf16 paths may launch
INT8_KERNELS = ("adagn_silu_q8", "groupnorm_silu_q8", "conv3x3_int8", "matmul_int8")
# a kernel on no path: the signatures phase 7 drives it at, one call each; K7 at the
# denoiser's 3x3 shapes (x's shape, dtype, Cout, stride): a 64x64 64 -> 64 conv, the
# Downsample (stride 2) and conv_in (Cin 15: 4 conditioning frames and the noisy one)
DRIVEN_ONLY = {"absmax_quantize_q8": [((32, 64, 64, 64), "torch.bfloat16", 64, 1),
                                      ((32, 64, 64, 64), "torch.bfloat16", 64, 2),
                                      ((32, 64, 64, 15), "torch.bfloat16", 64, 1)]}
# The int8 rollout's kernel launch calls and device busy ms (NVIDIA H100 80GB HBM3,
# 700 W) when its matmul sites still quantized, multiplied (torch._int_mm, or float64
# where it refuses the shape), rescaled, cast and added the bias in separate ops: printed
# beside the count of this run
INT8_ROLLOUT_BEFORE = (32918, 215.1)
# K6 calls with at least this many rows (the denoiser's 64² projection, whose x and y
# match L2's 50 MB) are also timed with L2 flushed before each call
COLD_ROWS = 131072
# the backward kernels, whose sums run in a fixed order: two calls give the same bits
REPEATS = ("groupnorm_silu_bwd", "conv3x3_wgrad", "adagn_silu_bwd", "conv3x3_dgrad_s2")
# the bias gradient, summed in the weight-gradient kernel: within DB_TOL of max(1, max
# |dy's f32 sum|) (sums of up to 131k terms in another order)
DB_TOL = 1e-3
# the moments K1/K2's forward writes for the backward (f32 mean and 1/std per sample and
# group): within MOMENTS_TOL of max(1, their largest |value|) of the plain ones
MOMENTS_TOL = 1e-6
# The denoiser step's kernel launch calls (NVIDIA H100 80GB HBM3, 700 W) when its conv
# backward still summed the bias with its own reduction and, at stride 2, interleaved dy
# and flipped the kernel, and the norm backwards still made K2's second launch and cast
# their affine gradients: the step must make at most this many less those launches
DENOISER_LAUNCH_CALLS_BEFORE = 2882
# The AC step's (the same card) when the norm backwards still made those launches
AC_LAUNCH_CALLS_BEFORE = 35869
# max |kernel - plain| allowed, as a share of max(1, max |plain|): f32 sums in another
# order (TF32 off on both sides); bf16 outputs are rounded once on both sides and may
# differ by one bf16 ulp (1/128 relative), so 2 ulps are allowed. The int8 conv and
# product are exact (int8 sums, then the same IEEE f32 steps), and so are the dynamic
# conv's codes, scale and output. The quantizing norms are held in codes:
# at most 1 apart, and only where the value lies at a rounding boundary (every element
# that differs within one unit of its code boundary: ops.static_code_flips and
# per_sample_code_flips), in at most CODE_SHARE of the elements, or in one element where
# a tensor has fewer than 1 / CODE_SHARE (the two-stage model's 2x2x128 at B = 1 has
# 512); such small tensors are held on FLIP_SEEDS inputs more. K2's backward: f32 dx 1e-4, dscale
# and dbias 1e-3 (sums over up to 131k terms in another order), bf16 all 1/64; K1's the
# same, its FiLM gradient summed per sample over up to 4,096 pixels.
TOL = {"float32": {"adagn_silu": 1e-4, "groupnorm_silu": 1e-4, "conv3x3": 1e-3,
                   "conv3x3_int8": 0.0, "matmul_int8": 0.0, "absmax_quantize_q8": 0.0,
                   "groupnorm_silu_bwd": (1e-4, 1e-3, 1e-3),
                   "adagn_silu_bwd": (1e-4, 1e-3), "conv3x3_dgrad": 1e-3,
                   "conv3x3_dgrad_s2": 1e-3, "conv3x3_wgrad": 1e-3},
       "bfloat16": {"adagn_silu": 1 / 64, "groupnorm_silu": 1 / 64, "conv3x3": 1 / 64,
                    "conv3x3_int8": 0.0, "matmul_int8": 0.0, "absmax_quantize_q8": 0.0,
                    "groupnorm_silu_bwd": (1 / 64,) * 3,
                    "adagn_silu_bwd": (1 / 64,) * 2, "conv3x3_dgrad": 1 / 64,
                    "conv3x3_dgrad_s2": 1 / 64, "conv3x3_wgrad": 1 / 64}}
CODE_SHARE = 1e-3
FLIP_SEEDS = 16
PER_RUN = {"bf16": "rollout", "int8": "rollout", "ac_step": "AC step",
           "denoiser_step": "denoiser step", "rew_end_step": "rew/end step",
           "mf_ac_step": "model-free AC step", "trainer": "trainer epoch",
           "ts_play_bf16": "two-stage play step", "ts_play_int8": "two-stage play step",
           "ts_up_step": "upsampler step", "ts_den_step": "two-stage denoiser step",
           "ts_trainer": "two-stage trainer epoch", "play_default_bf16": "play frame",
           "play_default_int8": "play frame", "play_csgo_bf16": "play frame",
           "play_csgo_int8": "play frame"}
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


def cuda_time_cold_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` call that finds nothing in L2: 256 MB written before
    each call (five times the L2), each call timed alone by CUDA events, the mean of
    ``reps``."""
    import torch

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def matmul_launch(args) -> str:
    """K6's launch plan on make_inputs' arguments, in a few words (ops/matmul_plan.py)."""
    from diamond_tpu_torch.ops.matmul_plan import describe, matmul_plan

    x, n, out_dtype = args[0], args[1].shape[1], args[5]
    k = x.shape[-1]
    return describe(matmul_plan(x.numel() // k, k, n, k, x.element_size(), out_dtype.itemsize,
                                x.data_ptr() % 16 == 0))


def cudnn_bf16_conv(x, w, b, stride):
    """The library's bf16 conv on the same NHWC data (cuDNN, channels-last), for scale."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    None if b is None else b.to(x.dtype), stride=stride, padding=1)


def library_call(name, args):
    """The one PyTorch call that computes the kernel's function, where there is one, as a
    yardstick: cuDNN's conv for K3, its data and weight gradients for K3's (stride 1 and
    2; the weight gradient's without the bias sum), F.group_norm for K2 without SiLU.
    None otherwise (the norms' backwards have their own, ``gn_autograd_ms``)."""
    import torch
    import torch.nn.functional as F

    if name == "conv3x3":
        return lambda: cudnn_bf16_conv(*args)
    if name == "groupnorm_silu" and not args[4]:
        x, scale, bias, g, _ = args
        return lambda: F.group_norm(x.permute(0, 3, 1, 2), g, scale.to(x.dtype),
                                    bias.to(x.dtype), eps=1e-5)
    if name in ("conv3x3_dgrad", "conv3x3_dgrad_s2"):
        dy, w, stride, (h, wd) = (args[0], args[1], 2, args[2]) if name.endswith("s2") else args
        return lambda: torch.nn.grad.conv2d_input((dy.shape[0], w.shape[2], h, wd),
                                                  w.permute(3, 2, 0, 1), dy.permute(0, 3, 1, 2),
                                                  stride=stride, padding=1)
    if name == "conv3x3_wgrad":  # the weight gradient alone: no single call adds the bias's
        x, dy, stride, _ = args
        return lambda: torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2),
                                                   (dy.shape[-1], x.shape[-1], 3, 3),
                                                   dy.permute(0, 3, 1, 2), stride=stride,
                                                   padding=1)
    if name == "matmul_int8":  # the int8 product alone, on codes made beforehand
        xq = matmul_codes(args[0], args[3])
        if int_mm_takes(*xq.shape, args[1].shape[1]):
            return lambda: torch._int_mm(xq, args[1])
    return None


def int_mm_takes(m: int, k: int, n: int) -> bool:
    """The shapes torch._int_mm takes on the card: more than 16 rows, K and N multiples
    of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def matmul_codes(x, act_max):
    """x's int8 codes with the static scales of act_max, as rows of K."""
    from diamond_tpu_torch import ops

    return ops.quantize_static(x, act_max).reshape(-1, x.shape[-1])


def old_matmul_route(x, w_q, w_scale, act_max, bias, out_dtype):
    """An int8 matmul site as it ran before K6: the quantize, torch._int_mm (float64 where
    it refuses the shape), the rescale, the cast and the bias in separate ops (a
    yardstick of what K6 replaced, timed in phase 7)."""
    import torch

    xq = matmul_codes(x, act_max)
    (m, k), n = xq.shape, w_q.shape[1]
    acc = torch._int_mm(xq, w_q) if int_mm_takes(m, k, n) else xq.double() @ w_q.double()
    y = (acc.float() * w_scale).reshape(*x.shape[:-1], n).to(out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def weight_codes(w):
    """The dynamic conv's per-output-channel weight codes and scales, as
    ``fused_q8.conv3x3_qtensor`` makes them."""
    import torch

    sw = w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8) / torch.full((), 127.0, device=w.device)
    return torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8), sw


def gn_autograd_ms(name, args) -> float:
    """The norms' backward yardstick: autograd of F.group_norm + the affine (K2: its
    learned one inside F.group_norm; K1: the FiLM rows, x̂ * (1 + scale_b) + shift_b) +
    F.silu (cuDNN-free native kernels) on the same x, affine and dy, channels-last; its
    device time is that of forward + backward less that of the forward, both
    graph-captured (the backward runs on the forward's stream, so the forward is
    captured with it)."""
    import torch
    import torch.nn.functional as F

    xr = args[0].permute(0, 3, 1, 2).detach().requires_grad_()
    dyr = args[1].permute(0, 3, 1, 2)
    g, silu = args[-3:-1]  # the moments last: autograd recomputes its own
    if name == "adagn_silu_bwd":
        c = args[0].shape[-1]
        ss = args[2].to(args[0].dtype).detach().requires_grad_()
        leaves = (xr, ss)

        def fwd():
            y = F.group_norm(xr, g, eps=1e-5)
            y = y * (1 + ss[:, :c, None, None]) + ss[:, c:, None, None]
            return F.silu(y) if silu else y
    else:
        sc = args[2].to(args[0].dtype).detach().requires_grad_()
        bi = args[3].to(args[0].dtype).detach().requires_grad_()
        leaves = (xr, sc, bi)

        def fwd():
            y = F.group_norm(xr, g, sc, bi, eps=1e-5)
            return F.silu(y) if silu else y

    with torch.enable_grad():
        both = cuda_time_ms(lambda: torch.autograd.grad(fwd(), leaves, dyr))
        return both - cuda_time_ms(fwd)


def bound(name, args):
    """(bytes time, operations time) in ms of one call: each input read once, each output
    written once, over HBM's rate; the operations the function needs over the peak of
    their type (f32 element-wise counts: statistics 3, normalize + affine 4, SiLU 4,
    quantize 4 per element; a conv 2 * M * Cout * 9 * Cin)."""
    import torch

    x = args[0]
    n, es = x.numel(), x.element_size()
    b, c = x.shape[0], x.shape[-1]
    small = sum(a.numel() * a.element_size() for a in args[1:] if isinstance(a, torch.Tensor))
    if name in ("groupnorm_silu_bwd", "adagn_silu_bwd"):
        # x, dy, (scale, bias | scale_shift), moments -> dx, (dscale, dbias | d_scale_shift)
        # in the affine's dtype; f32 element counts: x̂ and o 4, SiLU' 8, the sums 8, dx 5
        aff = args[2:4] if name == "groupnorm_silu_bwd" else args[2:3]
        mom = args[-1]
        ops = n * 25
        byts = (3 * n * es + 2 * sum(a.numel() * a.element_size() for a in aff)
                + mom.numel() * mom.element_size())
        kind = "f32_simt"
    elif name == "conv3x3_wgrad":  # x, dy (B, Ho, Wo, Cout), stride, bias -> dW, (db f32)
        dy, with_bias = args[1], args[3]
        cout = dy.shape[-1]
        ops = 2 * (dy.numel() // cout) * 9 * c * cout  # the products stride 2 needs
        byts = n * es + dy.numel() * es + 9 * c * cout * es + 4 * cout * with_bias
        kind = "bf16_tensor"
    elif name in ("conv3x3_dgrad", "conv3x3_dgrad_s2"):  # dy, w (3, 3, Cin, Cout), [stride,]
        w, (h, wd) = args[1], args[-1]                     # (H, W) -> dx (B, H, W, Cin)
        ops = 2 * (n // c) * 9 * w.shape[2] * c  # each dy pixel meets each tap once
        byts = n * es + w.numel() * w.element_size() + b * h * wd * w.shape[2] * es
        kind = "bf16_tensor"
    elif name in ("adagn_silu", "groupnorm_silu"):  # small: the FiLM rows or the affine
        silu = args[-1]
        ops = n * (3 + 4 + 4 * silu)
        byts = 2 * n * es + small
        kind = "f32_simt"
    elif name in ("adagn_silu_q8", "groupnorm_silu_q8"):  # small: also act_max
        ops = n * (3 + 4 + 4 + 4)
        byts = n * es + n + small
        kind = "f32_simt"
    elif name == "norm_affine_silu_q8":
        ops = n * (4 + 4 + 1 + 4)
        byts = n * es + 4 * b * c * 4 + n + b * 4
        kind = "f32_simt"
    elif name == "matmul_int8":  # x, w_q, w_scale, act_max, bias, out_dtype[, w_k]
        m, cout = n // c, args[1].shape[1]  # -> (..., N); w_k, w_q's copy, is not counted
        ops = 2 * m * cout * c
        byts = (n * es + m * cout * (2 if args[5] == torch.bfloat16 else 4)
                + sum(a.numel() * a.element_size() for a in args[1:5]
                      if isinstance(a, torch.Tensor)))
        kind = "int8_tensor"
    elif name == "absmax_quantize_q8":  # x -> int8 codes and the (B, 1) scale: max |x| 2,
        ops = n * (2 + 4)               # the quantize 4 per element
        byts = n * es + n + b * 4
        kind = "f32_simt"
    else:  # conv3x3 (x, w, bias, stride); conv3x3_int8 (x, w_q, w_scale, act_max, bias,
        #                                              stride, out_dtype, sample_scale)
        q8 = name == "conv3x3_int8"
        w, stride = args[1], args[5] if q8 else args[3]
        cin, cout = w.shape[2], w.shape[3]
        m = b * ((x.shape[1] - 1) // stride + 1) * ((x.shape[2] - 1) // stride + 1)
        ops = 2 * m * cout * 9 * cin
        out_es = (2 if args[6] == torch.bfloat16 else 4) if q8 else es
        small = [a for a in (args[2:5] + args[7:8] if q8 else args[2:3])
                 if isinstance(a, torch.Tensor)]  # scales, bias, act_max; not w_k
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
    if name == "conv3x3_wgrad":  # x's shape, Cout, stride, with the bias gradient
        shape, cout, stride, with_bias, _ = sig
        b, h, w, _ = shape
        return (rnd(*shape).to(dtype),
                rnd(b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout).to(dtype), stride,
                with_bias)
    if name == "conv3x3_dgrad_s2":  # dy's shape, the conv's Cin, its input's H and W
        shape, cin, hw, _ = sig
        w = ((torch.rand((3, 3, cin, shape[-1]), generator=gen, device=dev) * 2 - 1)
             / (9 * cin) ** 0.5).to(dtype)
        return (rnd(*shape).to(dtype), w, hw)
    if name == "conv3x3_dgrad":  # dy's shape, the conv's Cin, stride, its input's H and W
        shape, cin, stride, hw, _ = sig
        w = ((torch.rand((3, 3, cin, shape[-1]), generator=gen, device=dev) * 2 - 1)
             / (9 * cin) ** 0.5).to(dtype)
        return (rnd(*shape).to(dtype), w, stride, hw)
    if name == "groupnorm_silu_bwd":  # the moments last, as the K2 forward kernel wrote them
        shape, _, silu, _ = sig
        c, g = shape[-1], max(1, shape[-1] // 32)
        x, sc, bi = (2 * rnd(*shape) + 0.5).to(dtype), 1 + 0.1 * rnd(c), 0.1 * rnd(c)
        _, mom = ops.groupnorm_silu_with_moments(x, sc, bi, g, silu)
        return (x, rnd(*shape).to(dtype), sc, bi, g, silu, mom)
    if name == "adagn_silu_bwd":  # the FiLM rows in the run's dtype, as the model makes them;
        shape, _, silu, _ = sig   # the moments as the K1 forward kernel wrote them
        c, g = shape[-1], max(1, shape[-1] // 32)
        x, ss = (2 * rnd(*shape) + 0.5).to(dtype), (0.5 * rnd(shape[0], 2 * c)).to(dtype)
        _, mom = ops.adagn_silu_with_moments(x, ss, g, silu)
        return (x, rnd(*shape).to(dtype), ss, g, silu, mom)
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
        # the K-major weight copy last, made once as the int8 sites make it at install
        return (x, wq, ws, am, 0.1 * rnd(cout) if has_bias else None, stride, dtype, ss,
                ops.kmajor_weights(wq))
    if name == "matmul_int8":  # x's shape and dtype, N, bias, out dtype; as the path ran
        shape, x_dtype, cout, has_bias, out_dtype = sig  # it, or x and y in dtype
        x_dt = getattr(torch, x_dtype.split(".")[1]) if out_dtype == str(dtype) else dtype
        x = rnd(*shape).to(x_dt)
        am = x.float().abs().reshape(-1, shape[-1]).amax(dim=0) * 0.95
        wq = torch.randint(-127, 128, (shape[-1], cout), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(cout, generator=gen, device=dev) * 1e-3 + 1e-4
        # the K-major weight copy last, made once as the int8 sites make it at install
        return (x, wq, ws, am, 0.1 * rnd(cout) if has_bias else None, dtype,
                ops.kmajor_2d(wq))
    if name == "absmax_quantize_q8":  # x's shape, Cout and stride of the conv it feeds:
        shape, _, cout, stride = sig  # x, and the conv's weight and stride
        w = rnd(3, 3, shape[-1], cout) / (9 * shape[-1]) ** 0.5
        return ((3 * rnd(*shape)).to(dtype), w, stride)
    shape, _, *silu = sig
    c = shape[-1]
    x = (2 * rnd(*shape) + 0.5).to(dtype)
    g = max(1, c // 32)
    if name in ("adagn_silu", "adagn_silu_q8"):
        ss = (0.5 * rnd(shape[0], 2 * c)).to(dtype)  # the FiLM linear's output dtype
        if name == "adagn_silu":
            return (x, ss, g, silu[0])
        am = ops.adagn_silu_plain(x, ss, g).float().abs().amax(dim=(0, 1, 2)) * 0.95
        return (x, ss, g, am)
    scale, bias = 1 + 0.1 * rnd(c), 0.1 * rnd(c)
    if name == "groupnorm_silu":
        return (x, scale, bias, g, silu[0])
    am = ops.groupnorm_silu_plain(x, scale, bias, g).float().abs().amax(dim=(0, 1, 2)) * 0.95
    return (x, scale, bias, g, am)


def code_err(flips: tuple, numel: int, what: str) -> float:
    """Largest code difference, from ``ops.code_flips``' (largest, count, margin); fails
    on more than one, on an element that differs farther than one unit from its code
    boundary, or in more than CODE_SHARE of the elements (and more than one element).
    Keeps the count and the margin in code_err.flips and code_err.margin."""
    most, n, margin = flips
    check(most <= 1 and margin <= 1 and n <= max(1, CODE_SHARE * numel),
          f"{what}: codes differ by up to {most} in {n} of {numel} elements, the farthest "
          f"{margin:.3g} units from its code boundary")
    code_err.flips, code_err.margin = n, margin
    return float(most)


def static_flips(name, y, ref, args) -> tuple:
    """``ops.static_code_flips`` of a static-epilogue K4 call."""
    from diamond_tpu_torch import ops

    plain = ops.adagn_silu_plain if name == "adagn_silu_q8" else ops.groupnorm_silu_plain
    return ops.static_code_flips(y, ref, plain, *args[:-1], act_max=args[-1])


def plain_args(name, args):
    """The arguments of the plain version: K5's and K6's take no K-major weight copy."""
    return args[:8] if name == "conv3x3_int8" else args[:6] if name == "matmul_int8" else args


def kernel_fns(name):
    """(kernel, plain) of a KERNELS entry, both called with make_inputs' arguments: K7's
    quantize takes x alone (the conv's weight and stride ride along for compare_one)."""
    from diamond_tpu_torch import ops

    if name == "absmax_quantize_q8":
        return (lambda x, w, s: ops.absmax_quantize_q8(x),
                lambda x, w, s: ops.absmax_quantize_q8_plain(x))
    return getattr(ops, name), getattr(ops, name + "_plain")


def norm_launch(name, args) -> tuple:
    """(n, blocks) of a norm kernel's launch plan on the rollout's inputs, as this card
    launches it: the blocks per sample's cluster and the grid."""
    from diamond_tpu_torch.ops.fused_norms import launch_plan
    from diamond_tpu_torch.ops.norm_plan import bwd_plan

    if name in ("groupnorm_silu_bwd", "adagn_silu_bwd"):  # the backward's own plan
        x, g = args[0], args[-3]
        b, h, w, c = x.shape
        p = bwd_plan(b, h * w, c, g, x.element_size())
        return p.n, p.blocks
    x, g = args[0], args[2] if name.startswith("adagn") else args[3]
    p = launch_plan(x, g, name, name.endswith("_q8"))
    return p.n, p.blocks


def conv_blocks(name, args) -> int:
    """The blocks a 3x3 conv kernel launches on the rollout's inputs (K3 bf16, K5): its
    launch plan's grid."""
    import torch
    from diamond_tpu_torch.ops import conv_plan

    x = args[0]
    b, h, w, cin = x.shape
    if name == "conv3x3_wgrad":
        return conv_plan.wgrad_plan(b, h, w, cin, args[1].shape[-1], args[2]).grid
    if name == "conv3x3_dgrad":  # K3 on dy with the flipped kernel
        return conv_plan.k3_plan(b, h, w, cin, args[1].shape[2], 1).grid
    if name == "conv3x3_dgrad_s2":
        return conv_plan.dgrad_s2_plan(b, *args[2], args[1].shape[2], cin).grid
    if name == "conv3x3_int8":
        return conv_plan.k5_plan(b, h, w, cin, args[1].shape[-1], args[5],
                                 x.dtype == torch.int8).grid
    return conv_plan.k3_plan(b, h, w, cin, args[1].shape[-1], args[3]).grid


def moments_err(x, moments, g) -> float:
    """The moments a K1/K2 forward kernel wrote (its mean and 1/std per sample and group)
    against the plain ones (``group_moments``, f32): within MOMENTS_TOL of max(1, their
    largest |value|)."""
    import torch
    from diamond_tpu_torch import ops

    ref = ops.group_moments(x, g)
    scale = max(1.0, ref.abs().max().item())
    e = (moments - ref).abs().max().item()
    check(bool(torch.isfinite(moments).all()) and e <= MOMENTS_TOL * scale,
          f"moments of {tuple(x.shape)} {x.dtype}: max abs err {e} > {MOMENTS_TOL} * {scale}")
    return e


def compare_one(name, kernel, plain, args, dt_name):
    """Run kernel and plain version on args; check; return the max abs error. K1/K2: the
    forward that also writes the moments gives the same bits, and its moments agree with
    the plain ones; their backwards: the moments they are given (the forward kernel's)
    too (``compare_one.moments_err``)."""
    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.ops import quant

    y, ref = kernel(*args), plain(*plain_args(name, args))
    torch.cuda.synchronize()
    # (an older checkout, timed by scripts/time_norms.py, has no moments)
    with_moments = getattr(ops, name.replace("_bwd", "") + "_with_moments", None)
    if name in ("adagn_silu", "groupnorm_silu") and with_moments:  # y and the moments
        y_m, mom = with_moments(*args)
        torch.cuda.synchronize()
        check(torch.equal(y_m, y), f"{name} {dt_name}: writing the moments changed y")
        compare_one.moments_err = moments_err(args[0], mom, args[-2])
    if name in ("groupnorm_silu_bwd", "adagn_silu_bwd") and with_moments:
        compare_one.moments_err = moments_err(args[0], args[-1], args[-3])
    if name in REPEATS:  # a fixed order: the same bits again
        again = kernel(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(*(
            (v,) if isinstance(v, torch.Tensor) else v for v in (y, again)))),
            f"{name} {dt_name}: two calls differ")
    if name in ("groupnorm_silu_bwd", "adagn_silu_bwd"):  # dx, then the affine's gradient
        parts = ("dx", "dscale", "dbias") if name == "groupnorm_silu_bwd" else (
            "dx", "d_scale_shift")
        err, compare_one.tol_share = 0.0, 0.0
        for part, a, r, tol in zip(parts, y, ref, TOL[dt_name][name]):
            scale = max(1.0, r.float().abs().max().item())
            e = (a.float() - r.float()).abs().max().item()
            check(bool(torch.isfinite(a).all()) and e <= tol * scale,
                  f"{name} {dt_name} {part}: max abs err {e} > {tol} * {scale}")
            err = max(err, e)
            compare_one.tol_share = max(compare_one.tol_share, e / (tol * scale))
        return err
    if name == "conv3x3_wgrad" and args[3]:  # (dW, db): db against dy's f32 sum
        y, db = y
        ref, ref_db = ref
        scale = max(1.0, ref_db.abs().max().item())
        e_db = (db - ref_db).abs().max().item()
        check(bool(torch.isfinite(db).all()) and e_db <= DB_TOL * scale,
              f"{name} {dt_name} db: max abs err {e_db} > {DB_TOL} * {scale}")
        compare_one.db_err = e_db
    if name == "absmax_quantize_q8":  # codes, sx, then the conv through K5, all exact
        x, w, stride = args
        check(torch.equal(y.q, ref.q) and torch.equal(y.scale, ref.scale),
              f"{name} {dt_name}: codes or scale differ from the plain version's")
        check(bool((ref.scale == ref.scale[0]).all()), f"{name}: the scale is not one sx")
        wq, sw = weight_codes(w)
        conv = quant.conv3x3_q8(x, w, stride)
        conv_ref = ops.conv3x3_int8_plain(ref.q, wq, sw, stride=stride, sample_scale=ref.scale)
        torch.cuda.synchronize()
        check(torch.equal(conv, conv_ref), f"quant.conv3x3_q8 {dt_name}: the conv differs "
              "from the plain conv of the plain codes")
        return 0.0
    if name in ("adagn_silu_q8", "groupnorm_silu_q8"):
        # the static epilogue equals quantize(K1/K2 kernel output) code for code
        base = ops.adagn_silu if name == "adagn_silu_q8" else ops.groupnorm_silu
        check(torch.equal(y, ops.quantize_static(base(*args[:-1]), args[-1])),
              f"{name}: codes differ from quantize({base.__name__} kernel)")
        return code_err(static_flips(name, y, ref, args), y.numel(), f"{name} {dt_name}")
    check(bool(torch.isfinite(y.float()).all()), f"{name} {dt_name}: non-finite")
    scale = max(1.0, ref.float().abs().max().item())
    e = (y.float() - ref.float()).abs().max().item()
    check(e <= TOL[dt_name][name] * scale,
          f"{name} {dt_name}: max abs err {e} > {TOL[dt_name][name]} * {scale}")
    return e


compare_one.db_err = None  # the bias gradient's error of the last weight-gradient call
compare_one.moments_err = None  # the saved moments' error of the last K1/K2 call
compare_one.tol_share = None  # the norm backwards' largest error as a share of its limit


def _zero_totals() -> dict:
    return dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, library_ms=0.0,
                ms_where_library=0.0, cudnn_bf16_ms=0.0, per_sample_ms=0.0,
                per_sample_plain_ms=0.0, old_route_ms=0.0, conv_ms=0.0, whole_ms=0.0,
                has_library=False)


def compare_kernels(shapes, launches, runs):
    """Each kernel against its plain version at the recorded signatures of its paths (as
    the paths ran them, and the same shapes in f32), timed, with its bound and library
    yardstick; times and bounds per run of each path (a rollout, or a train step:
    ``runs`` holds the runs each path's counts were taken over) weight each signature
    by its calls there. A kernel's entry reports its first path, and every path in
    ``by_path``. K4's per-sample epilogue runs at the int8 path's AdaGN shapes. A kernel
    on no path runs at its DRIVEN_ONLY signatures, one call each, and reports 0 launches.
    Returns the JSON rows and the per-signature details."""
    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.ops import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, details = [], []
    for name, (source, replaces, paths) in KERNELS.items():
        kernel, plain = kernel_fns(name)
        err = {"float32": 0.0, "bfloat16": 0.0}
        tots = {p: _zero_totals() for p in paths or ("kernel",)}
        calls = {}  # signature -> {path: calls per run}
        for p in paths:
            for sig, count in shapes[p][name].items():
                calls.setdefault(sig, {})[p] = count / runs[p]
        for sig in DRIVEN_ONLY.get(name, ()):
            calls[sig] = {"kernel": 1.0}
        for sig, per_run in sorted(calls.items(), key=lambda kv: str(kv[0])):
            # the dtype as the path ran it: the output's for the convs and the product
            run_dtype = sig[-1] if name.startswith("conv") or name == "matmul_int8" else sig[1]
            for dt_name in ("bfloat16", "float32"):
                as_run = run_dtype == f"torch.{dt_name}"
                args = make_inputs(name, sig, getattr(torch, dt_name), gen)
                compare_one.db_err = compare_one.moments_err = compare_one.tol_share = None
                e = compare_one(name, kernel, plain, args, dt_name)
                err[dt_name] = max(err[dt_name], e)
                t_k = cuda_time_ms(lambda: kernel(*args))
                t_p = cuda_time_ms(lambda: plain(*plain_args(name, args)))
                row = dict(kernel=name, signature=str(sig), dtype=dt_name, calls_per_run=per_run,
                           max_abs_err=e, ms=t_k, plain_ms=t_p)
                if compare_one.db_err is not None:
                    row["db_err"] = compare_one.db_err
                if compare_one.moments_err is not None:
                    row["moments_err"] = compare_one.moments_err
                if compare_one.tol_share is not None:
                    row["tol_share"] = compare_one.tol_share
                if name in ("adagn_silu_q8", "groupnorm_silu_q8"):
                    row.update(code_flips=code_err.flips, code_margin=code_err.margin)
                    if args[0].numel() < 1 / CODE_SHARE:  # one flip allowed: more inputs
                        seen = [(code_err.flips, code_err.margin)]
                        for _ in range(FLIP_SEEDS):
                            compare_one(name, kernel, plain,
                                        make_inputs(name, sig, getattr(torch, dt_name), gen),
                                        dt_name)
                            seen.append((code_err.flips, code_err.margin))
                        row["seed_flips"] = [f for f, _ in seen]
                        row["seed_margin"] = max(m for _, m in seen)
                        log(f"[kernel] {name} {sig} {dt_name}: codes differ in "
                            f"{sum(f > 0 for f, _ in seen)} of {len(seen)} inputs of "
                            f"{args[0].numel()} elements ({sum(f for f, _ in seen)} "
                            f"element(s) in all), the farthest {row['seed_margin']:.3g} "
                            f"units from its code boundary")
                if as_run:  # the path's dtype: weight by its call count
                    t_b, t_o = bound(name, plain_args(name, args))
                    row.update(bytes_ms=t_b, ops_ms=t_o, bound_ms=max(t_b, t_o))
                    lib = library_call(name, args)
                    if lib is not None or name in ("groupnorm_silu_bwd", "adagn_silu_bwd"):
                        row["library_ms"] = (gn_autograd_ms(name, args) if lib is None
                                             else cuda_time_ms(lib))
                    if name == "conv3x3_int8":
                        x, wq, ws, am, bias, stride = args[:6]
                        xb = (x.float() if x.dtype == torch.int8 else x).to(torch.bfloat16)
                        wb = wq.to(torch.bfloat16)
                        row["cudnn_bf16_ms"] = cuda_time_ms(
                            lambda: cudnn_bf16_conv(xb, wb, bias, stride))
                    if name == "matmul_int8":  # the separate ops K6 replaced
                        row["old_route_ms"] = cuda_time_ms(
                            lambda: old_matmul_route(*plain_args(name, args)))
                    if name == "absmax_quantize_q8":  # K5 on the codes; the whole conv
                        x, w, stride = args
                        qt, (wq, sw) = ops.absmax_quantize_q8(x), weight_codes(w)
                        wk = ops.kmajor_weights(wq)
                        row["conv_ms"] = cuda_time_ms(lambda: ops.conv3x3_int8(
                            qt.q, wq, sw, stride=stride, sample_scale=qt.scale, w_k=wk))
                        row["whole_ms"] = cuda_time_ms(lambda: quant.conv3x3_q8(x, w, stride))
                    row["bound_share"] = row["bound_ms"] / t_k
                    if name.startswith("conv"):  # ratio to cuDNN, blocks
                        row["vs_library"] = t_k / row.get("library_ms", row.get("cudnn_bf16_ms"))
                        row["blocks"] = conv_blocks(name, args)
                    elif name == "matmul_int8":  # its plan; ratio to _int_mm; the 64² cold
                        row["plan"] = matmul_launch(args)
                        if "library_ms" in row:
                            row["vs_library"] = t_k / row["library_ms"]
                        if args[0].numel() // args[0].shape[-1] >= COLD_ROWS:
                            row["cold_ms"] = cuda_time_cold_ms(lambda: kernel(*args))
                    elif name == "absmax_quantize_q8":  # each of its two grids
                        row["blocks"] = min(1024, -(-args[0].numel() // (
                            4 * 256 * (16 // args[0].element_size()))))
                    else:  # the norm's cluster size and blocks
                        row["cluster"], row["blocks"] = norm_launch(name, args)
                if name == "adagn_silu_q8":  # K4's per-sample epilogue at the same shapes
                    x, ss, g, _ = args
                    c, ss = x.shape[-1], ss.float()  # its rows in f32, as it takes them
                    mean_c, inv_c = ops.group_stats_channels(x, g)
                    pargs = (x, mean_c, inv_c, 1 + ss[:, :c], ss[:, c:])
                    qt, ref = ops.norm_affine_silu_q8(*pargs), ops.norm_affine_silu_q8_plain(*pargs)
                    torch.cuda.synchronize()
                    rel = ((qt.scale - ref.scale).abs() / ref.scale).max().item()
                    check(rel <= 1e-5, f"norm_affine_silu_q8 {sig}: scale rel err {rel}")
                    row["per_sample_code_err"] = code_err(
                        ops.per_sample_code_flips(qt, ref, *pargs), qt.q.numel(),
                        f"norm_affine_silu_q8 {sig} {dt_name}")
                    row["per_sample_code_flips"] = code_err.flips
                    row["per_sample_code_margin"] = code_err.margin
                    row["per_sample_ms"] = cuda_time_ms(lambda: ops.norm_affine_silu_q8(*pargs))
                    row["per_sample_plain_ms"] = cuda_time_ms(
                        lambda: ops.norm_affine_silu_q8_plain(*pargs))
                    pb, po = bound("norm_affine_silu_q8", pargs)
                    row["per_sample_bound_ms"] = max(pb, po)
                if as_run:
                    for p, w in per_run.items():
                        tot = tots[p]
                        for k, v in (("ms", t_k), ("plain_ms", t_p), ("bytes_ms", row["bytes_ms"]),
                                     ("ops_ms", row["ops_ms"]), ("bound_ms", row["bound_ms"]),
                                     ("cudnn_bf16_ms", row.get("cudnn_bf16_ms", 0.0)),
                                     ("old_route_ms", row.get("old_route_ms", 0.0)),
                                     ("conv_ms", row.get("conv_ms", 0.0)),
                                     ("whole_ms", row.get("whole_ms", 0.0)),
                                     ("per_sample_ms", row.get("per_sample_ms", 0.0)),
                                     ("per_sample_plain_ms", row.get("per_sample_plain_ms", 0.0))):
                            tot[k] += w * v
                        if "library_ms" in row:
                            tot["has_library"] = True
                            tot["library_ms"] += w * row["library_ms"]
                            tot["ms_where_library"] += w * t_k
                details.append(row)
                log(f"[compare] {name} {sig} {dt_name}: err {e:.3g} kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms" + "".join(f" {k} {row[k]:.4f}" for k in (
                        "bound_ms", "library_ms", "cudnn_bf16_ms", "old_route_ms", "conv_ms",
                        "whole_ms", "per_sample_ms", "vs_library", "bound_share", "cold_ms")
                        if k in row)
                    + (f" db_err {row['db_err']:.3g}" if "db_err" in row else "")
                    + (f" moments_err {row['moments_err']:.3g}" if "moments_err" in row else "")
                    + (f" tol_share {row['tol_share']:.3g}" if "tol_share" in row else "")
                    + (f" cluster {row['cluster']}" if "cluster" in row else "")
                    + (f" blocks {row['blocks']}" if "blocks" in row else "")
                    + (f" plan: {row['plan']}" if "plan" in row else ""))
        by_path = {p: dict(launches=launches[p][name], ms=t["ms"], plain_ms=t["plain_ms"],
                           bound_ms=t["bound_ms"],
                           library_ms=t["library_ms"] if t["has_library"] else None,
                           shapes=len(shapes[p][name]))
                   for p, t in tots.items() if p in paths}
        for p in by_path:  # the two-stage and play paths' shapes, each with its launches
            if p.startswith(("ts_", "play_")):
                by_path[p]["shape_launches"] = {str(sig): c for sig, c in shapes[p][name].items()}
        path = paths[0] if paths else None
        tot = tots[path or "kernel"]
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=launches[path][name] if path else 0,
                     max_abs_err=err["bfloat16"],
                     ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                     bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
                     library_ms=tot["library_ms"] if tot["has_library"] else None,
                     max_abs_err_f32=err["float32"], path=path,
                     launches_by_path={p: launches[p][name] for p in launches},
                     per=PER_RUN[path] if path else "call at each of its shapes, summed",
                     shapes=len(shapes[path][name]) if path else len(DRIVEN_ONLY[name]),
                     by_path=by_path)
        if tot["has_library"] and name == "groupnorm_silu":
            entry["library_covers"] = "silu=False calls only"
            entry["ms_where_library"] = tot["ms_where_library"]
        if name == "conv3x3_int8":
            entry["cudnn_bf16_ms"] = tot["cudnn_bf16_ms"]  # a bf16 conv, not the int8 one
        if name == "matmul_int8":  # torch._int_mm where it takes the shape; the old route
            entry["library_covers"] = "shapes torch._int_mm takes (the int8 product alone)"
            entry["ms_where_library"] = tot["ms_where_library"]
            entry["old_route_ms"] = tot["old_route_ms"]
        if name == "absmax_quantize_q8":  # K5 on its codes, and quant.conv3x3_q8 whole
            entry["conv_ms"], entry["whole_ms"] = tot["conv_ms"], tot["whole_ms"]
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


def profile_run(fn, label, what) -> dict:
    """One ``fn()`` (a rollout, or a train step) under torch.profiler: device busy time
    (the sum of its kernels' times; one stream, so they do not overlap) against the wall
    time, the kernel launch calls, and the kernels by time. A CPU-side annotation that
    covers device work (the optimizer's ``Optimizer.step#...``) also shows as a device
    event of its own name, spanning kernels already counted: such spans are reported,
    not summed. The profiler slows the host, so the idle share it shows is an upper
    bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cpu_keys = {e.key for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = {e.key: e.self_device_time_total / 1e3 for e in device if e.key in cpu_keys}
    kernels = sorted((e for e in device if e.key not in cpu_keys),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    # the port's autograd Functions' backward nodes: CPU µs per call, with what they run
    functions = {e.key: dict(calls=e.count, cpu_us=e.cpu_time_total / e.count)
                 for e in events if e.count and "Backward" in e.key
                 and any(f in e.key for f in ("Conv3x3Fn", "GroupNormSiLU"))}
    conv_bwd_ops = ops_under(prof.events(), "Conv3x3FnBackward")
    norm_bwd_ops = {node: dict(ops_under(prof.events(), node))
                    for node in ("AdaGroupNormSiLUBackward", "GroupNormSiLUBackward")}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"chip_smoke_profile_{label}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] {label} {what}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {launches} kernel launch calls "
        f"(cudaLaunchKernel + cudaLaunchKernelExC)")
    for e in kernels[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x {e.key[:90]}")
    for k, v in spans.items():
        log(f"[profile]   not summed: {k}, a span of {v:.2f} ms over kernels counted above")
    for k, v in functions.items():
        log(f"[profile]   {k}: {v['calls']} calls, {v['cpu_us']:.1f} µs of CPU per call")
    aten = {e.key: e.count for e in events
            if e.device_type == DeviceType.CPU and e.key.startswith("aten::")}
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=launches, functions=functions,
                aten=aten, annotation_spans_ms=spans, conv_bwd_ops=dict(conv_bwd_ops),
                norm_bwd_ops=norm_bwd_ops,
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels[:12]])


def int8_sites_ops(results: dict, smi: str) -> None:
    """The profiled int8 rollout against the bf16 one: its matmul sites run through K6
    alone, so no torch._int_mm, and no more round or clamp ops than the bf16 rollout
    (whose only ones snap frames to the uint8 grid); its launch calls and device busy
    beside INT8_ROLLOUT_BEFORE."""
    p8, p16 = results["int8"]["profile"], results["bf16"]["profile"]
    a8, a16 = p8["aten"], p16["aten"]
    check(a8.get("aten::_int_mm", 0) == 0, "the int8 rollout ran torch._int_mm")
    for op in ("aten::round", "aten::clamp"):
        check(a8.get(op, 0) == a16.get(op, 0), f"the int8 rollout ran {a8.get(op, 0)} {op}, "
              f"the bf16 rollout {a16.get(op, 0)}: an int8 site quantized outside its kernel")
    k6 = results["int8"]["launches"]["matmul_int8"] / (1 + TIMED_ROLLOUTS)
    before, busy_before = INT8_ROLLOUT_BEFORE
    log(f"[profile]   int8 rollout: {p8['launches']} kernel launch calls ({before} with the "
        f"matmul sites' separate ops: {before - p8['launches']} fewer over {k6:g} K6 calls, "
        f"{(before - p8['launches']) / k6:.1f} a call), device busy {p8['busy_ms']:.1f} ms "
        f"({busy_before} ms before); no aten::_int_mm; aten::round {a8.get('aten::round', 0)}"
        f" and aten::clamp {a8.get('aten::clamp', 0)}, as in the bf16 rollout; on {smi}")


def int8_site_host_costs(smi: str) -> dict:
    """Host µs per call of an int8 1x1 site (K6) beside the same site in bf16, K6's
    wrapper alone, the separate ops K6 replaced and torch._int_mm alone, at the rollout's
    8x8 up-path projection (32 x 8 x 8 x 128 -> 64) and the csgo play's 4x4 one (1 x 4 x 4
    x 128 -> 64), where the device's work is a few µs: what a site costs the host, which
    bounds the rollouts that leave the device idle. A figure, not a check."""
    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.models.blocks import Conv1x1
    from diamond_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(SEED + 7)
    out = {}
    for shape in ((32, 8, 8, 128), (1, 4, 4, 128)):
        k, n = shape[-1], 64
        x = torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
        site, plain_site = Conv1x1(k, n, torch.bfloat16), Conv1x1(k, n, torch.bfloat16)
        for m in (site, plain_site):
            with torch.no_grad():
                m.kernel.copy_(torch.randn(m.kernel.shape, generator=g) / k ** 0.5)
                m.bias.copy_(torch.randn(n, generator=g) / 10)
            m.cuda()
        am = x.float().abs().reshape(-1, k).amax(dim=0)
        quant.install(site, dict(zip(("w_q", "w_scale"),
                                     quant.fold_quantize_weight(site.kernel[0, 0], am)),
                                 act_scale=am))
        args = (x, site.w_q, site.w_scale, am, site.bias, torch.bfloat16)
        xq = ops.quantize_static(x, am).reshape(-1, k)
        pieces = {"int8 site (K6)": lambda: site(x),
                  "bf16 site": lambda: plain_site(x),
                  "matmul_int8 alone": lambda: ops.matmul_int8(*args, w_k=site.w_k),
                  "the separate ops K6 replaced": lambda: old_matmul_route(*args)}
        if int_mm_takes(*xq.shape, n):
            pieces["torch._int_mm alone"] = lambda: torch._int_mm(xq, site.w_q)
        res = {}
        with quant.int8_scope(True):
            for key, fn in pieces.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                res[key] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
        out[str(shape)] = res
        log(f"[host] int8 1x1 site {shape} -> {n}, CPU µs per call: "
            + ", ".join(f"{key} {v:.1f}" for key, v in res.items()) + f"; on {smi}")
    return out


def log_unprofiled_idle(profile: dict, step_ms: float, what: str) -> None:
    """The idle share of a train step: the profiled step's device busy time against the
    unprofiled step's mean host-clock time (the profiler slows the host, not the kernels)."""
    log(f"[profile]   {what}: idle {100 * (1 - profile['busy_ms'] / step_ms):.1f} % against "
        f"the unprofiled {step_ms:.1f} ms per step")


def ops_under(events, name: str) -> Counter:
    """The operators run inside every profiled event named ``name`` (e.g. an autograd
    Function's backward node), counted by name over all their descendants."""
    seen, out = set(), Counter()

    def walk(e):
        for c in e.cpu_children:
            if id(c) not in seen:
                seen.add(id(c))
                out[c.name] += 1
                walk(c)

    for e in events:
        if e.name == name and id(e) not in seen:
            seen.add(id(e))
            walk(e)
    return out


def check_conv_backward(profile: dict, dgrad_s1: float, what: str) -> None:
    """Under the conv's backward on the CUDA path: no bias reduction (the weight-gradient
    kernel sums dy), no zero interleave (stride 2 has kernels of its own) and no flip but
    the stride-1 data gradient's, one per call."""
    ops = profile["conv_bwd_ops"]
    check(ops.get("aten::flip", 0) == dgrad_s1,
          f"{what}: {ops.get('aten::flip', 0)} kernel flips under the conv backward, "
          f"{dgrad_s1} stride-1 data gradients")
    for op in ("aten::sum", "aten::new_zeros", "aten::zeros"):
        check(ops.get(op, 0) == 0, f"{what}: {op} ran under the conv backward")
    log(f"[profile]   under Conv3x3FnBackward: {ops.get('aten::flip', 0)} flips (one per "
        f"stride-1 data gradient), no bias sum, no zero interleave")


def norm_bwd_removed_launches(launches: dict, shapes: dict, steps: int) -> float:
    """The kernel launches per train step that the norm backwards no longer make: K2's
    second launch (the fixed-order sum of its blocks' partials) per call, and per call of
    either whose affine or FiLM rows are not f32 the cast of its f32 gradient to them."""
    casts = sum(n for name in ("adagn_silu_bwd", "groupnorm_silu_bwd")
                for sig, n in shapes[name].items() if sig[-1] != "torch.float32")
    return (launches["groupnorm_silu_bwd"] + casts) / steps


def check_norm_backward(profile: dict, what: str) -> None:
    """Under the norm backwards' autograd nodes no cast and no sum: the kernel's one
    launch gives the gradient of the affine or of the FiLM rows in their dtype."""
    for node, ops in profile["norm_bwd_ops"].items():
        for op in ("aten::to", "aten::_to_copy", "aten::sum"):
            check(ops.get(op, 0) == 0, f"{what}: {op} ran under {node}")
    log("[profile]   under the norm backwards' nodes: no cast and no sum")


def drive(engine, st, pool, gen, label, smi):
    """The main path of one dtype: every launch count set to 0, one warm-up and the timed
    rollouts, the counts and call signatures read. Returns (traj, st, pool, signatures,
    result)."""
    import torch
    from diamond_tpu_torch import ops

    count_reset()
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
    for name, (_, _, paths) in KERNELS.items():
        if label in paths:
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


def sync_points(fn) -> dict:
    """One ``fn()`` (a rollout, or an AC step) under torch.cuda's sync debug mode: the
    host-device synchronisations it makes, by the line of Python that made them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:  # (not the note, once a process, that the mode is a prototype)
        if "synchroniz" in str(w.message) and "prototype" not in str(w.message):
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


def count_reset() -> None:
    from diamond_tpu_torch import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0
        getattr(ops, name).shapes.clear()


def ac_step_phase(engine, agent, st, pool, gen, smi):
    """The actor-critic train step as the trainer calls it (training.make_ac_train_step
    with the trainer config's optimizer and loss, warmup 0 so the first step moves the
    weights), on the int8-calibrated world model: counts set to 0, one warm-up step and
    AC_STEPS timed ones, counts read; then one step profiled and one under the sync debug
    mode. Returns (st, pool, signatures, result)."""
    from dataclasses import replace

    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.training import OptimizerSpec, TrainState, make_ac_train_step

    tcfg = TrainerConfig().actor_critic
    spec = replace(OptimizerSpec.from_cfg(tcfg.optimizer, tcfg.training), lr_warmup_steps=0)
    tx = spec.build()
    ac = agent.actor_critic
    state = TrainState.create(ac.net, tx)
    step = make_ac_train_step(engine, ac, tx, tcfg.actor_critic_loss)
    wm = [agent.denoiser.inner_model, agent.rew_end_model.net]
    wm_before = [{n: p.detach().clone() for n, p in net.named_parameters()} for net in wm]
    ac_before = {n: p.detach().clone() for n, p in ac.net.named_parameters()}
    horizon = tcfg.actor_critic_loss.backup_every

    count_reset()
    state, st, pool, m = step(state, st, pool, generator=gen)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v)) for v in m.values()), f"AC step: non-finite metrics {m}")
    moved = sum(not torch.equal(p.detach(), ac_before[n]) for n, p in ac.net.named_parameters())
    check(moved == len(ac_before), f"AC step: {len(ac_before) - moved} actor-critic tensors "
          "did not change")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(AC_STEPS):
        state, st, pool, m = step(state, st, pool, generator=gen)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / AC_STEPS
    peak = torch.cuda.max_memory_allocated()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    metrics = {k: v.item() for k, v in m.items()}
    check(all(map(math.isfinite, metrics.values())), f"AC step: non-finite metrics {metrics}")
    for name in BACKWARD:
        check(launches[name] > 0, f"{name} was not launched by the AC step")
    for net, before in zip(wm, wm_before):
        for n, p in net.named_parameters():
            check(p.grad is None and torch.equal(p.detach(), before[n]),
                  f"AC step: world-model parameter {n} changed or has a gradient")
    fps = BATCH * horizon / secs
    log(f"[ac_step] B={BATCH} T={horizon}, int8 world model, bf16 actor-critic: "
        f"{secs * 1e3:.1f} ms per step, {fps:.1f} training env_frames/s over {AC_STEPS} steps "
        f"after one warm-up, peak memory {peak / 2**30:.2f} GiB, on {smi}")
    log(f"[ac_step] metrics of the last step: "
        + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    log(f"[launches] ac_step, over {1 + AC_STEPS} steps: {launches}")
    with torch.no_grad():
        moved = max((p - ac_before[n]).abs().max().item() for n, p in ac.net.named_parameters())

    profile = profile_run(lambda: step(state, st, pool, generator=gen), "ac_step", "AC step")
    log_unprofiled_idle(profile, secs * 1e3, "AC step")
    check(launches["conv3x3_dgrad_s2"] == 0, "AC step: a stride-2 data gradient ran")
    check_conv_backward(profile, launches["conv3x3_dgrad"] / (1 + AC_STEPS), "AC step")
    check_norm_backward(profile, "AC step")
    removed = norm_bwd_removed_launches(launches, shapes, 1 + AC_STEPS)
    most = AC_LAUNCH_CALLS_BEFORE - removed
    check(profile["launches"] <= most, f"AC step: {profile['launches']} kernel launch calls, "
          f"more than {most:g}: {AC_LAUNCH_CALLS_BEFORE} less the norm backwards' removed")
    log(f"[profile]   {profile['launches']} kernel launch calls per AC step: at most {most:g} "
        f"({AC_LAUNCH_CALLS_BEFORE} less {removed:g} K2 sums and casts)")
    syncs = sync_points(lambda: step(state, st, pool, generator=gen))
    log(f"[sync] AC step: {sum(syncs.values())} host-device synchronisations {syncs}")
    return st, pool, shapes, dict(step_ms=secs * 1e3, fps=fps, peak_memory_bytes=peak,
                                  launches=launches, metrics=metrics, profile=profile,
                                  sync_points=syncs, max_weight_change=moved,
                                  steps=1 + AC_STEPS)


def ac_gradient_check(agent):
    """The actor-critic's trunk + head gradient of a probe loss on the same full-size
    frames and carries, f32 with TF32 off: the card (K2's backward, K3's data and weight
    gradients) against the CPU's plain path. Every parameter's gradient within 1e-3 of
    the CPU leaf's largest |value|."""
    import torch
    from diamond_tpu_torch.models.actor_critic import ActorCritic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = agent.cfg.actor_critic
    g = torch.Generator().manual_seed(SEED + 3)
    b = 4
    obs = torch.rand((b, cfg.img_size, cfg.img_size, cfg.img_channels), generator=g) * 2 - 1
    hx, cx, u_h = (torch.randn((b, cfg.lstm_dim), generator=g) for _ in range(3))
    u_l, u_v = torch.randn((b, cfg.num_actions), generator=g), torch.randn((b,), generator=g)
    grads = []
    for dev in ("cuda", "cpu"):
        ac = ActorCritic(cfg, torch.float32)
        ac.net.load_state_dict(agent.actor_critic.net.state_dict())
        ac.net.to(dev)
        out = ac.head(ac.encode(obs.to(dev)), (hx.to(dev), cx.to(dev)))
        ((out.logits_act * u_l.to(dev)).sum() + (out.val * u_v.to(dev)).sum()
         + (out.carry[0] * u_h.to(dev)).sum()).backward()
        grads.append({n: p.grad.cpu() for n, p in ac.net.named_parameters()})
    worst = 0.0
    for n, ref in grads[1].items():
        share = (grads[0][n] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        check(share <= 1e-3,
              f"AC gradient check: {n} differs by {share:.3g} of its largest |value|")
        worst = max(worst, share)
    log(f"[reference] AC trunk+head gradient, f32 card vs CPU plain, B={b} at "
        f"{cfg.img_size}x{cfg.img_size}: every parameter within {worst:.3g} of its largest "
        f"|value| (limit 1e-3)")
    return dict(max_leaf_share=worst)


def ac_step_reference(agent, st, pool, wm_cfg):
    """A B=2, T=2 f32 AC-step loss and gradient (training.ac_rollout_loss + backward) at
    full width, on the card (kernels, TF32 off) and on the CPU (plain versions), same
    weights and draws, the world model unquantized, pool features encoded per reset.
    Actions, rewards and ends equal, loss within 1e-3; the largest relative gradient
    difference and the frames' difference in grid levels are figures."""
    import torch
    from diamond_tpu_torch.config import ActorCriticLossConfig
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImagState, ImaginationEngine,
                                                        draw_rollout_noise)
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.training import ac_rollout_loss

    b, t = 2, 2
    loss_cfg = ActorCriticLossConfig(backup_every=t)
    draws = draw_rollout_noise(t, b, tuple(st.obs_buffer.shape[2:]), agent.cfg.num_actions,
                               torch.Generator().manual_seed(SEED + 4), torch.device("cpu"))
    outs = []
    for dev in ("cuda", "cpu"):
        a = Agent(agent.cfg, torch.float32, device=dev)
        for name, net in a.nets.items():
            net.load_state_dict(agent.nets[name].state_dict())
        eng = ImaginationEngine(a.denoiser, a.rew_end_model, a.actor_critic, wm_cfg)
        s = ImagState(**{k: getattr(st, k)[:b].to(dev) for k in st.__dataclass_fields__})
        p = ICPool(obs=pool.obs[:8].to(dev), act=pool.act[:8].to(dev), hx=pool.hx[:8].to(dev),
                   cx=pool.cx[:8].to(dev), ptr=torch.zeros((), dtype=torch.long, device=dev))
        loss, _, s, _, traj = ac_rollout_loss(eng, a.actor_critic, loss_cfg, s, p,
                                              type(draws)(*(d.to(dev) for d in draws)))
        loss.backward()
        outs.append((loss.item(), {k: v.detach().cpu() for k, v in traj.items()},
                     s.obs_buffer.cpu(),
                     {n: q.grad.cpu() for n, q in a.actor_critic.net.named_parameters()}))
    (lg, tg, og, gg), (lc, tc, oc, gc) = outs
    for k in ("act", "rew", "end"):
        check(torch.equal(tg[k], tc[k]), f"AC step reference: {k} differs card vs CPU")
    check(abs(lg - lc) <= 1e-3 * max(1.0, abs(lc)), f"AC step reference: loss {lg} vs {lc}")
    rel = max((gg[n] - gc[n]).abs().max().item() / max(gc[n].abs().max().item(), 1e-30)
              for n in gc)
    d = (og.long() - oc.long()).abs()
    log(f"[reference] AC step B={b} T={t} f32 card vs CPU plain: actions/rewards/ends equal, "
        f"loss {lg:.6g} vs {lc:.6g}; largest gradient difference {rel:.3g} of its leaf's "
        f"largest |value|, frames off by up to {int(d.max())} level(s) in "
        f"{(d > 0).float().mean().item():.4%} of values")
    return dict(loss_card=lg, loss_cpu=lc, max_grad_share=rel, frame_max_levels=int(d.max()),
                frame_share=(d > 0).float().mean().item())


def expected_launches(net, calls: int = 1) -> dict:
    """The kernel launches of a train step that runs ``net`` ``calls`` times forward and
    backward, from its module tree: per call K1 per fused AdaGN, K2 per GroupNorm, K3 per
    3x3 conv, as many K1 and K2 backwards and weight gradients, each with the bias
    gradient, and a data gradient for every conv but the first (``conv_in``, whose input
    needs none): K3 at stride 1, the stride-2 kernel at the Downsample convs."""
    from diamond_tpu_torch.models.blocks import AdaGroupNorm, Conv3x3, GroupNorm

    mods = list(net.modules())
    k1 = sum(isinstance(m, AdaGroupNorm) for m in mods)
    k2 = sum(isinstance(m, GroupNorm) for m in mods)
    k3 = sum(isinstance(m, Conv3x3) for m in mods)
    s2 = sum(isinstance(m, Conv3x3) and m.strides == 2 for m in mods)
    n = calls
    return {"adagn_silu": n * k1, "adagn_silu_bwd": n * k1, "groupnorm_silu": n * k2,
            "groupnorm_silu_bwd": n * k2, "conv3x3": n * k3,
            "conv3x3_dgrad": n * (k3 - 1 - s2), "conv3x3_dgrad_s2": n * s2,
            "conv3x3_wgrad": n * k3, "conv3x3_wgrad at stride 2": n * s2,
            "conv3x3_wgrad with the bias gradient": n * k3}


def removed_launch_calls(inner, windows: int) -> int:
    """The kernel launches per denoiser step that the conv backward no longer makes: a
    bias reduction per conv, and per stride-2 conv the zero interleave's fill and copy
    for each of its two gradients and the kernel flip's two."""
    from diamond_tpu_torch.models.blocks import Conv3x3

    convs = [m for m in inner.modules() if isinstance(m, Conv3x3)]
    s2 = sum(m.strides == 2 for m in convs)
    return windows * (len(convs) + 2 * 2 * s2 + 2 * s2)


def denoiser_batch(cfg, b: int, gen, device):
    """Synthetic uint8 segments (b, n + 1 + num_autoregressive_steps frames) and random
    actions from ``gen``, every frame real (no padding), as a DeviceBatch on ``device``."""
    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.data.segment import DeviceBatch

    inner = cfg.denoiser.inner_model
    t = inner.num_steps_conditioning + 1 + TrainerConfig().denoiser.training.num_autoregressive_steps
    size = cfg.rew_end_model.img_size
    obs = torch.randint(0, 256, (b, t, size, size, inner.img_channels), generator=gen,
                        dtype=torch.uint8).to(device)
    act = torch.randint(0, cfg.num_actions, (b, t), generator=gen).to(device)
    zeros = dict(device=device, dtype=torch.int32)
    return DeviceBatch(obs=obs, act=act, rew=torch.zeros((b, t), device=device),
                       end=torch.zeros((b, t), **zeros), trunc=torch.zeros((b, t), **zeros),
                       mask_padding=torch.ones((b, t), dtype=torch.bool, device=device),
                       final_obs=torch.zeros((b,) + tuple(obs.shape[2:]), dtype=torch.uint8,
                                             device=device),
                       has_final_obs=torch.zeros((b,), dtype=torch.bool, device=device))


def host_costs() -> dict:
    """Host µs per call of each piece of the backward Functions, on small bf16 inputs
    (B = 2, 16x16x64, the device's work a few µs): where the CPU time of a backward node
    goes. A figure, not a check."""
    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.ops.conv3x3 import flip_kernel

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    x, dy, w = rnd(2, 16, 16, 64), rnd(2, 16, 16, 64), rnd(3, 3, 64, 64)
    dy2, ss = rnd(2, 8, 8, 64), rnd(2, 128)
    sc, bi = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    _, mom_gn = ops.groupnorm_silu_with_moments(x, sc, bi, 2)
    _, mom_ada = ops.adagn_silu_with_moments(x, ss, 2)
    pieces = {
        "flip_kernel": lambda: flip_kernel(w),
        "conv3x3_dgrad": lambda: ops.conv3x3_dgrad(dy, w),
        "conv3x3_dgrad_s2": lambda: ops.conv3x3_dgrad_s2(dy2, w, (16, 16)),
        "conv3x3_wgrad": lambda: ops.conv3x3_wgrad(x, dy),
        "conv3x3_wgrad with the bias gradient": lambda: ops.conv3x3_wgrad(x, dy, 1, True),
        "conv3x3_wgrad at stride 2 with the bias gradient":
            lambda: ops.conv3x3_wgrad(x, dy2, 2, True),
        "groupnorm_silu_bwd": lambda: ops.groupnorm_silu_bwd(x, dy, sc, bi, 2, True, mom_gn),
        "adagn_silu_bwd": lambda: ops.adagn_silu_bwd(x, dy, ss, 2, True, mom_ada),
    }
    out = {}
    for k, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[k] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    log("[host] CPU µs per call: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items()))
    return out


def train_step_phase(label, model, section, make, batch, windows, samples, what, loss_fn,
                     smi, note=""):
    """A diffusion model's train step as the trainer calls it (``make(model, tx, sigma)``
    with trainer.yaml's ``section``: its optimizer and sigma distribution; warmup 0
    instead of 100, so that the first step moves the weights), on a deep copy of
    ``model`` (a Denoiser at full width, bf16 compute over f32 parameters; the copy
    carries any int8 collection, which training ignores), on ``batch``: counts set to 0,
    one warm-up step and DEN_STEPS timed ones, counts read and held to the module tree's
    (``windows`` passes forward and backward a step); then one step profiled (no bias
    sum, interleave or cast under the backwards), one under the sync debug mode (none
    allowed), and one loss's (``loss_fn(copy, generator)``) gradients checked leaf by
    leaf. ``model`` is checked untouched. The rate is ``samples`` per step, in ``what``;
    ``note`` says how the batch reaches the model. Returns (signatures, result)."""
    import copy
    from dataclasses import replace

    import torch
    from diamond_tpu_torch.training import OptimizerSpec, TrainState

    spec = replace(OptimizerSpec.from_cfg(section.optimizer, section.training),
                   lr_warmup_steps=0)
    tx = spec.build()
    src = model.inner_model
    src_before = {k: v.detach().clone() for k, v in src.state_dict().items()}
    den = copy.deepcopy(model)
    net = den.inner_model
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    state = TrainState.create(net, tx)
    step = make(den, tx, section.sigma_distribution)
    dgen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    count_reset()
    state, m = step(state, batch, generator=dgen)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v)) for v in m.values()), f"{label}: non-finite {m}")
    check_all_moved_and_finite(net, before, f"{label} (first step, warmup 0)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(DEN_STEPS):
        state, m = step(state, batch, generator=dgen)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / DEN_STEPS
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + DEN_STEPS
    launches, shapes, per_step = per_step_launches(steps)
    check_launches(per_step, expected_launches(net, windows), label)
    metrics = {k: v.item() for k, v in m.items()}
    check(all(map(math.isfinite, metrics.values())), f"{label}: non-finite {metrics}")
    b, t = batch.obs.shape[:2]
    log(f"[{label}] B={b} T={t} at {batch.obs.shape[2]}x{batch.obs.shape[3]}{note}, bf16 "
        f"compute, f32 parameters, warmup 0 (the first step moves every weight): "
        f"{secs * 1e3:.1f} ms per step, {samples / secs:.1f} {what}/s "
        f"over {DEN_STEPS} steps after one warm-up, peak memory {peak / 2**30:.2f} GiB, on {smi}")
    log(f"[{label}] metrics of the last step: "
        + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    log(f"[launches] {label}, per step (as the module tree says): "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items() if v))

    profile = profile_run(lambda: step(state, batch, generator=dgen), label, "train step")
    log_unprofiled_idle(profile, secs * 1e3, label)
    check_conv_backward(profile, per_step["conv3x3_dgrad"], label)
    check_norm_backward(profile, label)
    syncs = sync_points(lambda: step(state, batch, generator=dgen))
    log(f"[sync] {label}: {sum(syncs.values())} host-device synchronisations {syncs}")
    check(not syncs, f"{label} synchronised: {syncs}")
    check_finite_gradients(net, lambda: loss_fn(den, dgen), label)
    moved = check_all_moved_and_finite(net, before, label)
    untouched = all(torch.equal(v, src_before[k]) for k, v in src.state_dict().items())
    check(untouched and all(p.grad is None for p in src.parameters()),
          f"{label}: the agent's model changed or has gradients")
    log(f"[{label}] every one of {len(before)} parameter tensors got a finite gradient; "
        f"largest weight change {moved:.3g}; the agent's model untouched")
    return shapes, dict(step_ms=secs * 1e3, rate=samples / secs, rate_unit=f"{what}/s",
                        windows=windows, peak_memory_bytes=peak, launches=launches,
                        launches_per_step=per_step, metrics=metrics, profile=profile,
                        sync_points=syncs, max_weight_change=moved, steps=steps)


def denoiser_step_phase(agent, smi):
    """``train_step_phase`` of the denoiser step (training.make_denoiser_train_step with
    trainer.yaml's denoiser section) on B = 32 synthetic segments of 6 frames, two
    autoregressive windows; besides, the launch calls per step held under those of the
    step before the conv and norm backwards lost their extra launches, and the host's
    costs per backward piece. Returns (signatures, result)."""
    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.training import make_denoiser_train_step

    tcfg = TrainerConfig().denoiser
    batch = denoiser_batch(agent.cfg, BATCH, torch.Generator().manual_seed(SEED + 7), "cuda")
    windows = batch.obs.shape[1] - agent.cfg.denoiser.inner_model.num_steps_conditioning
    shapes, result = train_step_phase(
        "denoiser_step", agent.denoiser, tcfg, make_denoiser_train_step, batch, windows,
        BATCH * windows, "denoiser training samples (B x windows / step)",
        lambda den, g: den.loss(obs_to_float(batch.obs), batch.act, batch.mask_padding,
                                tcfg.sigma_distribution, generator=g)[0], smi,
        f" ({windows} windows)")
    profile, steps = result["profile"], result["steps"]
    norm_removed = norm_bwd_removed_launches(result["launches"], shapes, steps)
    most = (DENOISER_LAUNCH_CALLS_BEFORE - removed_launch_calls(agent.denoiser.inner_model,
                                                                windows) - norm_removed)
    check(profile["launches"] <= most, f"denoiser step: {profile['launches']} kernel launch "
          f"calls, more than {most:g}: {DENOISER_LAUNCH_CALLS_BEFORE} less the launches removed")
    log(f"[profile]   {profile['launches']} kernel launch calls per denoiser step: at most "
        f"{most:g} ({DENOISER_LAUNCH_CALLS_BEFORE} less the bias sums, interleaves and "
        f"stride-2 flips, and {norm_removed:g} K2 sums and casts)")
    result["host_costs_us"] = host_costs()
    return shapes, result


def denoiser_step_reference(agent):
    """A B=2 full-width denoiser loss and gradient (two windows, one frame padded) in f32
    on the card (kernels, TF32 off) and on the CPU (plain versions), same weights and
    draws. The loss within 1e-4 relative; each parameter's gradient within 1e-2 of its
    CPU leaf's largest |value| (a frame fed back into the second window may differ by a
    grid level, which moves that window's gradient a little); the fed-back frame of the
    first window at most one grid level apart in at most 0.1 % of the values."""
    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.models import Denoiser
    from diamond_tpu_torch.models.denoiser import draw_loss_noise

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigma_cfg = TrainerConfig().denoiser.sigma_distribution
    n = agent.cfg.denoiser.inner_model.num_steps_conditioning
    b = 2
    batch = denoiser_batch(agent.cfg, b, torch.Generator().manual_seed(SEED + 9), "cpu")
    batch.mask_padding[1, -1] = False
    _, t, h, w, c = batch.obs.shape
    draws = draw_loss_noise(t - n, b, (h, w, c), torch.Generator().manual_seed(SEED + 10), "cpu")
    outs = []
    for dev in ("cuda", "cpu"):
        d = Denoiser(agent.cfg.denoiser, torch.float32)
        d.inner_model.load_state_dict(agent.denoiser.inner_model.state_dict())
        d.inner_model.to(dev)
        obs = obs_to_float(batch.obs.to(dev))
        dr = type(draws)(*(v.to(dev) for v in draws))
        with torch.enable_grad():
            loss, _ = d.loss(obs, batch.act.to(dev), batch.mask_padding.to(dev), sigma_cfg, dr)
            loss.backward()
        sigma = d.sample_sigma_training(dr.sigma[0], sigma_cfg)
        noisy = d.apply_noise(obs[:, n], sigma, dr.offset[0], dr.noise[0])
        cs = d.compute_conditioners(sigma)
        cond = obs[:, :n].movedim(1, 3).reshape(b, h, w, n * c)
        fed = d.wrap_model_output(noisy, d.compute_model_output(
            noisy, cond, batch.act[:, :n].to(dev), cs), cs)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs.append((loss.item(), {k: q.grad.cpu() for k, q in d.inner_model.named_parameters()},
                     torch.round((fed.cpu().double() + 1) * 127.5)))
    (lg, gg, fg), (lc, gc, fc) = outs
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"denoiser step reference: loss {lg} vs {lc}")
    share, worst = grads_close(gg, gc, 1e-2, "denoiser step reference")
    dl = (fg - fc).abs()
    frame_share = (dl > 0).float().mean().item()
    check(dl.max().item() <= 1 and frame_share <= 1e-3, f"denoiser step reference: fed-back "
          f"frames differ by {dl.max().item()} in {frame_share}")
    log(f"[reference] denoiser step B={b} T={t} f32 card vs CPU plain: loss {lg:.7g} vs "
        f"{lc:.7g}; every gradient within {share:.3g} of its leaf's largest |value| "
        f"({worst}; limit 1e-2); fed-back frame off by up to {int(dl.max().item())} "
        f"level(s) in {frame_share:.4%} of values")
    return dict(loss_card=lg, loss_cpu=lc, max_grad_share=share, worst_leaf=worst,
                frame_max_levels=int(dl.max().item()), frame_share=frame_share)


def synthetic_dataset(cfg):
    """A Dataset (held in RAM) of seeded synthetic episodes, DATASET_STEPS steps in all, as
    the first epoch's collection leaves it: lengths 100 to 999, sparse rewards of both
    signs (some larger than 1, which the loss sign-clips), two episodes in three ending in
    a death with its final frame, the others truncated, the last one still running."""
    import numpy as np
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.data.episode import Episode

    rng = np.random.default_rng(SEED + 11)
    size, ch = cfg.rew_end_model.img_size, cfg.rew_end_model.img_channels
    ds = Dataset(OUT_DIR / "rew_end_dataset", "train_dataset", cache_in_ram=True,
                 save_on_disk=False)
    total, i = 0, 0
    while total < DATASET_STEPS:
        n = min(int(rng.integers(100, 1000)), DATASET_STEPS - total)
        end, trunc = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
        info = {}
        last = total + n >= DATASET_STEPS
        if not last:
            (end if i % 3 < 2 else trunc)[-1] = 1
            info["final_observation"] = rng.integers(0, 256, (size, size, ch), dtype=np.uint8)
        ds.add_episode(Episode(
            obs=rng.integers(0, 256, (n, size, size, ch), dtype=np.uint8),
            act=rng.integers(0, cfg.num_actions, n).astype(np.int32),
            rew=rng.choice([-1.0, 0.0, 1.0, 3.0], n, p=[0.02, 0.9, 0.06, 0.02]).astype(
                np.float32), end=end, trunc=trunc, info=info))
        total, i = total + n, i + 1
    return ds


def per_step_launches(steps: int) -> tuple:
    """(launches, signatures, launches per step) read from the wrappers' counts, with the
    weight gradient's calls at stride 2 and with the bias gradient apart."""
    from diamond_tpu_torch import ops

    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    per_step = {name: launches[name] / steps for name in launches}
    wg = shapes["conv3x3_wgrad"]
    per_step["conv3x3_wgrad at stride 2"] = sum(c for sig, c in wg.items() if sig[2] == 2) / steps
    per_step["conv3x3_wgrad with the bias gradient"] = sum(
        c for sig, c in wg.items() if sig[3]) / steps
    return launches, shapes, per_step


def check_launches(per_step: dict, expected: dict, what: str) -> None:
    """Each kernel's launches per step equal the module tree's count (0 where it has
    none)."""
    for k, v in {**dict.fromkeys(KERNELS, 0), **expected}.items():
        check(per_step[k] == v, f"{what}: {per_step[k]} {k} launches per step, the module "
              f"tree says {v}")


def check_all_moved_and_finite(net, before, what: str) -> float:
    """Every parameter tensor of ``net`` moved from ``before`` and is finite; returns the
    largest change."""
    import torch

    with torch.no_grad():
        bad = [n for n, p in net.named_parameters()
               if torch.equal(p, before[n]) or not bool(torch.isfinite(p).all())]
        check(not bad, f"{what}: {len(bad)} parameter tensors did not move or are not "
              f"finite: {bad[:5]}")
        return max((p - before[n]).abs().max().item() for n, p in net.named_parameters())


def check_finite_gradients(net, loss_fn, what: str) -> None:
    """One loss's backward gives every parameter of ``net`` a finite gradient (outside
    the counted run); the gradients are cleared after."""
    import torch

    net.zero_grad(set_to_none=True)
    with torch.enable_grad():
        loss_fn().backward()
    missing = [n for n, p in net.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    net.zero_grad(set_to_none=True)
    check(not missing, f"{what}: no finite gradient for {missing}")


def rew_end_step_phase(agent, smi):
    """The rew/end train step as the trainer runs it: a Dataset of DATASET_STEPS seeded
    synthetic steps mirrored into a DeviceEpisodeStore on the card, segments drawn by the
    BatchSampler with trainer.yaml's weights and can_sample_beyond_end, batches gathered
    by the store (StoreBatchIterator), and training.make_rew_end_train_step with
    trainer.yaml's rew/end section (lr 1e-4, decay 1e-2, eps 1e-8, clip 100; warmup 0, so
    that the first step moves the weights) at B = 32, T = 19, bf16 compute over f32
    parameters, on a deep copy of the agent's rew/end model. The store's gather is held
    to the host collate on one batch. Counts set to 0, one warm-up step and REW_STEPS
    timed ones (each with a new batch), counts read and held to the module tree's; then
    one step profiled, one under the sync debug mode (no synchronisation allowed), every
    leaf's gradient finite, the eval step, and two steps with grad_acc_steps = 2 (the
    weights move on the second only). The agent's rew/end model is checked untouched.
    Returns (signatures, result)."""
    import copy
    from dataclasses import replace

    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.data.batch_sampler import BatchSampler
    from diamond_tpu_torch.data.device_store import DeviceEpisodeStore, StoreBatchIterator
    from diamond_tpu_torch.data.segment import (DENSE_FIELDS, DeviceBatch,
                                                collate_segments_to_batch)
    from diamond_tpu_torch.training import (OptimizerSpec, TrainState, make_rew_end_eval_step,
                                            make_rew_end_train_step)
    from diamond_tpu_torch.utils import compute_classification_metrics

    tcfg = TrainerConfig().rew_end_model
    tr = tcfg.training
    cfg = agent.cfg.rew_end_model
    t0 = time.perf_counter()
    ds = synthetic_dataset(agent.cfg)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = DeviceEpisodeStore(ds.num_steps, (cfg.img_size, cfg.img_size, cfg.img_channels),
                               max_episodes=ds.num_episodes, device="cuda")
    store.sync(ds)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    deaths = int(ds.counts_end[1])
    log(f"[rew_end_step] dataset: {ds.num_episodes} episodes, {ds.num_steps} steps, {deaths} "
        f"deaths with their final frame, made in {gen_s:.2f} s; mirrored into the device "
        f"store ({store.obs.numel() / 2**20:.1f} MiB of frames) in {sync_s:.2f} s")
    sampler = BatchSampler(ds, 0, 1, tr.batch_size, tr.seq_length, tr.sample_weights,
                           can_sample_beyond_end=True, seed=SEED + 12)
    ids = sampler.sample()
    dev, host = store.make_batch(ids), DeviceBatch.from_batch(
        collate_segments_to_batch([ds[s] for s in ids]), "cuda")
    for name in DENSE_FIELDS:
        check(torch.equal(getattr(dev, name), getattr(host, name)),
              f"rew/end step: the store's {name} differs from the host collate")
    beyond = sum(s.stop > ds.lengths[s.episode_id] for s in ids)
    log(f"[rew_end_step] the store's batch equals the host collate field for field "
        f"({beyond} of {len(ids)} windows reach past their episode's end, "
        f"{int(dev.has_final_obs.sum())} carry a final frame)")
    batches = StoreBatchIterator(store, sampler)

    src = agent.rew_end_model.net
    src_before = {k: v.detach().clone() for k, v in src.state_dict().items()}
    model = copy.deepcopy(agent.rew_end_model)
    net = model.net
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    spec = replace(OptimizerSpec.from_cfg(tcfg.optimizer, tr), lr_warmup_steps=0)
    tx = spec.build()
    state = TrainState.create(net, tx)
    step = make_rew_end_train_step(model, tx)

    count_reset()
    state, m = step(state, next(batches))
    torch.cuda.synchronize()
    check_all_moved_and_finite(net, before, "rew/end step (first step, warmup 0)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(REW_STEPS):
        state, m = step(state, next(batches))
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / REW_STEPS
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + REW_STEPS
    launches, shapes, per_step = per_step_launches(steps)
    check_launches(per_step, expected_launches(net.encoder), "rew/end step")
    cms = {k: v.tolist() for k, v in m.pop("confusion_matrix").items()}
    metrics = {k: v.item() for k, v in m.items()}
    check(all(map(math.isfinite, metrics.values())), f"rew/end step: non-finite {metrics}")
    frames = tr.batch_size * (tr.seq_length - 1)
    check(sum(map(sum, cms["end"])) <= frames, "rew/end step: confusion matrix over the batch")
    fps = frames / secs
    log(f"[rew_end_step] B={tr.batch_size} T={tr.seq_length} ({frames} samples through the "
        f"encoder), bf16 compute, f32 parameters, warmup 0: {secs * 1e3:.1f} ms per step "
        f"(batch gather included), {fps:.1f} rew/end training frames/s (B x (T - 1) / step) "
        f"over {REW_STEPS} steps after one warm-up, peak memory {peak / 2**30:.2f} GiB, on "
        f"{smi}")
    log("[rew_end_step] metrics of the last step: "
        + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items())
        + f"; confusion matrices {cms}; end-class recall "
        + str([round(float(r), 4) for r in compute_classification_metrics(cms["end"])[1]]))
    log(f"[launches] rew_end_step, per step (as the module tree says): "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items() if v))

    profile = profile_run(lambda: step(state, next(batches)), "rew_end_step", "rew/end step")
    log_unprofiled_idle(profile, secs * 1e3, "rew/end step")
    check_conv_backward(profile, per_step["conv3x3_dgrad"], "rew/end step")
    check_norm_backward(profile, "rew/end step")
    syncs = sync_points(lambda: step(state, next(batches)))
    log(f"[sync] rew/end step with its batch gather: {sum(syncs.values())} host-device "
        f"synchronisations {syncs}")
    check(not syncs, f"rew/end step: host-device synchronisations {syncs}")
    b = next(batches)
    check_finite_gradients(net, lambda: model.loss(
        b.obs.float() / 127.5 - 1, b.act, b.rew, b.end, b.mask_padding,
        b.final_obs.float() / 127.5 - 1, b.has_final_obs)[0], "rew/end step")
    ev = make_rew_end_eval_step(model)(next(batches))
    check(all(bool(torch.isfinite(ev[k])) for k in ("loss_rew", "loss_end", "loss_total")),
          f"rew/end eval step: non-finite {ev}")
    moved = check_all_moved_and_finite(net, before, "rew/end step")

    # gradient accumulation: two micro-steps, the weights move on the second only
    tx2 = replace(spec, grad_acc_steps=2).build()
    state2 = TrainState.create(net, tx2)
    step2 = make_rew_end_train_step(model, tx2)
    w0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    state2, m1 = step2(state2, next(batches))
    torch.cuda.synchronize()
    check(all(torch.equal(p, w0[n]) for n, p in net.named_parameters()),
          "rew/end step, grad_acc_steps = 2: the first micro-step moved the weights")
    state2, m2 = step2(state2, next(batches))
    acc_moved = check_all_moved_and_finite(net, w0, "rew/end step, grad_acc_steps = 2")
    norms = (m1["grad_norm_before_clip"].item(), m2["grad_norm_before_clip"].item())
    check(all(map(math.isfinite, norms)) and state2.step == 2,
          f"rew/end step, grad_acc_steps = 2: norms {norms}, {state2.step} micro-steps")
    untouched = all(torch.equal(v, src_before[k]) for k, v in src.state_dict().items())
    check(untouched and all(p.grad is None for p in src.parameters()),
          "rew/end step: the agent's rew/end model changed or has gradients")
    log(f"[rew_end_step] every one of {len(before)} parameter tensors got a finite gradient "
        f"and moved (largest change {moved:.3g}); eval loss {ev['loss_total'].item():.4g}; "
        f"grad_acc_steps = 2: weights unchanged after micro-step 1, moved after micro-step 2 "
        f"(largest change {acc_moved:.3g}; micro-step norms {norms[0]:.4g}, {norms[1]:.4g}); "
        "the agent's rew/end model untouched")
    return shapes, dict(step_ms=secs * 1e3, frames_per_s=fps, samples_per_step=frames,
                        peak_memory_bytes=peak, launches=launches, launches_per_step=per_step,
                        metrics=metrics, confusion_matrix=cms, profile=profile,
                        sync_points=syncs, max_weight_change=moved, steps=steps,
                        dataset=dict(episodes=ds.num_episodes, steps=ds.num_steps,
                                     deaths=deaths, store_sync_s=sync_s),
                        grad_acc=dict(norms=norms, max_weight_change=acc_moved))


def recorded_tensors(cfg, b: int, t: int, gen, device):
    """Seeded tensors as the env loop records them for the model-free step: uint8 frames
    (b, t, H, W, C), actions, rewards in {-1, 0, 1}, sparse ends and truncations (never
    both), the LSTM reset gates (1 where the previous step ended the episode), the
    starting carry and the bootstrap values."""
    import torch

    ac = cfg.actor_critic
    obs = torch.randint(0, 256, (b, t, ac.img_size, ac.img_size, ac.img_channels),
                        generator=gen, dtype=torch.uint8)
    act = torch.randint(0, cfg.num_actions, (b, t), generator=gen)
    rew = torch.randint(-1, 2, (b, t), generator=gen).float()
    end = (torch.rand((b, t), generator=gen) < 0.05).float()
    trunc = (torch.rand((b, t), generator=gen) < 0.03).float() * (1 - end)
    reset = torch.zeros((b, t))
    reset[:, 1:] = ((end + trunc)[:, :-1] > 0).float()
    hx0, cx0 = (0.5 * torch.randn((b, ac.lstm_dim), generator=gen) for _ in range(2))
    vboot = torch.randn((b, t), generator=gen)
    return tuple(x.to(device) for x in (obs, act, rew, end, trunc, reset, hx0, cx0, vboot))


def mf_ac_step_phase(agent, smi):
    """The model-free actor-critic step (training.make_model_free_ac_train_step, the
    trainer config's AC optimizer and loss, warmup 0) on a deep copy of the agent's
    actor-critic, B = 32, T = 15, bf16 compute, on seeded recorded tensors with resets:
    counts set to 0, one warm-up and MF_STEPS timed steps, counts read and held to the
    trunk's module tree (the B * T frames encoded in one call), then one step profiled
    and one under the sync debug mode (no synchronisation allowed); every parameter
    moves. Returns (signatures, result)."""
    import copy
    from dataclasses import replace

    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.training import (OptimizerSpec, TrainState,
                                            make_model_free_ac_train_step)

    tcfg = TrainerConfig().actor_critic
    spec = replace(OptimizerSpec.from_cfg(tcfg.optimizer, tcfg.training), lr_warmup_steps=0)
    tx = spec.build()
    ac = copy.deepcopy(agent.actor_critic)
    net = ac.net
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    state = TrainState.create(net, tx)
    step = make_model_free_ac_train_step(ac, tx, tcfg.actor_critic_loss)
    t = tcfg.actor_critic_loss.backup_every
    rec = recorded_tensors(agent.cfg, BATCH, t, torch.Generator().manual_seed(SEED + 13),
                           "cuda")

    count_reset()
    state, m = step(state, *rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(MF_STEPS):
        state, m = step(state, *rec)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / MF_STEPS
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + MF_STEPS
    launches, shapes, per_step = per_step_launches(steps)
    check_launches(per_step, expected_launches(net.encoder), "model-free step")
    metrics = {k: v.item() for k, v in m.items()}
    check(all(map(math.isfinite, metrics.values())), f"model-free step: non-finite {metrics}")
    moved = check_all_moved_and_finite(net, before, "model-free step")
    fps = BATCH * t / secs
    log(f"[mf_ac_step] B={BATCH} T={t} recorded frames, bf16 actor-critic, warmup 0: "
        f"{secs * 1e3:.1f} ms per step, {fps:.1f} training env_frames/s over {MF_STEPS} "
        f"steps after one warm-up, peak memory {peak / 2**30:.2f} GiB, every parameter moved "
        f"(largest change {moved:.3g}), on {smi}")
    log("[mf_ac_step] metrics of the last step: "
        + ", ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
    log(f"[launches] mf_ac_step, per step (as the module tree says): "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items() if v))
    profile = profile_run(lambda: step(state, *rec), "mf_ac_step", "model-free AC step")
    log_unprofiled_idle(profile, secs * 1e3, "model-free AC step")
    check_conv_backward(profile, per_step["conv3x3_dgrad"], "model-free step")
    check_norm_backward(profile, "model-free step")
    syncs = sync_points(lambda: step(state, *rec))
    log(f"[sync] model-free AC step: {sum(syncs.values())} host-device synchronisations "
        f"{syncs}")
    check(not syncs, f"model-free step: host-device synchronisations {syncs}")
    return shapes, dict(step_ms=secs * 1e3, fps=fps, peak_memory_bytes=peak,
                        launches=launches, launches_per_step=per_step, metrics=metrics,
                        profile=profile, sync_points=syncs, max_weight_change=moved,
                        steps=steps)


def grads_close(card: dict, cpu: dict, limit: float, what: str) -> tuple:
    """Each leaf's gradient on the card within ``limit`` of the CPU leaf's largest
    |value|; returns (the worst share, its leaf)."""
    shares = {k: (card[k] - cpu[k]).abs().max().item() / max(cpu[k].abs().max().item(), 1e-30)
              for k in cpu}
    worst = max(shares, key=shares.get)
    check(shares[worst] <= limit, f"{what}: {worst}'s gradient differs by "
          f"{shares[worst]:.3g} of its largest |value| (limit {limit})")
    return shares[worst], worst


def rew_end_step_reference(agent):
    """A B=2, T=6 f32 rew/end loss and its gradients (segment 0 dies at step 2 with its
    final frame known and is padded after, segment 1 is padded before its start) at
    full width on the card (kernels, TF32 off) and on the CPU (plain versions), same
    weights: the loss within 1e-4 relative, the confusion matrices equal, every leaf's
    gradient within 1e-3 of the CPU leaf's largest |value|."""
    import torch
    from diamond_tpu_torch.models import RewEndModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = agent.cfg.rew_end_model
    g = torch.Generator().manual_seed(SEED + 14)
    b, t, s, c = 2, 6, cfg.img_size, cfg.img_channels
    obs = torch.rand((b, t, s, s, c), generator=g) * 2 - 1
    final = torch.rand((b, s, s, c), generator=g) * 2 - 1
    act = torch.randint(0, agent.cfg.num_actions, (b, t), generator=g)
    rew = torch.randint(-1, 2, (b, t), generator=g).float()
    end = torch.zeros((b, t), dtype=torch.int32)
    mask = torch.ones((b, t), dtype=torch.bool)
    end[0, 2], mask[0, 3:], mask[1, 0] = 1, False, False
    obs[~mask] = 0
    has_final = torch.tensor([True, False])
    outs = []
    for dev in ("cuda", "cpu"):
        m = RewEndModel(cfg, torch.float32)
        m.net.load_state_dict(agent.rew_end_model.net.state_dict())
        m.net.to(dev)
        with torch.enable_grad():
            loss, met = m.loss(*(x.to(dev) for x in (obs, act, rew, end, mask, final,
                                                     has_final)))
            loss.backward()
        outs.append((loss.item(), {k: v.cpu() for k, v in met["confusion_matrix"].items()},
                     {n: q.grad.cpu() for n, q in m.net.named_parameters()}))
    (lg, cg, gg), (lc, cc, gc) = outs
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"rew/end step reference: loss {lg} vs {lc}")
    check(all(torch.equal(cg[k], cc[k]) for k in cc), "rew/end step reference: confusion "
          "matrices differ card vs CPU")
    share, worst = grads_close(gg, gc, 1e-3, "rew/end step reference")
    log(f"[reference] rew/end step B={b} T={t} f32 card vs CPU plain: loss {lg:.7g} vs "
        f"{lc:.7g}, confusion matrices equal; every gradient within {share:.3g} of its leaf's "
        f"largest |value| ({worst}; limit 1e-3)")
    return dict(loss_card=lg, loss_cpu=lc, max_grad_share=share, worst_leaf=worst)


def mf_ac_step_reference(agent):
    """A B=2, T=3 f32 model-free AC loss and its gradients on recorded tensors with a
    reset, at full width on the card (kernels, TF32 off) and on the CPU (plain
    versions), same weights: the loss within 1e-4 relative, every leaf's gradient
    within 1e-3 of the CPU leaf's largest |value|."""
    import torch
    from diamond_tpu_torch.config import TrainerConfig
    from diamond_tpu_torch.models.actor_critic import ActorCritic
    from diamond_tpu_torch.training import model_free_ac_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_cfg = TrainerConfig().actor_critic.actor_critic_loss
    rec = list(recorded_tensors(agent.cfg, 2, 3, torch.Generator().manual_seed(SEED + 15),
                                "cpu"))
    rec[5][0, 1] = 1.0  # a reset
    outs = []
    for dev in ("cuda", "cpu"):
        ac = ActorCritic(agent.cfg.actor_critic, torch.float32)
        ac.net.load_state_dict(agent.actor_critic.net.state_dict())
        ac.net.to(dev)
        with torch.enable_grad():
            loss, _ = model_free_ac_loss(ac, loss_cfg, *(x.to(dev) for x in rec))
            loss.backward()
        outs.append((loss.item(), {n: q.grad.cpu() for n, q in ac.net.named_parameters()}))
    (lg, gg), (lc, gc) = outs
    check(abs(lg - lc) <= 1e-4 * max(1.0, abs(lc)),
          f"model-free step reference: loss {lg} vs {lc}")
    share, worst = grads_close(gg, gc, 1e-3, "model-free step reference")
    log(f"[reference] model-free AC step B=2 T=3 f32 card vs CPU plain: loss {lg:.7g} vs "
        f"{lc:.7g}; every gradient within {share:.3g} of its leaf's largest |value| "
        f"({worst}; limit 1e-3)")
    return dict(loss_card=lg, loss_cpu=lc, max_grad_share=share, worst_leaf=worst)


TRAINER_OVERRIDES = [
    # env=fake at its published size (64x64, 100-step episodes); the full default widths
    "env=fake", f"common.seed={SEED}",
    # cut to about a minute: 3 epochs (1,000 initial steps, two collecting epochs of 500,
    # one final epoch), few train steps, a pool of 1,024 (POOL_SIZE), 2 test episodes an
    # epoch and 4 at the end
    "collection.train.first_epoch.min=1000", "collection.train.first_epoch.max=1000",
    "collection.train.steps_per_epoch=500", "collection.train.num_steps_total=2000",
    "training.num_final_epochs=1",
    "denoiser.training.steps_first_epoch=20", "denoiser.training.steps_per_epoch=10",
    "rew_end_model.training.steps_first_epoch=20", "rew_end_model.training.steps_per_epoch=10",
    "actor_critic.training.steps_first_epoch=4", "actor_critic.training.steps_per_epoch=2",
    "world_model_env.num_batches_to_preload=32",
    "evaluation.every=1", "collection.test.num_episodes=2",
    "collection.test.num_final_episodes=4",
]


def states_equal(a: dict, b: dict, what: str) -> int:
    """Two ``Trainer.state_dict()``s bit for bit: counters, the datasets' index arrays,
    every weight, AdamW moment and step. Returns the tensors compared."""
    import numpy as np
    import torch

    n = 0

    def walk(x, y, path):
        nonlocal n
        if isinstance(x, dict):
            check(isinstance(y, dict) and set(x) == set(y), f"{what}: keys differ at {path}")
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            check(len(x) == len(y), f"{what}: lengths differ at {path}")
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}/{i}")
        elif isinstance(x, torch.Tensor):
            check(torch.equal(x.cpu(), y.cpu()), f"{what}: {path} differs")
            n += 1
        elif isinstance(x, np.ndarray):
            check(np.array_equal(x, y), f"{what}: {path} differs")
        else:
            check(x == y, f"{what}: {path}: {x!r} != {y!r}")

    walk(a, b, "")
    return n


def trainer_phase(smi):
    """The port's trainer (``diamond_tpu_torch.trainer.Trainer``, what
    ``python -m diamond_tpu_torch.main`` runs) on env=fake at the full default widths, cut
    to three epochs (TRAINER_OVERRIDES): the wall seconds of each part of each epoch, the
    launches of every kernel over the run, and the checks of what the loop adds to the
    train steps: rew/end windows that reach an episode's end, the background IC pool
    against a rebuild, int8 recalibration after each world-model step, resume bit for
    bit, and the agent snapshot loaded back. Returns (signatures, result)."""
    import copy
    import tempfile

    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.ops import quant
    from diamond_tpu_torch.trainer import Trainer
    from diamond_tpu_torch.utils import get_path_agent_ckpt

    tmp = tempfile.TemporaryDirectory(prefix="diamond_trainer_")
    run_dir = Path(tmp.name) / "run"
    run_dir.mkdir()
    cfg = load_config(TRAINER_OVERRIDES)
    log(f"[trainer] config: {TRAINER_OVERRIDES}; batch {cfg.denoiser.training.batch_size} "
        f"for every component, horizon {cfg.world_model_env.horizon}, "
        f"{cfg.world_model_env.diffusion_sampler.num_steps_denoising} Euler steps, "
        f"{cfg.tpu.compute_dtype}, int8_rollout {cfg.tpu.int8_rollout}, device_dataset "
        f"{cfg.tpu.device_dataset}, pool {cfg.world_model_env.num_batches_to_preload * 32}")
    check(cfg.tpu.int8_rollout and cfg.tpu.device_dataset, "the trainer's defaults changed")
    count_reset()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, Path(__file__).resolve().parent, run_dir=run_dir, device="cuda")
    init_s = time.perf_counter() - t0

    saved = {}
    save = trainer.save_checkpoint

    def save_and_keep():
        save()
        saved["state"] = copy.deepcopy(trainer.state_dict())
    trainer.save_checkpoint = save_and_keep

    windows = {"ends": torch.zeros((), dtype=torch.long, device="cuda"), "all": 0}
    rew_end_step = trainer._rew_end_step

    def counting_rew_end_step(state, batch):
        # the loss's swap: a window whose first T - 1 steps hold an end, with a final frame
        dead = (batch.end[:, :-1].sum(dim=1) > 0) & batch.has_final_obs
        windows["ends"] += dead.sum()
        windows["all"] += batch.end.shape[0]
        return rew_end_step(state, batch)
    trainer._rew_end_step = counting_rew_end_step

    fresh = {"checked": 0, "stale": 0, "epochs": set(), "during_build": 0, "check_s": {}}
    ac_step = trainer._ac_step

    def checking_ac_step(*a, **k):
        # the rollout's int8 weights folded from the weights of the last world-model step
        ts = trainer.train_states
        ok = (trainer._quant_step == ts["denoiser"].step
              and trainer._r_quant_step == ts["rew_end_model"].step)
        if trainer.epoch not in fresh["epochs"]:  # one tensor check an epoch, timed apart
            torch.cuda.synchronize()  # the queued work before it stays in the AC's time
            t0 = time.perf_counter()
            fresh["epochs"].add(trainer.epoch)
            ok = ok and quant.folded_from_current_weights(trainer.agent.denoiser.inner_model) \
                and quant.folded_from_current_weights(trainer.agent.rew_end_model.net)
            fresh["check_s"][trainer.epoch] = time.perf_counter() - t0
        fresh["checked"] += 1
        fresh["stale"] += not ok
        fresh["during_build"] += trainer._pool_manager.building()
        return ac_step(*a, **k)
    trainer._ac_step = checking_ac_step

    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    log(f"[trainer] {trainer.epoch} epochs in {run_s:.1f} s (the trainer made in "
        f"{init_s:.1f} s) on {smi}")
    ic, *epochs, fc = trainer.timings
    log(f"[trainer] initial collect: {ic['collect_steps']} env steps in {ic['collect_s']:.2f} s "
        f"({ic['collect_steps'] / ic['collect_s']:.1f} env steps/s)")
    for t in epochs:
        parts = []
        if "collect_s" in t:
            parts.append(f"collect {t['collect_s']:.2f} s ({t['collect_steps']} env steps, "
                         f"{t['collect_steps'] / t['collect_s']:.1f} env steps/s)")
        # the AC part less this phase's int8 check (made in its first step)
        t["actor_critic_s"] -= fresh["check_s"].get(t["epoch"], 0.0)
        for name in ("denoiser", "rew_end_model", "actor_critic"):
            if f"{name}_s" in t:
                parts.append(f"{name} {t[name + '_s']:.2f} s ({t[name + '_steps']} steps, "
                             f"{t[name + '_s'] / t[name + '_steps'] * 1e3:.1f} ms/step)")
        parts.append(f"the int8 check {fresh['check_s'].get(t['epoch'], 0.0):.3f} s apart")
        parts.append(f"recalibration {t.get('recalibration_s', 0.0):.3f} s")
        parts.append(f"pool builds {t.get('pool_builds')}, swaps {t.get('pool_swaps')}, "
                     f"pool_refill_wait_s {t.get('pool_refill_wait_s', 0.0):.4f}")
        parts.append(f"test collect {t.get('test_collect_s', 0.0):.2f} s, eval "
                     f"{t.get('eval_s', 0.0):.2f} s, checkpoint {t['checkpoint_s']:.2f} s")
        log(f"[trainer] epoch {t['epoch']}: " + "; ".join(parts))
    final = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()
             if "final_return_mean" in line][-1]
    protocol = {k: final[k] for k in sorted(final) if k.startswith("final")}
    log(f"[trainer] final collect {fc['test_collect_s']:.2f} s; "
        f"final protocol: {protocol}")
    log(f"[launches] trainer, over the run: {launches}")
    for name, (_, _, paths) in KERNELS.items():
        if "trainer" in paths:
            check(launches[name] > 0, f"{name} was not launched during the trainer's run")
    check(trainer.epoch == 3, f"the trainer ran {trainer.epoch} epochs, not 3")
    check(final["final_num_episodes"] == 4, "the final protocol did not collect 4 episodes")

    # rew/end windows that reach an end: the final-obs swap in timed steps
    ends = int(windows["ends"])
    log(f"[trainer] rew/end windows that reach an episode's end (the final-obs swap): "
        f"{ends} of {windows['all']}")
    check(ends > 0, "no rew/end window reached an episode's end")

    # int8 recalibration after each world-model step
    d_counts = [c["denoiser_step"] for c in trainer.calibrations]
    log(f"[trainer] int8 recalibrations at (epoch, denoiser step, rew/end step): "
        f"{[(c['epoch'], c['denoiser_step'], c['rew_end_step']) for c in trainer.calibrations]}; "
        f"{fresh['checked']} AC steps, {fresh['stale']} on stale int8 weights")
    check(fresh["stale"] == 0 and fresh["checked"] == 8, "an AC step ran on stale int8 weights")
    check(d_counts == [20, 30, 40], f"recalibrated at denoiser steps {d_counts}")

    # the background pool against a rebuild from the same ids and snapshot
    pm = trainer._pool_manager
    bg = pm._next_pool
    check(bg is not None, "no background pool was left to check")
    check(fresh["during_build"] > 0, "no AC step ran while a pool was being built")
    sync_pool = pm.build_pool(ids=pm.last_ids)
    torch.cuda.synchronize()
    check(torch.equal(bg.obs, sync_pool.obs) and torch.equal(bg.act, sync_pool.act),
          "the background pool's segments differ from the rebuild's")
    pool_err = {}
    for k in ("hx", "cx", "feats"):
        a, b = getattr(bg, k).float(), getattr(sync_pool, k).float()
        pool_err[k] = (a - b).abs().max().item() / max(1e-30, b.abs().max().item())
        check(pool_err[k] <= 1 / 64, f"the background pool's {k} differs from the rebuild's")
    log(f"[trainer] IC pool: {pm.builds - 1} builds ({pm.background_builds} in the background, "
        f"{fresh['during_build']} AC steps dispatched while one ran), {pm.swaps} swaps; the last "
        f"background pool against a synchronous rebuild from its ids and weight snapshot: "
        f"obs and act equal, max |diff| / max |value| {pool_err}")

    # the agent snapshot loads back into a fresh agent with equal outputs
    path = get_path_agent_ckpt(run_dir / "checkpoints", -1)
    fresh_agent = Agent(trainer.agent.cfg, trainer._compute_dtype, device="cuda")
    fresh_agent.load(path)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    acfg = trainer.agent.cfg
    size, n = cfg.env.train.size, acfg.denoiser.inner_model.num_steps_conditioning
    obs = torch.rand((4, n, size, size, 3), generator=g, device="cuda") * 2 - 1
    act = torch.randint(0, acfg.num_actions, (4, n), generator=g, device="cuda")
    carry = (torch.zeros(4, acfg.actor_critic.lstm_dim, device="cuda"),) * 2
    outs = []
    for a in (trainer.agent, fresh_agent):
        ac = a.actor_critic.head(a.actor_critic.encode(obs[:, -1]), carry)
        lr, le, _ = a.rew_end_model.predict_rew_end(obs[:, :-1], act[:, :-1], obs[:, 1:])
        den = a.denoiser.denoise(obs[:, -1], 1.0,
                                 obs.movedim(1, 3).reshape(4, size, size, 3 * n), act)
        outs.append([ac.logits_act, ac.val, lr, le, den])
    check(all(torch.equal(x, y) for x, y in zip(*outs)),
          "the loaded snapshot's outputs differ from the trainer's agent's")
    log(f"[trainer] the agent snapshot {path.name} loads into a fresh Agent: policy, rew/end "
        f"and denoiser outputs equal bit for bit")
    # resume: the saved state, bit for bit
    cfg2 = load_config(TRAINER_OVERRIDES + ["common.resume=True"])
    t0 = time.perf_counter()
    trainer2 = Trainer(cfg2, Path(__file__).resolve().parent, run_dir=run_dir, device="cuda")
    n = states_equal(saved["state"], trainer2.state_dict(), "resume")
    check(trainer2.train_dataset.num_steps == trainer.train_dataset.num_steps, "resume: dataset")
    log(f"[trainer] resume: a second Trainer with common.resume=True equals the last saved "
        f"state bit for bit ({n} tensors: weights, AdamW moments and steps; counters; both "
        f"datasets' index) in {time.perf_counter() - t0:.1f} s")
    del trainer2

    # host-device syncs per step of each component
    syncs = {name: sync_points(fn) for name, fn in (
        ("actor_critic", trainer.ac_train_step), ("denoiser", trainer.denoiser_train_step),
        ("rew_end_model", trainer.rew_end_train_step))}
    log(f"[sync] trainer steps: {syncs}")
    check(not syncs["denoiser"] and not syncs["rew_end_model"],
          "a denoiser or rew/end step synchronised")
    check(sum(syncs["actor_critic"].values()) <= 1, "the AC step synchronised more than once")

    result = dict(run_s=run_s, init_s=init_s, timings=trainer.timings, final_protocol=final,
                  launches=launches, rew_end_windows_with_end=ends,
                  rew_end_windows=windows["all"], calibrations=trainer.calibrations,
                  pool=dict(builds=pm.builds - 1, background=pm.background_builds,
                            swaps=pm.swaps, steps_during_build=fresh["during_build"],
                            err=pool_err),
                  sync_points=syncs, epochs=trainer.epoch)
    del trainer, fresh_agent
    tmp.cleanup()
    return shapes, result


# ---------------------------------------------------------------------------
# The two-stage (csgo) world model

# the play paths' counted steps: TS_WARMUP, then TS_STEPS x TS_REPS in turns with the other
# path (bench_two_stage.py's 3 warm-up steps and 60 timed steps, best of 3)
TS_WARMUP, TS_STEPS, TS_REPS = 3, 60, 3
TS_REF_STEPS = 3
# a whole play step card vs CPU: the share of the frame's values allowed more than 2
# levels apart (a low-res pixel one level apart moves the upsampler's conditioning, and
# its sampling loop can carry that a few levels)
STEP_FAR_SHARE = 0.01
TS_NUM_ACTIONS = 4  # bench_two_stage.py NUM_ACTIONS
TS_PLAY = ("ts_play_bf16", "ts_play_int8")
TS_TRAINER_OVERRIDES = [
    # agent=csgo at its published widths on env=fake's 64x64 frames, the wm_only mode on a
    # static dataset the phase writes; trainer.yaml's batch sizes (denoiser 32, upsampler
    # 16 x 2 frames); cut to two epochs of 10 and 5 steps with evaluation
    "agent=csgo", "env=fake", f"common.seed={SEED}", "training.wm_only=True",
    "training.num_final_epochs=2", "evaluation.every=1",
    "denoiser.training.steps_first_epoch=10", "denoiser.training.steps_per_epoch=5",
    "upsampler.training.steps_first_epoch=10", "upsampler.training.steps_per_epoch=5",
]
TS_EPISODES = {"train": 8, "test": 2}  # fake-env episodes of up to 100 steps


def ts_provider(size: int, n_cond: int, lstm_dim: int, seed: int):
    """bench_two_stage.py's synthetic IC provider at full resolution: random uint8 frames
    and actions, small random rew/end LSTM states, from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def provider(n: int):
        obs = rng.integers(0, 255, (n, n_cond, size, size, 3), dtype=np.uint8)
        act = rng.integers(0, TS_NUM_ACTIONS, (n, n_cond)).astype(np.int32)
        hx = rng.normal(size=(n, lstm_dim)).astype(np.float32) * 0.1
        cx = rng.normal(size=(n, lstm_dim)).astype(np.float32) * 0.1
        return obs, act, hx, cx

    return provider


def ts_nets(agent) -> list:
    """The three nets the int8 play path calibrates (bench_two_stage.py:111-134)."""
    return [agent.denoiser.inner_model, agent.rew_end_model.net, agent.upsampler.inner_model]


def ts_calibrate(env, agent, provider, sites) -> list:
    """bench_two_stage.py's calibration, as ``play --int8`` runs it (play.py
    ``calibrate_int8``): eight ICs area-downsampled for the dynamics denoiser and the
    rew/end model, their last frames upsampled for the upsampler."""
    import torch
    from diamond_tpu_torch.play import calibrate_int8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    colls = calibrate_int8(env.engine, agent, provider, sites, generator=gen)
    return [colls[n] for n in ("denoiser", "rew_end_model", "upsampler")]


def ts_counted(label, fn, totals) -> None:
    """``fn()`` with every launch count set to 0 just before and read just after, added
    to ``totals[label]`` (launches, signatures)."""
    import torch
    from diamond_tpu_torch import ops

    count_reset()
    fn()
    torch.cuda.synchronize()
    launches, shapes = totals.setdefault(label, ({}, {}))
    for name in KERNELS:
        w, sigs = getattr(ops, name), shapes.setdefault(name, {})
        launches[name] = launches.get(name, 0) + w.launches
        for sig, c in w.shapes.items():
            sigs[sig] = sigs.get(sig, 0) + c


def ts_play_phase(smi):
    """The two-stage play path (the csgo agent at its full widths: the dynamics U-Net at
    16x16, the upsampler's at 64x64, 4 actions, bf16, 3 Euler steps for both stages):
    ``WorldModelEnv`` with the upsampler at num_envs = 1 on bench_two_stage.py's synthetic
    IC provider. bf16, then int8 calibrated as bench_two_stage.py does, in turns: 3
    warm-up steps each, then 60 steps x 3 repetitions of each path alternately; every
    chunk counted (launch counts set to 0 just before it, read just after). Per path
    ``two_stage_play_fps_batch1`` (best and median of the repetitions), syncs per step
    over one horizon, one step profiled. Returns (signatures, launches, result, agent,
    env, cfg)."""
    import numpy as np
    import torch
    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.envs.wm_env_stateful import WorldModelEnv
    from diamond_tpu_torch.envs.world_model_env import ImaginationEngine
    from diamond_tpu_torch.models import Agent

    cfg = load_config(["agent=csgo", "env=fake"])
    acfg = cfg.agent
    acfg.num_actions = TS_NUM_ACTIONS
    acfg.__post_init__()
    gen = torch.Generator().manual_seed(SEED + 20)
    agent = Agent(acfg, getattr(torch, cfg.tpu.compute_dtype), device="cuda", generator=gen)
    for net in agent.nets.values():
        perturb_zero_leaves(net, gen)
    engine = ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic,
                               cfg.world_model_env)
    size = cfg.env.train.size
    provider = ts_provider(size, acfg.denoiser.inner_model.num_steps_conditioning,
                           acfg.rew_end_model.lstm_dim, SEED + 21)
    env = WorldModelEnv(engine, provider, 1, seed=SEED, upsampler=agent.upsampler)
    f = env.cascade.factor
    log(f"[two_stage] agent=csgo: dynamics denoiser {acfg.denoiser.inner_model.channels} at "
        f"{size // f}x{size // f} ({acfg.denoiser.inner_model.num_steps_conditioning} frames), "
        f"upsampler {acfg.upsampler.inner_model.channels} at {size}x{size} (factor {f}), "
        f"rew/end {acfg.rew_end_model.channels} LSTM {acfg.rew_end_model.lstm_dim} and AC at "
        f"{acfg.rew_end_model.img_size}x{acfg.rew_end_model.img_size}, "
        f"{cfg.world_model_env.diffusion_sampler.num_steps_denoising} Euler steps both stages, "
        f"{cfg.tpu.compute_dtype}, {TS_NUM_ACTIONS} actions")
    nets = ts_nets(agent)
    env.reset(seed=SEED)
    colls = ts_calibrate(env, agent, provider, cfg.tpu.int8_sites)
    log(f"[two_stage] calibrated {cfg.tpu.int8_sites!r}: "
        + ", ".join(f"{n} {num_sites(c)} sites" for n, c in
                    zip(("denoiser", "rew/end", "upsampler"), colls)))
    totals, times = {}, {label: [] for label in TS_PLAY}
    obs_seen = []
    act_of = lambda i: [i % TS_NUM_ACTIONS]  # noqa: E731

    def steps(n):
        def run():
            for i in range(n):
                obs_seen.append(env.step(act_of(i))[0])
        return run

    for label in TS_PLAY:  # warm-up, counted
        set_int8(nets, colls, label.endswith("int8"))
        ts_counted(label, steps(TS_WARMUP), totals)
    for _ in range(TS_REPS):
        for label in TS_PLAY:
            set_int8(nets, colls, label.endswith("int8"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts_counted(label, steps(TS_STEPS), totals)
            times[label].append(time.perf_counter() - t0)
    check(all(o.dtype == np.uint8 and o.shape == (1, size, size, 3) for o in obs_seen),
          "two-stage play: frames not uint8 (1, 64, 64, 3)")
    runs = TS_WARMUP + TS_STEPS * TS_REPS
    result, launches, shapes = {}, {}, {}
    for label in TS_PLAY:
        launches[label], shapes[label] = totals[label]
        fps = sorted(TS_STEPS / s for s in times[label])
        result[label] = dict(fps_best=fps[-1], fps_median=fps[len(fps) // 2], fps_runs=fps,
                             launches=launches[label], steps=runs)
        log(f"[two_stage] {label}: two_stage_play_fps_batch1 = {fps[-1]:.1f} frames/s (best of "
            f"{TS_REPS} x {TS_STEPS} steps in turns with the other path; median "
            f"{fps[len(fps) // 2]:.1f}, runs {[round(v, 1) for v in fps]}) on {smi}")
        log(f"[launches] {label}, over {runs} steps: {launches[label]}")
    for name, (_, _, paths) in KERNELS.items():
        for label in TS_PLAY:
            if label in paths:
                check(launches[label][name] > 0, f"{name} was not launched on {label}")
    check(all(launches["ts_play_bf16"][n] == 0 for n in INT8_KERNELS),
          "an int8 kernel ran on the two-stage bf16 play path")
    for label in TS_PLAY:
        set_int8(nets, colls, label.endswith("int8"))
        horizon = cfg.world_model_env.horizon
        syncs = sync_points(steps(horizon))
        per_step = sum(syncs.values()) / horizon
        result[label]["sync_points"], result[label]["syncs_per_step"] = syncs, per_step
        log(f"[sync] {label}: {per_step:.3f} host-device synchronisations per step over one "
            f"horizon ({horizon} steps, a refill at its end) {syncs}")
        prof = profile_run(steps(1), label, "play step")
        ms = 1e3 / result[label]["fps_median"]
        log_unprofiled_idle(prof, ms, f"{label} step")
        result[label]["profile"] = prof
        result[label]["idle_share_unprofiled"] = 1 - prof["busy_ms"] / ms
    set_int8(nets, colls, False)
    return shapes, launches, result, agent, cfg


def ts_play_reference(agent, cfg):
    """TS_REF_STEPS play steps in f32 on the card (kernels, TF32 off) against the CPU
    (plain versions), the same weights, ICs and injected draws, each stage of a step
    from the same inputs: the card's env starts each step from the CPU env's state, its
    transition (``_wm_transition``) gives equal rewards, ends and truncations and the
    low-res frame within one uint8 grid level, and its upsampler super-resolves the CPU's
    low-res frame to within one level of the CPU's. (A pixel that one ulp moves across
    the floor onto the grid is one level apart; carried into the next steps' conditioning
    and through the upsampler's gain it grows, so each stage is held to its own inputs.)
    Then one whole ``WorldModelEnv.step`` on both from the same state: rewards, ends and
    truncations equal, at most STEP_FAR_SHARE of the frame's values more than 2 levels
    apart (their largest difference reported); and the card's step hands its own stages
    on: its low-res frame is its transition's and the frame it shows is its upsampler's
    output on that frame with the step's upsampler latent, bit for bit."""
    import numpy as np
    import torch
    from diamond_tpu_torch.data.episode import obs_to_uint8
    from diamond_tpu_torch.envs.wm_env_stateful import StepDraws, WorldModelEnv
    from diamond_tpu_torch.envs.world_model_env import ImaginationEngine, ImagState, gumbel
    from diamond_tpu_torch.models import Agent

    acfg = agent.cfg
    n_cond = acfg.denoiser.inner_model.num_steps_conditioning
    ics = ts_provider(cfg.env.train.size, n_cond, acfg.rew_end_model.lstm_dim, SEED + 22)(4)
    g = torch.Generator().manual_seed(SEED + 23)
    low, high = acfg.rew_end_model.img_size, cfg.env.train.size
    draws = [StepDraws(torch.randn((1, low, low, 3), generator=g), gumbel((1, 3), g, "cpu"),
                       gumbel((1, 2), g, "cpu"), torch.randn((1, high, high, 3), generator=g))
             for _ in range(TS_REF_STEPS + 1)]
    envs = []  # (device, env): the card's, then the CPU's
    for dev in ("cuda", "cpu"):
        a = Agent(acfg, torch.float32, device=dev)
        for name, net in a.nets.items():
            net.load_state_dict(agent.nets[name].state_dict())
        eng = ImaginationEngine(a.denoiser, a.rew_end_model, a.actor_critic, cfg.world_model_env)
        env = WorldModelEnv(eng, lambda n: tuple(x[:n] for x in ics), 1, upsampler=a.upsampler)
        env.reset()
        envs.append((dev, env))
    card, cpu = envs[0][1], envs[1][1]
    to_card = lambda st: ImagState(**{k: getattr(st, k).cuda()  # noqa: E731
                                      for k in st.__dataclass_fields__})
    lv = lambda a, b: int((torch.round((a.cpu().clamp(-1, 1) + 1) * 127.5)  # noqa: E731
                           - torch.round((b.clamp(-1, 1) + 1) * 127.5)).abs().max())
    low_levels = high_levels = 0
    for i, dr in enumerate(draws[:TS_REF_STEPS]):
        card._st = to_card(cpu._st)
        act = torch.tensor([i % TS_NUM_ACTIONS], dtype=torch.int32)
        (_, c_low, *c_flags), (cpu_st, next_low, *p_flags) = (
            env.engine._wm_transition(env._st, act.to(dev), dr.x_init.to(dev),
                                      dr.gumbel_rew.to(dev), dr.gumbel_end.to(dev))
            for dev, env in envs)
        for c, p, what in zip(c_flags, p_flags, ("rewards", "ends", "truncations")):
            check(torch.equal(c.cpu(), p),
                  f"two-stage play reference step {i}: {what} differ card vs CPU")
        low_levels = max(low_levels, lv(c_low, next_low))
        up_card = card.cascade.upsample(next_low.cuda(), x_init=dr.x_init_high.cuda())
        up_cpu = cpu.cascade.upsample(next_low, x_init=dr.x_init_high)
        high_levels = max(high_levels, lv(up_card, up_cpu))
        cpu._st = cpu_st
    check(low_levels <= 1 and high_levels <= 1, f"two-stage play reference: low-res frames "
          f"{low_levels} and full-resolution frames {high_levels} grid levels apart card vs CPU")
    st0, dr = to_card(cpu._st), draws[-1]
    dr_card = StepDraws(*(x.cuda() for x in dr))
    _, low_own, *_ = card.engine._wm_transition(
        st0, torch.tensor([1], dtype=torch.int32, device="cuda"), dr_card.x_init,
        dr_card.gumbel_rew, dr_card.gumbel_end)
    high_own = obs_to_uint8(card.cascade.upsample(low_own, x_init=dr_card.x_init_high))
    card._st = st0
    whole = [env.step([1], StepDraws(*(x.to(dev) for x in dr))) for dev, env in envs]
    for k, what in ((1, "rewards"), (2, "ends"), (3, "truncations")):
        check(np.array_equal(whole[0][k], whole[1][k]),
              f"two-stage play reference, a whole step: {what} differ card vs CPU")
    obs, info = whole[0][0], whole[0][4]
    shown = info.get("final_observation", obs)  # the frame shown before a refill
    check(np.array_equal(info["low_res_obs"], obs_to_uint8(low_own).cpu().numpy())
          and np.array_equal(shown, high_own.cpu().numpy()),
          "two-stage play reference: the card's step does not show its upsampler's output "
          "on its own low-res frame")
    d = np.abs(whole[0][0].astype(int) - whole[1][0].astype(int))
    step_levels, far = int(d.max()), float((d > 2).mean())
    check(far <= STEP_FAR_SHARE, f"two-stage play reference, a whole step: {far:.3%} of the "
          f"frame's values more than 2 levels apart card vs CPU (at most {STEP_FAR_SHARE:.0%})")
    log(f"[reference] two-stage play, {TS_REF_STEPS} steps at B=1 f32 card vs CPU plain, each "
        f"stage from the same inputs: rewards/ends/truncations equal, low-res frames within "
        f"{low_levels} and the upsampler's frames within {high_levels} grid level(s); one whole "
        f"WorldModelEnv.step from the same state: rewards/ends equal, frames up to "
        f"{step_levels} level(s) apart, {far:.3%} of values more than 2; the card's step shows "
        f"its upsampler's output on its own low-res frame, bit for bit")
    return dict(low_res_max_levels=low_levels, frame_max_levels=high_levels,
                whole_step_frame_levels=step_levels, whole_step_far_share=far)


def ts_batch(b: int, t: int, size: int, gen):
    """Synthetic uint8 segments (b, t, size, size, 3) and random actions, every frame
    real, as a DeviceBatch on the card."""
    import torch
    from diamond_tpu_torch.data.segment import DeviceBatch

    obs = torch.randint(0, 256, (b, t, size, size, 3), generator=gen, dtype=torch.uint8).cuda()
    act = torch.randint(0, TS_NUM_ACTIONS, (b, t), generator=gen, dtype=torch.int32).cuda()
    z = dict(device="cuda", dtype=torch.int32)
    return DeviceBatch(obs=obs, act=act, rew=torch.zeros((b, t), device="cuda"),
                       end=torch.zeros((b, t), **z), trunc=torch.zeros((b, t), **z),
                       mask_padding=torch.ones((b, t), dtype=torch.bool, device="cuda"),
                       final_obs=torch.zeros((b, size, size, 3), dtype=torch.uint8,
                                             device="cuda"),
                       has_final_obs=torch.zeros((b,), dtype=torch.bool, device="cuda"))


def ts_step_phase(agent, cfg, which, smi):
    """``train_step_phase`` of a two-stage train step: ``up`` the upsampler step at
    trainer.yaml's ``upsampler`` section (B 16 x T 2 = 32 frames at 64x64, time folded
    into batch); ``den`` the two-stage denoiser step (B 32 segments of 6 full-resolution
    frames, downsampled by 4 in the step, two windows at 16x16). Returns (signatures,
    result)."""
    import torch
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.training import (_two_stage_obs, make_denoiser_train_step,
                                            make_upsampler_train_step)

    size, f = cfg.env.train.size, agent.cfg.downsample_factor
    gen = torch.Generator().manual_seed(SEED + 24)
    if which == "up":
        sec = cfg.upsampler
        b, t = sec.training.batch_size, sec.training.seq_length
        batch = ts_batch(b, t, size, gen)
        return train_step_phase(
            "ts_up_step", agent.upsampler, sec, make_upsampler_train_step, batch, 1, b * t,
            "upsampler frames",
            lambda up, g: up.loss_upsampler(obs_to_float(batch.obs), batch.mask_padding,
                                            sec.sigma_distribution, generator=g)[0],
            smi, " (time folded into batch)")
    sec = cfg.denoiser
    n = agent.cfg.denoiser.inner_model.num_steps_conditioning
    b, t = sec.training.batch_size, n + 1 + sec.training.num_autoregressive_steps
    batch = ts_batch(b, t, size, gen)
    make = lambda den, tx, sigma: make_denoiser_train_step(  # noqa: E731
        den, tx, sigma, downsample_factor=f)
    return train_step_phase(
        "ts_den_step", agent.denoiser, sec, make, batch, t - n, b * (t - n),
        "two-stage denoiser samples",
        lambda den, g: den.loss(_two_stage_obs(batch.obs, f), batch.act, batch.mask_padding,
                                sec.sigma_distribution, generator=g)[0],
        smi, f" (downsampled by {f} in the step: {t - n} windows at {size // f}x{size // f})")


def ts_static_dataset(root: Path, size: int) -> dict:
    """A static dataset of fake-env episodes at size x size (the env's own frames,
    random actions, up to 100 steps, deaths with their final frames), written where
    ``static_dataset.path`` reads it. Returns the steps per split."""
    import numpy as np
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.data.episode import Episode
    from diamond_tpu_torch.envs.fake_env import FakeEnv

    rng = np.random.default_rng(SEED + 26)
    steps = {}
    for split, n in TS_EPISODES.items():
        ds = Dataset(root / split, f"{split}_dataset")
        env = FakeEnv(1, size=size)
        obs, _ = env.reset(seed=SEED + len(split))
        for _ in range(n):
            rec = {k: [] for k in ("obs", "act", "rew", "end", "trunc")}
            while True:
                a = rng.integers(0, FakeEnv.num_actions, 1)
                nxt, rew, end, trunc, info = env.step(a)
                for k, v in (("obs", obs[0]), ("act", a[0]), ("rew", rew[0]), ("end", end[0]),
                             ("trunc", trunc[0])):
                    rec[k].append(v)
                obs = nxt
                if end[0] or trunc[0]:
                    break
            ds.add_episode(Episode(
                obs=np.stack(rec["obs"]), act=np.asarray(rec["act"], np.int32),
                rew=np.asarray(rec["rew"], np.float32), end=np.asarray(rec["end"], np.uint8),
                trunc=np.asarray(rec["trunc"], np.uint8),
                info={"final_observation": info["final_observation"][0]}))
        ds.save_to_default_path()
        steps[split] = ds.num_steps
    return steps


def ts_trainer_phase(smi):
    """The two-stage trainer (``Trainer`` with agent=csgo, training.wm_only=True, what
    ``python -m diamond_tpu_torch.main agent=csgo training.wm_only=True
    static_dataset.path=...`` runs) on a static dataset of fake-env episodes at 64x64,
    cut to two epochs with evaluation (TS_TRAINER_OVERRIDES): counts set to 0 around the
    run, each part's seconds, the denoiser's and upsampler's steps synchronising nowhere,
    the agent snapshot loaded into a fresh Agent (equal outputs of all four models) and a
    resumed Trainer equal to the saved state bit for bit. Returns (signatures, result)."""
    import copy
    import tempfile

    import torch
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.trainer import Trainer
    from diamond_tpu_torch.utils import get_path_agent_ckpt

    tmp = tempfile.TemporaryDirectory(prefix="diamond_two_stage_")
    root = Path(tmp.name)
    overrides = TS_TRAINER_OVERRIDES + [f"static_dataset.path={root / 'static'}"]
    cfg = load_config(overrides)
    t0 = time.perf_counter()
    ds_steps = ts_static_dataset(root / "static", cfg.env.train.size)
    log(f"[ts_trainer] static dataset of fake-env episodes at {cfg.env.train.size}x"
        f"{cfg.env.train.size}: {ds_steps} steps, written in {time.perf_counter() - t0:.1f} s; "
        f"config {TS_TRAINER_OVERRIDES}")
    run_dir = root / "run"
    run_dir.mkdir()
    count_reset()
    trainer = Trainer(cfg, Path(__file__).resolve().parent, run_dir=run_dir, device="cuda")
    saved = {}
    save = trainer.save_checkpoint

    def save_and_keep():
        save()
        saved["state"] = copy.deepcopy(trainer.state_dict())
    trainer.save_checkpoint = save_and_keep
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    shapes = {name: dict(getattr(ops, name).shapes) for name in KERNELS}
    check(trainer.epoch == 2, f"the two-stage trainer ran {trainer.epoch} epochs, not 2")
    for t in trainer.timings:
        log(f"[ts_trainer] epoch {t['epoch']}: " + "; ".join(
            f"{name} {t[name + '_s']:.2f} s ({t[name + '_steps']} steps, "
            f"{t[name + '_s'] / t[name + '_steps'] * 1e3:.1f} ms/step)"
            for name in ("denoiser", "upsampler") if name + "_s" in t)
            + f"; eval {t.get('eval_s', 0.0):.2f} s, checkpoint {t['checkpoint_s']:.2f} s")
    keys = {k for line in (run_dir / "metrics.jsonl").read_text().splitlines()
            for k in json.loads(line)}
    for k in ("denoiser/train/loss_denoising", "upsampler/train/loss_denoising",
              "denoiser/test/loss_denoising", "upsampler/test/loss_denoising"):
        check(k in keys, f"the two-stage trainer logged no {k}")
    check(not any(k.startswith(("rew_end_model/", "actor_critic/")) for k in keys),
          "the wm_only trainer trained or evaluated the rew/end model or the actor-critic")
    log(f"[ts_trainer] {trainer.epoch} epochs in {run_s:.1f} s on {smi}")
    log(f"[launches] ts_trainer, over the run: {launches}")
    for name, (_, _, paths) in KERNELS.items():
        if "ts_trainer" in paths:
            check(launches[name] > 0, f"{name} was not launched by the two-stage trainer")

    # the agent snapshot loads into a fresh agent with equal outputs
    path = get_path_agent_ckpt(run_dir / "checkpoints", -1)
    fresh_agent = Agent(trainer.agent.cfg, trainer._compute_dtype, device="cuda")
    fresh_agent.load(path)
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    acfg, size, f = trainer.agent.cfg, cfg.env.train.size, trainer.agent.cfg.downsample_factor
    n = acfg.denoiser.inner_model.num_steps_conditioning
    low = torch.rand((2, n, size // f, size // f, 3), generator=g, device="cuda") * 2 - 1
    high = torch.rand((2, size, size, 3), generator=g, device="cuda") * 2 - 1
    act = torch.randint(0, acfg.num_actions, (2, n), generator=g, device="cuda")
    outs = []
    for a in (trainer.agent, fresh_agent):
        lr, le, _ = a.rew_end_model.predict_rew_end(low[:, :-1], act[:, :-1], low[:, 1:])
        den = a.denoiser.denoise(low[:, -1], 1.0, low.movedim(1, 3).reshape(
            2, size // f, size // f, 3 * n), act)
        up = a.upsampler.denoise(high, 1.0, high, None)
        outs.append([lr, le, den, up])
    check(all(torch.equal(x, y) for x, y in zip(*outs)),
          "the two-stage snapshot's outputs differ from the trainer's agent's")
    log(f"[ts_trainer] the agent snapshot {path.name} loads into a fresh Agent: rew/end, "
        f"denoiser and upsampler outputs equal bit for bit")
    cfg2 = load_config(overrides + ["common.resume=True"])
    trainer2 = Trainer(cfg2, Path(__file__).resolve().parent, run_dir=run_dir, device="cuda")
    n_t = states_equal(saved["state"], trainer2.state_dict(), "two-stage resume")
    log(f"[ts_trainer] resume: a second Trainer with common.resume=True equals the last saved "
        f"state bit for bit ({n_t} tensors, the upsampler's weights, moments and steps "
        f"among them)")
    del trainer2
    syncs = {name: sync_points(fn) for name, fn in (
        ("denoiser", trainer.denoiser_train_step), ("upsampler", trainer.upsampler_train_step))}
    log(f"[sync] two-stage trainer steps: {syncs}")
    check(not syncs["denoiser"] and not syncs["upsampler"],
          "a two-stage denoiser or upsampler step synchronised")
    result = dict(run_s=run_s, timings=trainer.timings, launches=launches, epochs=trainer.epoch,
                  dataset_steps=ds_steps, sync_points=syncs, resume_tensors=n_t)
    del trainer, fresh_agent
    tmp.cleanup()
    return shapes, result


def two_stage_phase(smi):
    """The [two_stage] phase: play (both paths), the card-vs-CPU play reference, the
    upsampler and two-stage denoiser steps, the wm_only trainer. Returns (signatures per
    path, launches per path, runs per path, result)."""
    shapes, launches, result, agent, cfg = ts_play_phase(smi)
    result["reference_play"] = ts_play_reference(agent, cfg)
    for which in ("up", "den"):
        label = "ts_up_step" if which == "up" else "ts_den_step"
        shapes[label], result[label] = ts_step_phase(agent, cfg, which, smi)
        launches[label] = result[label]["launches"]
    shapes["ts_trainer"], result["ts_trainer"] = ts_trainer_phase(smi)
    launches["ts_trainer"] = result["ts_trainer"]["launches"]
    runs = {p: result[p]["steps"] for p in ("ts_play_bf16", "ts_play_int8", "ts_up_step",
                                             "ts_den_step")}
    runs["ts_trainer"] = result["ts_trainer"]["epochs"]
    return shapes, launches, runs, result


# ---------------------------------------------------------------------------
# The play app (python -m diamond_tpu_torch.play), driven headless

PLAY_AGENTS = {"default": ["agent=default", "env=fake"], "csgo": ["agent=csgo", "env=fake"]}
PLAY_PRECISIONS = ("bf16", "int8")
PLAY_CONTROLS = ("human", "policy")
PLAY_PATHS = tuple(f"play_{a}_{p}" for a in PLAY_AGENTS for p in PLAY_PRECISIONS)
# each agent x precision x control: PLAY_WARMUP frames, then PLAY_FRAMES x PLAY_REPS in
# turns with the others (bench_two_stage.py's 3 warm-up and 60 timed steps, best of 3)
PLAY_WARMUP, PLAY_FRAMES, PLAY_REPS = 3, 60, 3
PLAY_SYNC_FRAMES = 15
PLAY_PROFILE_FRAMES = 5  # profiled together: a frame's launches and device time depend on
                         # whether it refills (an end draws new ICs through the provider)
PLAY_HORIZON = 50        # play.py's default --horizon
PLAY_REC_HORIZON = 8
PLAY_REC_EPISODES = 2
PLAY_REF_FRAMES = 3


def play_run_dir(root: Path, overrides, seed: int) -> Path:
    """A run dir as ``python -m diamond_tpu_torch.main`` leaves it: the resolved
    ``config/trainer.json`` and an agent snapshot (checkpoint.py) of seeded random weights
    at the config's full widths, every zero-init weight perturbed."""
    import copy

    import torch
    from diamond_tpu_torch.config import load_config, save_config
    from diamond_tpu_torch.envs.fake_env import FakeEnv
    from diamond_tpu_torch.models import Agent

    cfg = load_config(overrides + [f"common.seed={seed}"])
    save_config(cfg, root / "config" / "trainer.json")
    acfg = copy.deepcopy(cfg.agent)
    acfg.num_actions = FakeEnv.num_actions
    acfg.__post_init__()
    gen = torch.Generator().manual_seed(seed)
    agent = Agent(acfg, torch.float32, device="cpu", generator=gen)
    for net in agent.nets.values():
        perturb_zero_leaves(net, gen)
    (root / "checkpoints" / "agent_versions").mkdir(parents=True)
    agent.save(root / "checkpoints" / "agent_versions" / "agent_epoch_00001.npz")
    return root


def play_frames(app, n: int, human: bool, seen: list):
    """``n`` frames of ``app`` (a PlayEnv) in human control (scripted actions) or policy
    control, the frames shown kept in ``seen``."""
    def run():
        app.human = human
        for i in range(n):
            seen.append(app.step(i % app.agent.cfg.num_actions)[0])
    return run


def play_recording(run: Path, smi: str) -> dict:
    """``play -r --horizon PLAY_REC_HORIZON`` in human control until PLAY_REC_EPISODES
    episodes are recorded into ``dataset/rec_world_model_H``; the recording loaded with
    the port's Dataset, and ``play -d`` (DatasetEnv) stepped through those episodes,
    frame for frame the recorded ones."""
    import numpy as np
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.play import build_app, parse_args

    t0 = time.perf_counter()
    app = build_app(parse_args(["--run-dir", str(run), "-r", "--horizon", str(PLAY_REC_HORIZON),
                                "-n", "100"]), device="cuda")
    app.reset()
    frames = episodes = 0
    while episodes < PLAY_REC_EPISODES and frames < PLAY_REC_HORIZON * PLAY_REC_EPISODES:
        _, _, end, trunc, _ = app.step(frames % app.agent.cfg.num_actions)
        frames += 1
        episodes += end or trunc
    ds_dir = run / "dataset" / "rec_world_model_H"
    ds = Dataset(ds_dir, "rec_world_model_H")
    ds.load_from_default_path()
    check(ds.num_episodes >= PLAY_REC_EPISODES, f"play -r wrote {ds.num_episodes} episodes "
          f"in {frames} frames, not {PLAY_REC_EPISODES}")
    browser = build_app(parse_args(["--run-dir", str(run), "-d"]))
    check([d.name for d in browser.datasets] == ["rec_world_model_H"],
          f"play -d browses {[d.name for d in browser.datasets]}")
    obs, _ = browser.reset()
    for e in range(PLAY_REC_EPISODES):
        ep = ds.load_episode(e)
        got = [obs] + [browser.step(0)[0] for _ in range(len(ep) - 1)]
        check(all(np.array_equal(a, b) for a, b in zip(got, ep.obs)),
              f"play -d: episode {e}'s frames differ from the recording")
        browser.next_episode()
        obs, _ = browser.reset()
    lengths = [int(x) for x in ds.lengths]
    log(f"[play] recording: play -r --horizon {PLAY_REC_HORIZON} wrote {ds.num_episodes} "
        f"episodes ({lengths} frames) to dataset/rec_world_model_H in {frames} frames; play -d "
        f"stepped {PLAY_REC_EPISODES} of them frame for frame ({time.perf_counter() - t0:.1f} s, "
        f"the build included) on {smi}")
    return dict(episodes=ds.num_episodes, lengths=lengths, frames=frames)


def play_reference(app, cfg) -> dict:
    """PLAY_REF_FRAMES policy-controlled frames of the play app's agent in f32 on the card
    (kernels, TF32 off) against the CPU (plain versions): the same weights, the same ICs
    (from the app's own seed collection), the same injected draws (the policy's Gumbel
    noise, the sampler's latent, the reward and end Gumbels), each frame from the CPU's
    state (world model, frame, carry). Actions, rewards, ends and truncations equal; at
    most STEP_FAR_SHARE of a frame's values more than 2 levels apart."""
    import copy

    import numpy as np
    import torch
    from diamond_tpu_torch.envs.wm_env_stateful import StepDraws, WorldModelEnv
    from diamond_tpu_torch.envs.world_model_env import ImaginationEngine, ImagState, gumbel
    from diamond_tpu_torch.game.play_env import NamedEnv, PlayEnv
    from diamond_tpu_torch.models import Agent

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acfg = app.agent.cfg
    ics = app.envs[0].env._ic_provider(4)
    size, na = cfg.env.train.size, acfg.num_actions
    g = torch.Generator().manual_seed(SEED + 30)
    draws = [(gumbel((1, na), g, "cpu"),
              StepDraws(torch.randn((1, size, size, 3), generator=g), gumbel((1, 3), g, "cpu"),
                        gumbel((1, 2), g, "cpu")))
             for _ in range(PLAY_REF_FRAMES)]
    pes = []
    for dev in ("cuda", "cpu"):
        a = Agent(acfg, torch.float32, device=dev)
        for name, net in a.nets.items():
            net.load_state_dict(app.agent.nets[name].state_dict())
        eng = ImaginationEngine(a.denoiser, a.rew_end_model, a.actor_critic,
                                copy.deepcopy(app.envs[0].env.engine.cfg))
        wm = WorldModelEnv(eng, lambda n: tuple(x[:n] for x in ics), 1)
        pe = PlayEnv(a, [NamedEnv("world_model", wm)], cfg.env.keymap, 15)
        pe.reset()
        pe.human = False
        pes.append(pe)
    card, cpu = pes
    far_max, levels, logit_diff = 0.0, 0, 0.0
    for i, (g_pol, dr) in enumerate(draws):
        card.env._st = ImagState(**{k: getattr(cpu.env._st, k).cuda()
                                    for k in cpu.env._st.__dataclass_fields__})
        card._obs, card._carry = cpu._obs.copy(), tuple(t.cuda() for t in cpu._carry)
        acts = []
        for pe in pes:
            dev = pe.device
            a, out = pe.policy_step(pe._obs, pe._carry, g_pol.to(dev))
            acts.append((int(a.item()), out.logits_act.cpu()))
            pe.env.draw = lambda dr=dr, dev=dev: StepDraws(*(x.to(dev) for x in dr[:3]))
        check(acts[0][0] == acts[1][0], f"play reference frame {i}: actions differ card vs CPU")
        logit_diff = max(logit_diff, (acts[0][1] - acts[1][1]).abs().max().item())
        outs = [pe.step(0, gumbel_noise=g_pol.to(pe.device)) for pe in pes]
        for k, what in ((1, "rewards"), (2, "ends"), (3, "truncations")):
            check(outs[0][k] == outs[1][k], f"play reference frame {i}: {what} differ card vs CPU")
        d = np.abs(outs[0][0].astype(int) - outs[1][0].astype(int))
        levels, far_max = max(levels, int(d.max())), max(far_max, float((d > 2).mean()))
    check(far_max <= STEP_FAR_SHARE, f"play reference: {far_max:.3%} of a frame's values more "
          f"than 2 levels apart card vs CPU (at most {STEP_FAR_SHARE:.0%})")
    log(f"[reference] play, {PLAY_REF_FRAMES} policy-controlled frames of the default agent at "
        f"B=1 f32 card vs CPU plain, each from the CPU's state, the same draws: actions, "
        f"rewards, ends and truncations equal, logits within {logit_diff:.3g}, frames up to "
        f"{levels} level(s) apart, {far_max:.3%} of values more than 2")
    return dict(frames=PLAY_REF_FRAMES, max_logit_diff=logit_diff, frame_max_levels=levels,
                far_share=far_max)


def play_agent(name, overrides, root: Path, smi: str):
    """One agent's play app, built as ``python -m diamond_tpu_torch.play --run-dir <run>
    --horizon 50 --int8`` would (the default -n 1000 seed collection on env=fake, the
    world model calibrated; its bf16 path with the calibrations dropped), then driven
    directly: PLAY_WARMUP frames of each precision x control, PLAY_FRAMES x PLAY_REPS of
    each in turns (every chunk counted), the syncs of PLAY_SYNC_FRAMES frames and
    PLAY_PROFILE_FRAMES frames profiled of each, the horizon down and up, a cycle through
    the real envs. Returns (signatures, launches, frames counted per path, result, app,
    cfg, run dir)."""
    import numpy as np
    import torch
    from diamond_tpu_torch.ops import quant
    from diamond_tpu_torch.play import build_app, parse_args, run_config

    run = play_run_dir(root / name, overrides, SEED + 40)
    cfg = run_config(run)
    t0 = time.perf_counter()
    app = build_app(parse_args(["--run-dir", str(run), "--horizon", str(PLAY_HORIZON),
                                "--int8"]), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    agent = app.agent
    nets = [agent.denoiser.inner_model, agent.rew_end_model.net] + (
        [agent.upsampler.inner_model] if agent.upsampler is not None else [])
    colls = [quant.collection(n) for n in nets]
    check(all(colls), f"play --int8 ({name}) left a model uncalibrated")
    log(f"[play] {name}: built as `play --run-dir <run> --horizon {PLAY_HORIZON} --int8` in "
        f"{build_s:.1f} s (1,000 seed steps of env=fake under the policy, calibration "
        f"{cfg.tpu.int8_sites!r}: " + ", ".join(f"{num_sites(c)} sites" for c in colls)
        + f"), {cfg.tpu.compute_dtype}, {agent.cfg.num_actions} actions")
    app.reset()
    seen, totals = [], {}
    times = {(p, c): [] for p in PLAY_PRECISIONS for c in PLAY_CONTROLS}
    label = lambda p: f"play_{name}_{p}"  # noqa: E731
    for p in PLAY_PRECISIONS:
        for c in PLAY_CONTROLS:
            set_int8(nets, colls, p == "int8")
            ts_counted(label(p), play_frames(app, PLAY_WARMUP, c == "human", seen), totals)
    for _ in range(PLAY_REPS):
        for p in PLAY_PRECISIONS:
            for c in PLAY_CONTROLS:
                set_int8(nets, colls, p == "int8")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts_counted(label(p), play_frames(app, PLAY_FRAMES, c == "human", seen), totals)
                times[p, c].append(time.perf_counter() - t0)
    size = cfg.env.train.size
    check(all(o.dtype == np.uint8 and o.shape == (size, size, 3) for o in seen),
          f"play ({name}): frames not uint8 ({size}, {size}, 3)")
    frames = 2 * (PLAY_WARMUP + PLAY_FRAMES * PLAY_REPS)
    result = dict(build_s=build_s, frames_per_path=frames, seed_steps=1000)
    launches, shapes = {}, {}
    for p in PLAY_PRECISIONS:
        launches[label(p)], shapes[label(p)] = totals[label(p)]
        log(f"[launches] {label(p)}, over {frames} frames: {launches[label(p)]}")
        for k, (_, _, paths) in KERNELS.items():
            if label(p) in paths:
                check(launches[label(p)][k] > 0, f"{k} was not launched on {label(p)}")
    check(all(launches[label("bf16")][k] == 0 for k in INT8_KERNELS),
          f"an int8 kernel ran on {label('bf16')}")
    for p in PLAY_PRECISIONS:
        set_int8(nets, colls, p == "int8")
        for c in PLAY_CONTROLS:
            fps = sorted(PLAY_FRAMES / s for s in times[p, c])
            syncs = sync_points(play_frames(app, PLAY_SYNC_FRAMES, c == "human", seen))
            per_frame = sum(syncs.values()) / PLAY_SYNC_FRAMES
            prof = profile_run(play_frames(app, PLAY_PROFILE_FRAMES, c == "human", seen),
                               f"{label(p)}_{c}", f"{PLAY_PROFILE_FRAMES} play frames")
            ms = 1e3 / fps[len(fps) // 2]
            calls, busy = (prof[k] / PLAY_PROFILE_FRAMES for k in ("launches", "busy_ms"))
            r = dict(fps_best=fps[-1], fps_median=fps[len(fps) // 2], fps_runs=fps,
                     ms_per_frame=ms, syncs_per_frame=per_frame, sync_points=syncs,
                     launch_calls_per_frame=calls, busy_ms=busy, idle_share=1 - busy / ms,
                     profile=prof)
            result[f"{p}_{c}"] = r
            log(f"[play] play_fps_batch1 {name} {p} {c}: {r['fps_best']:.1f} frames/s best, "
                f"{r['fps_median']:.1f} median ({PLAY_REPS} x {PLAY_FRAMES} frames in turns, "
                f"runs {[round(v, 1) for v in fps]}), {ms:.1f} ms per frame; "
                f"{per_frame:.3f} host-device syncs per frame over {PLAY_SYNC_FRAMES} {syncs}; "
                f"{calls:.0f} kernel launch calls and {busy:.2f} ms device busy a frame over "
                f"{PLAY_PROFILE_FRAMES} profiled frames, idle {100 * r['idle_share']:.1f} % of "
                f"the median frame; on {smi}")
    set_int8(nets, colls, True)  # the app as built, for the checks below
    wm = app.envs[0].env
    app.change_horizon(5 - PLAY_HORIZON)
    check(wm.horizon == 5 and wm.engine.cfg.horizon == 5, "play: the horizon did not go down")
    n, lengths = 0, []
    app.reset()
    app.human = True
    for i in range(12):
        _, _, end, trunc, _ = app.step(i % agent.cfg.num_actions)
        n += 1
        if end or trunc:
            lengths.append(n)
            n = 0
    check(lengths and max(lengths) <= 5, f"play: episodes of {lengths} frames at horizon 5")
    app.change_horizon(PLAY_HORIZON - 5)
    check(wm.horizon == PLAY_HORIZON, "play: the horizon did not go back up")
    cycled = []
    for _ in app.envs:
        app.cycle_env(1)
        cycled.append(app.env_name)
        for c in PLAY_CONTROLS:
            play_frames(app, 3, c == "human", seen)()
    check(cycled == ["test", "train", "world_model"], f"play: cycled through {cycled}")
    log(f"[play] {name}: horizon 50 -> 5 (episodes of {lengths} frames) -> 50; cycled "
        f"through {cycled}, 3 frames of each control in each")
    result.update(horizon_5_lengths=lengths, cycled=cycled)
    set_int8(nets, colls, False)
    return shapes, launches, {label(p): frames for p in PLAY_PRECISIONS}, result, app, cfg, run


def play_phase(smi):
    """The [play] phase: the play app of the default (Atari) agent and of the two-stage
    csgo agent at their full widths on env=fake, bf16 and int8, human and policy control
    (``play_agent``); a recording and its browsing (``play_recording``); the card-vs-CPU
    reference of the default agent's policy-controlled frames (``play_reference``).
    Returns (signatures per path, launches per path, frames per path, result)."""
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="diamond_play_")
    t_phase = time.perf_counter()
    shapes, launches, runs, result = {}, {}, {}, {}
    for name, overrides in PLAY_AGENTS.items():
        s, lch, r, result[name], app, cfg, run = play_agent(name, overrides, Path(tmp.name), smi)
        shapes.update(s)
        launches.update(lch)
        runs.update(r)
        result[name]["recording"] = play_recording(run, smi)
        if name == "default":
            result["reference"] = play_reference(app, cfg)
        del app
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"[play] phase {result['phase_s']:.1f} s")
    tmp.cleanup()
    return shapes, launches, runs, result


# ---------------------------------------------------------------------------
# [dp] data parallelism (parallel/): the four train steps through the data-parallel path

DP_UPDATES = 2
DP_RANKS = 2
DP_PADDED_ROWS = 6       # rows of the denoiser batch (all in rank 0's half at two ranks)
                         # whose first window's target frame is padding
DP_LOSS_RTOL = {"denoiser": 1e-4, "rew_end": 1e-4, "ac": 1e-3, "model_free": 1e-4}
# the first update's gradients, two ranks against one, as a share of their leaf's largest
# |value|: the steps compute in bf16, so each rank's partial sums are rounded to bf16
# (1/256 relative) before the ranks' sum, in another order than one rank's (the f32 CPU
# tests hold the same path to 1e-5)
DP_GRAD_SHARE = 1 / 16
# the pool (its burn-in and policy features, bf16 compute) built by another process: the
# kernels' bf16 tolerance against their plain versions
DP_POOL_SHARE = 1 / 64
DP_TIMEOUT_S = 400
DP_LOSS_KEY = {"denoiser": "loss_denoising", "rew_end": "loss_total", "ac": "loss_total",
               "model_free": "loss_total"}


def dp_agent(cfg, device):
    """A fresh agent made as main's (random weights from SEED, bf16 compute, the zero
    leaves perturbed): alike in every process that makes it."""
    import torch
    from diamond_tpu_torch.config import RuntimeConfig
    from diamond_tpu_torch.models import Agent

    gen = torch.Generator().manual_seed(SEED)
    agent = Agent(cfg, getattr(torch, RuntimeConfig().compute_dtype), device=device,
                  generator=gen)
    for net in agent.nets.values():
        perturb_zero_leaves(net, gen)
    return agent


def dp_inputs(agent, device) -> dict:
    """The global inputs of the four steps, made from seeds alike in every process: the
    denoiser's B = 32 segments (the first window's target padded in DP_PADDED_ROWS rows),
    a device store over the synthetic dataset and DP_UPDATES batches of rew/end segment
    ids, a POOL_SIZE-entry IC pool (burned in, with policy features) and the imagination's
    initial state at B = 32, the model-free step's recorded tensors."""
    import numpy as np
    import torch
    from diamond_tpu_torch.config import TrainerConfig, WorldModelEnvConfig
    from diamond_tpu_torch.data.batch_sampler import BatchSampler
    from diamond_tpu_torch.data.device_store import DeviceEpisodeStore
    from diamond_tpu_torch.envs.world_model_env import (ICPool, ImaginationEngine,
                                                        encode_pool_feats, make_ic_preparer)

    cfg, tcfg = agent.cfg, TrainerConfig()
    n = cfg.denoiser.inner_model.num_steps_conditioning
    den = denoiser_batch(cfg, BATCH, torch.Generator().manual_seed(SEED + 20), device)
    den.mask_padding[:DP_PADDED_ROWS, :n + 1] = False
    den.obs[:DP_PADDED_ROWS, :n + 1] = 0
    ds = synthetic_dataset(cfg)
    re = cfg.rew_end_model
    store = DeviceEpisodeStore(ds.num_steps, (re.img_size, re.img_size, re.img_channels),
                               max_episodes=ds.num_episodes, device=device)
    store.sync(ds)
    tr = tcfg.rew_end_model.training
    sampler = BatchSampler(ds, 0, 1, BATCH, tr.seq_length, tr.sample_weights,
                           can_sample_beyond_end=True, seed=SEED + 21)
    rew_ids = [sampler.sample() for _ in range(DP_UPDATES)]
    rng = np.random.default_rng(SEED + 22)
    ch = cfg.denoiser.inner_model.img_channels
    obs = torch.from_numpy(rng.integers(0, 256, (POOL_SIZE, n, re.img_size, re.img_size, ch),
                                        dtype=np.uint8)).to(device)
    act = torch.from_numpy(rng.integers(0, cfg.num_actions, (POOL_SIZE, n))
                           .astype(np.int32)).to(device)
    hx, cx = make_ic_preparer(agent.rew_end_model)(obs, act)
    feats = torch.cat([encode_pool_feats(agent.actor_critic, obs[i:i + 512])
                       for i in range(0, POOL_SIZE, 512)])
    pool = ICPool(obs=obs, act=act, hx=hx, cx=cx,
                  ptr=torch.zeros((), dtype=torch.long, device=device), feats=feats)
    st, pool = ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic,
                                 WorldModelEnvConfig()).initial_state(pool, BATCH)
    rec = recorded_tensors(cfg, BATCH, tcfg.actor_critic.actor_critic_loss.backup_every,
                           torch.Generator().manual_seed(SEED + 23), device)
    return dict(den=den, store=store, rew_ids=rew_ids, pool=pool, st=st, rec=rec)


def dp_digest(*tensors) -> str:
    """A digest of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def dp_steps(agent, inputs, dp, measure: bool = False) -> dict:
    """The denoiser, rew/end (store-fed), actor-critic (int8 world model, calibrated on
    the live buffers, from the pool) and model-free train steps through the data-parallel
    path of ``dp`` (without a process group: the single-card path), DP_UPDATES updates
    each, on deep copies of the agent's models (no int8 collection) with trainer.yaml's
    optimizers, warmup 0; the rank's rows of every global batch and draw. Returns per
    step the global losses, the norms, the first update's gradients and the parameters
    after the updates (on the host), the bytes the last update reduced; for the AC step
    the pool pointer and digests of the pool and the calibration. ``measure``: then one
    more step of each under the sync debug mode and one profiled (NCCL kernels' device
    time)."""
    import copy
    from dataclasses import replace

    import torch
    from diamond_tpu_torch.config import RuntimeConfig, TrainerConfig, WorldModelEnvConfig
    from diamond_tpu_torch.data.episode import obs_to_float
    from diamond_tpu_torch.envs.world_model_env import ImaginationEngine
    from diamond_tpu_torch.ops import quant
    from diamond_tpu_torch.parallel import (replicate_pool, shard_device_batch,
                                            shard_imag_state)
    from diamond_tpu_torch.training import (OptimizerSpec, TrainState, make_ac_train_step,
                                            make_denoiser_train_step,
                                            make_model_free_ac_train_step,
                                            make_rew_end_train_step)

    tcfg, dev = TrainerConfig(), inputs["den"].obs.device
    out = {}

    def train(name, model, net, section, make, run):
        quant.strip(net)
        spec = replace(OptimizerSpec.from_cfg(section.optimizer, section.training),
                       lr_warmup_steps=0)
        tx = spec.build(dp)
        state = TrainState.create(net, tx)
        grads, names = {}, {p: n for n, p in net.named_parameters()}

        def keep(opt, args, kwargs):
            if not grads:
                grads.update({names[p]: p.grad.detach().cpu().clone()
                              for g in opt.param_groups for p in g["params"]})

        state.opt_state.register_step_pre_hook(keep)
        step = make(model, tx)
        losses, norms = [], []
        for i in range(DP_UPDATES):
            state, m = run(step, state, i)
            loss = m[DP_LOSS_KEY[name]].detach().float().clone()
            losses.append(dp.all_reduce_sum(loss).item())
            norms.append(m["grad_norm_before_clip"].item())
        params = {n: p.detach().cpu().clone() for n, p in net.named_parameters()}
        out[name] = dict(losses=losses, norms=norms, grads=grads, lr=spec.lr, params=params,
                         reduced_bytes=tx.reduced_bytes)
        if measure:
            torch.cuda.synchronize()
            out[name]["syncs"] = sync_points(lambda: run(step, state, DP_UPDATES))
            out[name]["nccl"] = nccl_device_time(lambda: run(step, state, DP_UPDATES + 1))

    sigma = tcfg.denoiser.sigma_distribution
    den = copy.deepcopy(agent.denoiser)
    batch = shard_device_batch(inputs["den"], dp)
    dgen = torch.Generator(device=dev).manual_seed(SEED + 24)
    train("denoiser", den, den.inner_model, tcfg.denoiser,
          lambda m, tx: make_denoiser_train_step(m, tx, sigma),
          lambda step, state, i: step(state, batch, generator=dgen))

    rew = copy.deepcopy(agent.rew_end_model)
    store, ids = inputs["store"], inputs["rew_ids"]
    train("rew_end", rew, rew.net, tcfg.rew_end_model, make_rew_end_train_step,
          lambda step, state, i: step(state, store.make_batch(ids[i % len(ids)], dp=dp)))

    ac = copy.deepcopy(agent.actor_critic)
    engine = ImaginationEngine(agent.denoiser, agent.rew_end_model, ac, WorldModelEnvConfig(),
                               dp=dp)
    sites = RuntimeConfig().int8_sites
    st = shard_imag_state(inputs["st"], dp)
    obs_f = obs_to_float(st.obs_buffer)
    cgen = torch.Generator(device=dev).manual_seed(SEED + 25)
    x_init = dp.take(torch.randn((BATCH,) + tuple(obs_f.shape[2:]), generator=cgen, device=dev))
    d_coll = engine.sampler.calibrate(obs_f, st.act_buffer, sites, x_init=x_init, dp=dp)
    r_coll = agent.rew_end_model.calibrate(obs_f[:, -2:-1], st.act_buffer[:, -2:-1],
                                           obs_f[:, -1:], sites, dp=dp)
    imag = dict(st=st, pool=replicate_pool(inputs["pool"], dp))
    rgen = torch.Generator(device=dev).manual_seed(SEED + 26)

    def ac_run(step, state, i):
        state, imag["st"], imag["pool"], m = step(state, imag["st"], imag["pool"],
                                                   generator=rgen)
        return state, m

    train("ac", ac, ac.net, tcfg.actor_critic,
          lambda m, tx: make_ac_train_step(engine, m, tx, tcfg.actor_critic.actor_critic_loss),
          ac_run)
    pool = inputs["pool"]
    out["ac"].update(ptr=int(imag["pool"].ptr),
                     pool_digest=dp_digest(pool.hx, pool.cx, pool.feats),
                     pool_state={k: getattr(pool, k).detach().cpu()
                                 for k in ("hx", "cx", "feats")},
                     calibration_digest=dp_digest(*_leaves(d_coll), *_leaves(r_coll)))

    mf = copy.deepcopy(agent.actor_critic)
    rec = [dp.take(x) for x in inputs["rec"]]
    train("model_free", mf, mf.net, tcfg.actor_critic,
          lambda m, tx: make_model_free_ac_train_step(m, tx,
                                                      tcfg.actor_critic.actor_critic_loss),
          lambda step, state, i: step(state, *rec))
    return out


def _leaves(tree) -> list:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def nccl_device_time(fn) -> dict:
    """One ``fn()`` under torch.profiler: the NCCL kernels' device time and launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
    busy = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return dict(ms=sum(e.self_device_time_total for e in ev) / 1e3,
                launches=sum(e.count for e in ev), kernels=sorted({e.key[:60] for e in ev}),
                step_device_ms=sum(e.self_device_time_total for e in busy) / 1e3)


def dp_rank(rank: int, world: int, port: int, cfg) -> None:
    """One rank of [dp]'s two-rank run: the card set, a gloo process group joined, the
    agent and inputs made as the parent's, the counts set to 0, the four steps through
    the group's DataParallel, the counts read; the results written for the parent."""
    import torch
    import torch.distributed as dist
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.parallel import DataParallel

    torch.set_grad_enabled(False)
    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        dp = DataParallel.from_process_group("cuda")
        agent = dp_agent(cfg, "cuda")
        inputs = dp_inputs(agent, "cuda")
        torch.cuda.synchronize()
        count_reset()
        t0 = time.perf_counter()
        res = dp_steps(agent, inputs, dp)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["launches"] = {name: getattr(ops, name).launches for name in KERNELS}
        torch.save(res, OUT_DIR / f"dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_compare(got: dict, ref: dict, what: str, exact: bool) -> dict:
    """``got`` against ``ref`` step by step: bit for bit (``exact``: the pool's digest
    too), or the losses within DP_LOSS_RTOL, the first update's gradients within
    DP_GRAD_SHARE of their leaf's largest |value|, the parameters within Adam's bound (2
    lr an update) and the pool's burned-in state and features within DP_POOL_SHARE of
    their largest |value| (two processes need not burn in bit for bit alike); the pool
    pointer equal. Returns per step the largest differences."""
    import torch

    diffs = {}
    for name in DP_LOSS_KEY:
        r, g = ref[name], got[name]
        if exact:
            check(g["losses"] == r["losses"] and g["norms"] == r["norms"],
                  f"{what} {name}: losses {g['losses']} / norms {g['norms']} differ from "
                  f"{r['losses']} / {r['norms']}")
            for key in ("grads", "params"):
                bad = [n for n in r[key] if not torch.equal(g[key][n], r[key][n])]
                check(not bad, f"{what} {name}: {len(bad)} {key} differ, e.g. {bad[:3]}")
        else:
            for a, b in zip(g["losses"], r["losses"]):
                check(abs(a - b) <= DP_LOSS_RTOL[name] * abs(b),
                      f"{what} {name}: loss {a} vs {b} (rtol {DP_LOSS_RTOL[name]})")
            grads_close(g["grads"], r["grads"], DP_GRAD_SHARE, f"{what} {name}")
        share = max((g["grads"][n] - r["grads"][n]).abs().max().item()
                    / max(r["grads"][n].abs().max().item(), 1e-30) for n in r["grads"])
        moved = max((g["params"][n] - r["params"][n]).abs().max().item() for n in r["params"])
        check(moved <= 2 * r["lr"] * DP_UPDATES, f"{what} {name}: a parameter differs by "
              f"{moved:.3g}, beyond Adam's bound {2 * r['lr'] * DP_UPDATES:.3g}")
        diffs[name] = dict(loss_rel=max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                                                r["losses"])),
                           grad_share=share, param_abs=moved, param_in_lr=moved / r["lr"])
    check(got["ac"]["ptr"] == ref["ac"]["ptr"],
          f"{what}: pool pointer {got['ac']['ptr']} vs {ref['ac']['ptr']}")
    if exact:
        check(got["ac"]["pool_digest"] == ref["ac"]["pool_digest"], f"{what}: the IC pools "
              "differ")
    else:
        a, b = got["ac"]["pool_state"], ref["ac"]["pool_state"]
        diffs["pool"] = {k: (a[k].float() - b[k].float()).abs().max().item()
                         / max(b[k].float().abs().max().item(), 1e-30) for k in b}
        check(max(diffs["pool"].values()) <= DP_POOL_SHARE,
              f"{what}: the IC pools differ by {diffs['pool']} of their largest |value|")
        diffs["pool_bitwise"] = got["ac"]["pool_digest"] == ref["ac"]["pool_digest"]
    return diffs


def dp_phase(smi, cfg=None):
    """[dp]: (a) NCCL at world size 1 on the card: the four steps through a process
    group's DataParallel against the path without a process group, bit for bit (the path
    without a group repeated first, bit for bit); the bytes each update reduces, the
    host-device syncs of one more step of each, the NCCL kernels' device time in one
    profiled step. (b) two spawned ranks on the one card over gloo, 16 rows each of the
    same global batch: the ranks bit for bit against each other, within tolerance
    against (a)'s path without a group; the pool pointer equal; each rank's kernel
    launches. Returns the result."""
    import socket

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import AgentConfig
    from diamond_tpu_torch.parallel import DataParallel

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    t_phase = time.perf_counter()
    cfg = cfg if cfg is not None else AgentConfig()
    agent = dp_agent(cfg, "cuda")
    inputs = dp_inputs(agent, "cuda")
    ref = dp_steps(agent, inputs, DataParallel())
    dp_compare(dp_steps(agent, inputs, DataParallel()), ref, "[dp] repeat without a group",
               exact=True)

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        dp = DataParallel.from_process_group("cuda")
        torch.cuda.synchronize()
        count_reset()
        got = dp_steps(agent, inputs, dp)
        torch.cuda.synchronize()
        launches = {name: getattr(ops, name).launches for name in KERNELS}
        dp_compare(got, ref, "[dp] NCCL world size 1", exact=True)
        measured = dp_steps(agent, inputs, dp, measure=True)
    finally:
        dist.destroy_process_group()
    for name, n in launches.items():
        if KERNELS[name][2]:  # every kernel on a path
            check(n > 0, f"[dp] NCCL world size 1: {name} was not launched")
    syncs = {name: measured[name]["syncs"] for name in DP_LOSS_KEY}
    nccl = {name: measured[name]["nccl"] for name in DP_LOSS_KEY}
    reduced = {name: got[name]["reduced_bytes"] for name in DP_LOSS_KEY}
    check(not any(syncs[n] for n in ("denoiser", "rew_end", "model_free")),
          f"[dp] a data-parallel step synchronised: {syncs}")
    log(f"[dp] (a) NCCL, world size 1: denoiser, rew/end (store-fed), AC (int8 world model, "
        f"pool) and model-free steps, {DP_UPDATES} updates each, equal bit for bit to the "
        f"path without a process group (losses, norms, every gradient and parameter, pool "
        f"pointer {ref['ac']['ptr']}); that path repeats bit for bit; on {smi}")
    for name in DP_LOSS_KEY:
        log(f"[dp]   {name}: {reduced[name] / 2**20:.2f} MiB reduced per update "
            f"({reduced[name] // 4} f32), {sum(syncs[name].values())} host-device syncs "
            f"per step {syncs[name]}, NCCL kernels {nccl[name]['ms']:.3f} ms of device time "
            f"in {nccl[name]['launches']} launches {nccl[name]['kernels']} of the step's "
            f"{nccl[name]['step_device_ms']:.2f} ms")
    log(f"[launches] dp (a), the four steps through the NCCL group: {launches}")

    t0 = time.perf_counter()
    for r in range(DP_RANKS):
        (OUT_DIR / f"dp_rank{r}.pt").unlink(missing_ok=True)
    ctx = mp.start_processes(dp_rank, args=(DP_RANKS, free_port(), cfg), nprocs=DP_RANKS,
                             join=False, start_method="spawn")
    try:
        try:
            deadline = time.perf_counter() + DP_TIMEOUT_S
            while not ctx.join(timeout=5):
                check(time.perf_counter() < deadline, f"[dp] (b) the ranks ran past "
                      f"{DP_TIMEOUT_S} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise SmokeFailure(f"[dp] (b) a rank failed: {e}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(OUT_DIR / f"dp_rank{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
    finally:  # ~130 MB each: not left in the output directory
        for r in range(DP_RANKS):
            (OUT_DIR / f"dp_rank{r}.pt").unlink(missing_ok=True)
    for r in range(1, DP_RANKS):
        dp_compare(ranks[r], ranks[0], f"[dp] (b) rank {r} vs rank 0", exact=True)
        check(ranks[r]["ac"]["calibration_digest"] == ranks[0]["ac"]["calibration_digest"],
              "[dp] (b) the ranks' int8 collections differ")
    diffs = dp_compare(ranks[0], ref, f"[dp] (b) {DP_RANKS} gloo ranks vs one", exact=False)
    for r, res in enumerate(ranks):
        for name, n in res["launches"].items():
            if KERNELS[name][2]:
                check(n > 0, f"[dp] (b) rank {r}: {name} was not launched")
    log(f"[dp] (b) {DP_RANKS} ranks over gloo on the one card, {BATCH // DP_RANKS} rows each "
        f"of the global batch of {BATCH}: the ranks' gradients, parameters and losses equal "
        f"bit for bit, their int8 collections and pools alike; pool pointer "
        f"{ranks[0]['ac']['ptr']} as at world size 1; the ranks' pool against this "
        f"process's: {'bit for bit' if diffs['pool_bitwise'] else 'not bit for bit'}, "
        f"{ {k: float(f'{v:.3g}') for k, v in diffs['pool'].items()} } of their largest "
        f"|value| (limit {DP_POOL_SHARE:.3g}); the four steps took "
        f"{max(x['seconds'] for x in ranks):.1f} s in the ranks, {spawn_s:.1f} s with the "
        f"spawn; on {smi}")
    for name in DP_LOSS_KEY:
        d = diffs[name]
        log(f"[dp]   {name} vs world size 1: loss {d['loss_rel']:.3g} relative (limit "
            f"{DP_LOSS_RTOL[name]}), gradients {d['grad_share']:.3g} of their leaf's largest "
            f"|value| (limit {DP_GRAD_SHARE}), parameters {d['param_abs']:.3g} apart "
            f"({d['param_in_lr']:.3g} lr; Adam's bound {2 * DP_UPDATES} lr)")
    log(f"[launches] dp (b), rank 0: {ranks[0]['launches']}")
    log(f"[dp] {time.perf_counter() - t_phase:.1f} s")
    return dict(world1=dict(reduced_bytes=reduced, syncs=syncs, nccl=nccl, launches=launches,
                            ptr=ref["ac"]["ptr"]),
                ranks=dict(diffs=diffs, ptr=ranks[0]["ac"]["ptr"], seconds=spawn_s,
                           launches=[x["launches"] for x in ranks]),
                seconds=time.perf_counter() - t_phase)


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # the rollouts serve and are measured with no grad; the AC step enables it itself
    torch.set_grad_enabled(False)
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
    check(all(results["bf16"]["launches"][n] == 0 for n in INT8_KERNELS),
          "an int8 kernel ran on the uncalibrated (bf16) path")
    sanity(traj, st, pool, ptr_before, cfg.num_actions)
    results["bf16"]["other_branch_fps"] = other_branch(engine, st, pool, rgen, cfg.num_actions,
                                                       "bf16")
    results["bf16"]["profile"] = profile_run(
        lambda: engine.rollout(st, pool, HORIZON, generator=rgen), "bf16", "rollout")

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
    results["int8"]["profile"] = profile_run(
        lambda: engine.rollout(st, pool, HORIZON, generator=rgen), "int8", "rollout")
    int8_sites_ops(results, smi)
    results["int8"]["site_host_us"] = int8_site_host_costs(smi)
    log(f"[rollout] imagination_fps_batch32_n3: int8 {results['int8']['fps']:.1f} vs bf16 "
        f"{results['bf16']['fps']:.1f} env_frames/s on {smi}")
    colls = [quant.collection(agent.denoiser.inner_model), quant.collection(agent.rew_end_model.net)]
    results["alternate"] = alternate(engine, agent, colls, st, pool, rgen)
    for label in ("bf16", "int8"):
        set_int8([agent.denoiser.inner_model, agent.rew_end_model.net], colls, label == "int8")
        results[label]["sync_points"] = sync_points(
            lambda: engine.rollout(st, pool, HORIZON, generator=rgen))
        log(f"[sync] {label} rollout: {sum(results[label]['sync_points'].values())} host-device "
            f"synchronisations {results[label]['sync_points']}")
    results["int8_vs_bf16_step"] = int8_vs_bf16_step(engine, agent, st, rgen)

    # the actor-critic train step on the int8-calibrated world model
    st, pool, shapes["ac_step"], results["ac_step"] = ac_step_phase(engine, agent, st, pool,
                                                                    rgen, smi)
    # the denoiser train step, on its own copy of the denoiser
    shapes["denoiser_step"], results["denoiser_step"] = denoiser_step_phase(agent, smi)
    # the rew/end train step fed from the device store, on its own copy of the model
    shapes["rew_end_step"], results["rew_end_step"] = rew_end_step_phase(agent, smi)
    # the model-free actor-critic step on recorded tensors, on its own copy
    shapes["mf_ac_step"], results["mf_ac_step"] = mf_ac_step_phase(agent, smi)
    # the trainer, three epochs of the whole loop on models of its own
    shapes["trainer"], results["trainer"] = trainer_phase(smi)
    # the two-stage (csgo) world model: play, its train steps and the wm_only trainer
    ts_shapes, ts_launches, ts_runs, results["two_stage"] = two_stage_phase(smi)
    # the play app, both agents, headless
    play_shapes, play_launches, play_runs, results["play"] = play_phase(smi)
    # data parallelism: the four steps through a process group (NCCL, then two gloo ranks)
    results["dp"] = dp_phase(smi)

    paths = ("bf16", "int8", "ac_step", "denoiser_step", "rew_end_step", "mf_ac_step",
             "trainer")
    launches = {p: results[p]["launches"] for p in paths}
    runs = {p: 1 + TIMED_ROLLOUTS if p in ("bf16", "int8")
            else results[p]["epochs"] if p == "trainer" else results[p]["steps"]
            for p in paths}
    for more in ((ts_shapes, ts_launches, ts_runs), (play_shapes, play_launches, play_runs)):
        shapes.update(more[0])
        launches.update(more[1])
        runs.update(more[2])
    rows, details = compare_kernels(shapes, launches, runs)
    for r in rows:
        where = (f"on the {r['path']} path" if r["path"] else
                 "on no path (phase 7 alone drives it)")
        log(f"[kernel] {r['name']}: {r['launches']} launches {where}, "
            f"{r['shapes']} shapes, {r['ms']:.2f} ms of device time per {r['per']} (plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.2f} ms by {r['bound_by']}"
            + (f", library {r['library_ms']:.2f} ms" if r["library_ms"] is not None else "")
            + (f"; on the {r['library_covers']}: kernel {r['ms_where_library']:.2f} ms, library "
               f"{r['library_ms']:.2f} ms" if "library_covers" in r else "")
            + (f"; the separate ops it replaced {r['old_route_ms']:.2f} ms"
               if "old_route_ms" in r else "")
            + (f"; K5 on its codes {r['conv_ms']:.2f} ms, quant.conv3x3_q8 whole "
               f"{r['whole_ms']:.2f} ms" if "conv_ms" in r else "")
            + ")")
        for p, v in r["by_path"].items():
            if p != r["path"]:
                log(f"[kernel]   {r['name']} on the {p} path: {v['launches']} launches, "
                    f"{v['shapes']} shapes, {v['ms']:.2f} ms per {PER_RUN[p]} (plain "
                    f"{v['plain_ms']:.2f} ms, bound {v['bound_ms']:.2f} ms"
                    + (f", library {v['library_ms']:.2f} ms" if v["library_ms"] is not None
                       else "") + ")")
    for d in details:
        if "cold_ms" in d:
            log(f"[kernel] matmul_int8 {d['signature']} {d['dtype']}: warm {d['ms']:.4f} ms "
                f"(inputs reused, in L2), cold {d['cold_ms']:.4f} ms (L2 flushed), bound "
                f"{d['bound_ms']:.4f} ms by bytes; {d['plan']}; on {smi}")
    results["reference_bf16"] = reference_check(agent, st, pool, wm_cfg)
    results["reference_int8"] = reference_check(agent, st, pool, wm_cfg, rt.int8_sites)
    with torch.enable_grad():
        results["reference_ac_gradient"] = ac_gradient_check(agent)
        results["reference_ac_step"] = ac_step_reference(agent, st, pool, wm_cfg)
    results["reference_denoiser_step"] = denoiser_step_reference(agent)
    results["reference_rew_end_step"] = rew_end_step_reference(agent)
    results["reference_mf_ac_step"] = mf_ac_step_reference(agent)

    log(f"[total] {time.perf_counter() - t_start:.1f} s, the build included")
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
