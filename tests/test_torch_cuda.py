"""diamond_tpu_torch's CUDA kernels on a card: each against its plain PyTorch version
on the same inputs, at shapes of the rollout. Skips where there is no GPU.

This file imports no jax, so it also runs where the JAX package cannot be imported
(the GPU machine has no jax): ``python3 -m pytest tests/test_torch_cuda.py -q
--noconftest`` from the repo root (tests/conftest.py imports jax)."""

import pytest
import torch

# K3/K5 at every 3x3 conv signature class of the rollout, (B, H, W, Cin, Cout, stride,
# bias): the 8x8 levels at B = 32, where Cout is split across blocks, the others at small
# B; then the ragged cases: odd H = 9 with stride 2, M not a multiple of a tile (5x5,
# 33x33), B = 1, rows wider than a block (W = 150), Cout = 3, 24 and 32, Cin = 3, 6, 12
# and 16, Cin = 128 at 8x8.
CONV_SHAPES = [
    (4, 64, 64, 64, 64, 1, True), (2, 64, 64, 128, 64, 1, True), (32, 8, 8, 64, 64, 1, True),
    (4, 32, 32, 64, 64, 1, True), (4, 64, 64, 64, 3, 1, True), (4, 32, 32, 128, 64, 1, True),
    (8, 16, 16, 64, 64, 1, True), (32, 8, 8, 128, 64, 1, True), (8, 16, 16, 128, 64, 1, True),
    (4, 64, 64, 32, 32, 1, True), (4, 64, 64, 64, 64, 2, True), (4, 32, 32, 64, 64, 2, True),
    (8, 16, 16, 64, 64, 2, True), (4, 64, 64, 6, 32, 1, True), (32, 8, 8, 32, 32, 1, True),
    (4, 32, 32, 32, 32, 1, True), (4, 64, 64, 32, 32, 2, True), (4, 64, 64, 12, 64, 1, False),
    (4, 64, 64, 3, 64, 1, False), (4, 64, 64, 3, 32, 1, True), (4, 16, 16, 32, 64, 1, True),
    (2, 9, 9, 32, 24, 2, True), (2, 9, 9, 16, 24, 2, True), (3, 5, 5, 16, 32, 1, True),
    (2, 33, 33, 64, 3, 1, True), (1, 64, 64, 64, 64, 1, True), (1, 4, 150, 16, 8, 1, False),
    (1, 5, 7, 6, 3, 2, True), (2, 9, 9, 12, 32, 1, False), (2, 8, 8, 128, 64, 1, True)]

from diamond_tpu_torch.ops import (QTensor, adagn_silu, adagn_silu_plain, adagn_silu_q8,
                                   adagn_silu_q8_plain, conv3x3, conv3x3_int8,
                                   conv3x3_int8_plain, conv3x3_plain, conv3x3_qtensor,
                                   groupnorm_silu, groupnorm_silu_plain, groupnorm_silu_q8,
                                   groupnorm_silu_q8_plain, norm_affine_silu_q8,
                                   norm_affine_silu_q8_plain, quant, quantize_static,
                                   static_code_flips)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: each kernel against its plain version on the same inputs, at shapes of
    the rollout. f32 with TF32 off: 1e-3 of the largest |value| (sums of up to 1152
    terms in another order); bf16: 1/64 of it (both round once to bf16, which can differ
    by one bf16 ulp = 1/128 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-3 if dt == torch.float32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(0)

    def check(a, b):
        torch.cuda.synchronize()
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale

    for b, h, w, cin, cout, s, bias in CONV_SHAPES:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        bb = torch.randn(cout, device="cuda", generator=g) if bias else None
        check(conv3x3(x, k, bb, s), conv3x3_plain(x, k, bb, s))
    for b, h, c in [(4, 64, 64), (4, 8, 128), (4, 32, 32), (2, 16, 96), (2, 8, 512)]:
        x = (torch.randn(b, h, h, c, device="cuda", generator=g) * 2 + 0.5).to(dt)
        ss = torch.randn(b, 2 * c, device="cuda", generator=g)
        sc, bi = ss[0, :c] + 1, ss[1, c:]
        for silu in (True, False):
            check(adagn_silu(x, ss, c // 32, silu), adagn_silu_plain(x, ss, c // 32, silu))
            check(groupnorm_silu(x, sc, bi, c // 32, silu),
                  groupnorm_silu_plain(x, sc, bi, c // 32, silu))


@pytest.mark.cuda
def test_model_on_the_card_goes_through_the_kernels_and_matches_the_cpu():
    """A small InnerModel (all three kernels on its path) in f32 on the card, against the
    same model on the CPU (plain versions): the launch counters rise, and outputs agree
    to 1e-3 (f32 sums in other orders, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.config import InnerModelConfig
    from diamond_tpu_torch.models.blocks import init_weights
    from diamond_tpu_torch.models.inner_model import InnerModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = InnerModelConfig(cond_channels=32, depths=[1, 1], channels=[32, 64],
                           attn_depths=[0, 1], num_actions=4)
    g = torch.Generator().manual_seed(0)
    cpu = InnerModel(cfg)
    init_weights(cpu, g)
    with torch.no_grad():
        for p in cpu.parameters():  # no zero-init leaves: every layer shapes the output
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    gpu = InnerModel(cfg).cuda()
    gpu.load_state_dict(cpu.state_dict())
    args = (torch.randn(2, 16, 16, 3, generator=g), torch.randn(2, generator=g),
            torch.rand(2, 16, 16, 12, generator=g) * 2 - 1, torch.randint(0, 4, (2, 4), generator=g))
    before = (conv3x3.launches, adagn_silu.launches, groupnorm_silu.launches)
    with torch.no_grad():
        y_gpu = gpu(*(a.cuda() for a in args))
        torch.cuda.synchronize()
        y_cpu = cpu(*args)
    after = (conv3x3.launches, adagn_silu.launches, groupnorm_silu.launches)
    assert all(a > b for a, b in zip(after, before))
    assert (y_gpu.cpu() - y_cpu).abs().max().item() <= 1e-3 * max(1.0, y_cpu.abs().max().item())


def _codes_close(a, b, share=1e-3):
    """int8 codes at most 1 apart, in at most ``share`` of the elements (one f32 ulp
    apart, a value can round to the neighbouring code)."""
    d = (a.int() - b.int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() <= share


def _codes_at_boundary(flips, numel, share=1e-3):
    """``ops.code_flips``' (largest, count, margin): codes at most 1 apart, every element
    that differs within one unit of its code boundary (a value at a rounding boundary),
    in at most ``share`` of the elements or in one."""
    most, n, margin = flips
    assert most <= 1 and margin <= 1 and n <= max(1, share * numel), flips


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_kernels_match_plain_versions(dtype):
    """On the card: K4's static epilogue equals quantize(K1/K2 kernel output) code for
    code, and its plain version within one code in 0.1 % of the elements (the kernels
    fuse a multiply-add the plain versions round twice); K4's per-sample epilogue within
    one code in 0.1 %, scales to rtol 1e-5; K5 equals its plain version exactly (int8
    sums are exact and every f32 step is the same IEEE operation), from int8, bf16 and
    f32 inputs, at every conv signature class of the rollout and the ragged cases
    (CONV_SHAPES), with and without bias, and with a QTensor's per-sample scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    for b, h, c in [(4, 64, 64), (4, 8, 128), (4, 32, 32), (2, 16, 96)]:
        x = (rnd(b, h, h, c) * 2 + 0.5).to(dt)
        ss, am = rnd(b, 2 * c), rnd(c).abs() + 0.2
        sc, bi = ss[0, :c] + 1, ss[1, c:]
        q = adagn_silu_q8(x, ss, c // 32, am)
        torch.cuda.synchronize()
        assert torch.equal(q, quantize_static(adagn_silu(x, ss, c // 32), am))
        _codes_close(q, adagn_silu_q8_plain(x, ss, c // 32, am))
        q = groupnorm_silu_q8(x, sc, bi, c // 32, am)
        assert torch.equal(q, quantize_static(groupnorm_silu(x, sc, bi, c // 32), am))
        _codes_close(q, groupnorm_silu_q8_plain(x, sc, bi, c // 32, am))
        rows = [rnd(b, c), rnd(b, c).abs() + 0.5, rnd(b, c), rnd(b, c)]
        qt, ref = norm_affine_silu_q8(x, *rows), norm_affine_silu_q8_plain(x, *rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(qt.scale, ref.scale, rtol=1e-5, atol=0)
        _codes_close(qt.q, ref.q)

    for b, h, w, cin, cout, s, bias in CONV_SHAPES:
        x = rnd(b, h, w, cin).to(dt)
        am = x.float().abs().amax(dim=(0, 1, 2)) * 0.9
        w = rnd(3, 3, cin, cout) / (9 * cin) ** 0.5
        wq, ws = quant.fold_quantize_weight(w, am)
        bb = rnd(cout) if bias else None
        for xin in (x, quantize_static(x, am)):
            y = conv3x3_int8(xin, wq, ws, am, bb, s, dt)
            torch.cuda.synchronize()
            assert y.dtype == dt and torch.equal(y, conv3x3_int8_plain(xin, wq, ws, am, bb, s, dt))
        qx = QTensor(quantize_static(x, am), rnd(b, 1).abs())
        y, ref = conv3x3_qtensor(qx, w, s), conv3x3_qtensor(QTensor(qx.q.cpu(), qx.scale.cpu()),
                                                            w.cpu(), s)
        assert torch.equal(y.cpu(), ref)


@pytest.mark.cuda
def test_k5_quantizes_near_rounding_ties_like_a_true_division():
    """K5 quantizes a float x by a multiply with 1/s_c and falls back to the true division
    near a rounding tie: on x = (k + 1/2) * s_c and its f32 neighbours, for every code k,
    its output equals the plain version's, which divides truly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops.conv3x3_q8 import static_scale

    g = torch.Generator(device="cuda").manual_seed(3)
    cin, cout = 32, 16
    am = torch.rand(cin, device="cuda", generator=g) + 0.5
    ties = (torch.arange(-130, 130, device="cuda").float() + 0.5)[:, None] * static_scale(am)
    x = torch.stack([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1)])
    x = x.reshape(3, 26, 10, cin).contiguous()
    w = torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** 0.5
    wq, ws = quant.fold_quantize_weight(w, am)
    for xin in (x, x.bfloat16()):
        y = conv3x3_int8(xin, wq, ws, am, None, 1, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(y, conv3x3_int8_plain(xin, wq, ws, am, None, 1, torch.float32))


# K5's call shapes in the int8 rollout, (H = W, Cin, Cout, stride) of x (B, H, W, Cin):
# the denoiser's and the rew/end model's convs at every level, on K4's codes or on bf16
# (scripts/k5_shapes.py SIGNATURES; its Cin = 6 conv takes no pipeline plan).
K5_ROLLOUT = [(h, cin, cout, s) for h in (64, 32, 16, 8)
              for cin, cout, s in ((64, 64, 1), (128, 64, 1), (32, 32, 1), (64, 64, 2),
                                   (32, 32, 2), (64, 3, 1))
              if not (h == 8 and s == 2) and not (cout == 3 and h != 64)]
# Ragged pipeline tiles, (B, H, W, Cin, Cout, stride): a last image group of 1 of 4 (8x8),
# rows past Ho in the last tile (row and 8 x 8 M-tiles), columns past Wo, odd H at
# stride 2, Cin = 16 and 48 (a zero-filled chunk past Cin), Cout = 24 and 3.
K5_RAGGED = [(5, 8, 8, 64, 64, 1), (3, 37, 64, 64, 64, 1), (2, 36, 40, 64, 32, 1),
             (2, 47, 48, 32, 32, 2), (2, 40, 40, 16, 24, 1), (3, 48, 48, 48, 64, 2),
             (2, 64, 64, 64, 3, 1), (1, 16, 16, 128, 64, 1)]


def _k5_routes_agree(b, h, w, cin, cout, s, g, against_plain=False):
    """K5 at one shape on the pipeline route and on the halo route, bit for bit: x int8,
    bf16 and f32; out bf16 and f32; with a bias, or with a QTensor's per-sample scale.
    Only an f32 x with an f32 out may lack a pipeline plan (its rings and staging rows do
    not fit beside 128 channels, or stride 2 at 64); the route then keeps the halo kernel."""
    from diamond_tpu_torch.ops import conv_plan

    x = torch.randn(b, h, w, cin, device="cuda", generator=g) * 1.5
    am = x.abs().amax(dim=(0, 1, 2)) * 0.9
    wq = torch.randint(-127, 128, (3, 3, cin, cout), device="cuda", generator=g,
                       dtype=torch.int8)
    ws = torch.rand(cout, device="cuda", generator=g) * 1e-3 + 1e-4
    bias = torch.randn(cout, device="cuda", generator=g)
    ss = torch.rand((b, 1), device="cuda", generator=g) + 0.1
    for xin in (quantize_static(x, am), x.bfloat16(), x):
        for out in (torch.bfloat16, torch.float32):
            pipe = conv_plan.pipe_plan(b, h, w, cin, cout, s, xin.element_size(),
                                       torch.empty((), dtype=out).element_size())
            halo = conv_plan.k5_plan(b, h, w, cin, cout, s, xin.dtype == torch.int8)
            if pipe is None:
                assert xin.dtype == out == torch.float32, (b, h, w, cin, cout, s, xin.dtype)
                assert conv_plan.k5_route(b, h, w, cin, cout, s, 4, 4) == halo
                continue
            for bb, sc in ((bias, None), (None, ss)):
                args = (xin, wq, ws, am, bb, s, out, sc)
                y = conv3x3_int8(*args, plan=pipe)
                ref = (conv3x3_int8_plain(*args) if against_plain
                       else conv3x3_int8(*args, plan=halo))
                torch.cuda.synchronize()
                assert torch.equal(y, ref), (b, h, w, cin, cout, s, xin.dtype, out, sc is None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b512", "b32", "ragged"])
def test_k5_pipeline_route_equals_the_halo_route(case):
    """K5's pipeline route (conv_pipe.cuh) against its halo route, bit for bit (int32
    sums exact in any order, the same epilogue roundings), at every K5 call shape of the
    int8 rollout at B = 512 and 32 (each forced onto the pipeline's plan), and against
    the plain version at the ragged tiles (K5_RAGGED)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(21)
    if case == "ragged":
        for sig in K5_RAGGED:
            _k5_routes_agree(*sig, g, against_plain=True)
        return
    b = 512 if case == "b512" else 32
    for h, cin, cout, s in K5_ROLLOUT:
        _k5_routes_agree(b, h, h, cin, cout, s, g)
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_k5_large_rollout_calls_take_the_pipeline():
    """At B = 512 every K5 call of the rollout with at least PIPE_MIN_M output pixels
    (and 16-channel chunks) is launched on the pipeline, the others on the halo kernel,
    one launch a call: ``conv3x3_int8.routes`` counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import conv_plan

    g = torch.Generator(device="cuda").manual_seed(5)
    for h, cin, cout, s in K5_ROLLOUT + [(64, 6, 32, 1)]:
        x = torch.randint(-127, 128, (512, h, h, cin), device="cuda", generator=g,
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (3, 3, cin, cout), device="cuda", generator=g,
                           dtype=torch.int8)
        ws, bias = torch.rand(cout, device="cuda") * 1e-3, torch.randn(cout, device="cuda")
        before, launches = conv3x3_int8.routes.copy(), conv3x3_int8.launches
        conv3x3_int8(x, wq, ws, None, bias, s, torch.bfloat16)
        ho = (h - 1) // s + 1
        large = 512 * ho * ho >= conv_plan.PIPE_MIN_M and cin % 16 == 0
        route = "pipe" if large else "halo"
        assert conv3x3_int8.launches == launches + 1
        assert conv3x3_int8.routes - before == {route: 1}, (h, cin, cout, s)
    torch.cuda.synchronize()


def _bench_kernel_patterns():
    """The kernel-name patterns of the benchmark's K5 readers, as they are: benchmarks/
    metrics/int8_device_ms_per_step.py and conv_roofline_pct.py ``KERNELS``."""
    import importlib.util
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1] / "benchmarks"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))  # the readers import harness.readers
    out = {}
    for name in ("int8_device_ms_per_step", "conv_roofline_pct"):
        spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                      bench / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.KERNELS
    return out


@pytest.mark.cuda
def test_k5_pipeline_kernels_keep_the_names_the_benchmark_reads():
    """Every instance of the pipeline kernel the rollout launches (codes and bf16 x, NT
    64, 32 and 8) and the f32 ones, profiled once each: the benchmark's K5 readers
    (int8 device time, conv roofline) match its profiler name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import re

    from diamond_tpu_torch.ops import conv_plan

    patterns = _bench_kernel_patterns()
    g = torch.Generator(device="cuda").manual_seed(7)
    calls = []
    for xdt in (torch.int8, torch.bfloat16, torch.float32):
        for cin, cout in ((64, 64), (32, 32), (64, 3)):
            x = torch.randn(2, 64, 64, cin, device="cuda", generator=g)
            am = x.abs().amax(dim=(0, 1, 2))
            xin = quantize_static(x, am) if xdt == torch.int8 else x.to(xdt)
            wq = torch.randint(-127, 128, (3, 3, cin, cout), device="cuda", generator=g,
                               dtype=torch.int8)
            plan = conv_plan.pipe_plan(2, 64, 64, cin, cout, 1, xin.element_size(), 2)
            calls.append((xin, wq, torch.rand(cout, device="cuda"), am, None, 1,
                          torch.bfloat16, None, plan))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for *args, plan in calls:
            conv3x3_int8(*args, plan=plan)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "pipe::conv3x3_halo_wgmma" in e.key}
    assert len(names) == len(calls), names
    for name in names:
        for reader, pattern in patterns.items():
            assert re.search(pattern, name), (reader, name)


# The norm signature classes of both rollout paths, (B, H, C): every (H, C) of the
# denoiser, rew/end and actor-critic norms (B = 32 up to 16x16, 4 above); then the ragged
# cases: B = 1, C = 32 with one group, C = 128, odd H = W = 9, C = 96, the f32 64x64x128
# sample (2 MB, 16 blocks) and f32 64x64x256 (beyond 16 blocks' shared memory: a spill).
NORM_SHAPES = ([(32 if h <= 16 else 4, h, c) for h in (64, 32, 16, 8) for c in (32, 64, 128)]
               + [(1, 64, 64), (1, 8, 32), (2, 9, 128), (3, 9, 32), (2, 5, 96)])
NORM_F32_ONLY = [(2, 64, 128), (1, 64, 256)]


def _norm_inputs(b, h, c, dt, g, ss_dtype=torch.float32):
    x = (torch.randn(b, h, h, c, device="cuda", generator=g) * 2 + 0.5).to(dt)
    ss = (0.5 * torch.randn(b, 2 * c, device="cuda", generator=g)).to(ss_dtype)
    sc, bi = 1 + 0.1 * torch.randn(c, device="cuda", generator=g), 0.1 * torch.randn(
        c, device="cuda", generator=g)
    return x, ss, sc, bi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_kernels_at_every_signature_class(dtype):
    """K1, K2 (with and without SiLU) and K4's static epilogue at every norm signature
    class of the rollout and the ragged cases, against their plain versions: bf16 within
    1/64 and f32 (TF32 off) within 1e-4 of max(1, max |plain|); K4's codes equal
    quantize_static of the K1/K2 kernel's output, and lie within one code of the plain
    version's in at most 0.1 % of the elements. The FiLM rows are given in bf16, as the
    model's linear layer makes them, and the K2 affine in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(4)

    def close(a, b):
        torch.cuda.synchronize()
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale

    shapes = NORM_SHAPES + (NORM_F32_ONLY if dt == torch.float32 else [])
    for b, h, c in shapes:
        gr = max(1, c // 32)
        x, ss, sc, bi = _norm_inputs(b, h, c, dt, g, torch.bfloat16)
        for silu in (True, False):
            close(adagn_silu(x, ss, gr, silu), adagn_silu_plain(x, ss, gr, silu))
            close(groupnorm_silu(x, sc, bi, gr, silu), groupnorm_silu_plain(x, sc, bi, gr, silu))
        am = adagn_silu_plain(x, ss, gr).float().abs().amax(dim=(0, 1, 2)) * 0.95
        q = adagn_silu_q8(x, ss, gr, am)
        torch.cuda.synchronize()
        assert torch.equal(q, quantize_static(adagn_silu(x, ss, gr), am))
        _codes_close(q, adagn_silu_q8_plain(x, ss, gr, am))
        q = groupnorm_silu_q8(x, sc, bi, gr, am)
        assert torch.equal(q, quantize_static(groupnorm_silu(x, sc, bi, gr), am))
        _codes_close(q, groupnorm_silu_q8_plain(x, sc, bi, gr, am))


@pytest.mark.cuda
def test_norm_kernels_read_bf16_and_f32_affine_alike_and_repeat_exactly():
    """The FiLM rows (and GroupNorm's affine) given in bf16 or as the same values in f32
    give the same output bit for bit (the kernel reads bf16 exactly); two calls on the
    same input are equal (a fixed reduction order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(5)
    for b, h, c in [(32, 8, 64), (4, 64, 128), (4, 32, 64), (2, 64, 64)]:
        gr = max(1, c // 32)
        x, ss, sc, bi = _norm_inputs(b, h, c, torch.bfloat16, g, torch.bfloat16)
        am = torch.rand(c, device="cuda", generator=g) + 0.5
        sc16, bi16 = sc.bfloat16(), bi.bfloat16()
        for fn, args16, args32 in [
                (adagn_silu, (x, ss, gr), (x, ss.float(), gr)),
                (adagn_silu_q8, (x, ss, gr, am), (x, ss.float(), gr, am)),
                (groupnorm_silu, (x, sc16, bi16, gr), (x, sc16.float(), bi16.float(), gr)),
                (groupnorm_silu_q8, (x, sc16, bi16, gr, am),
                 (x, sc16.float(), bi16.float(), gr, am))]:
            first = fn(*args16)
            torch.cuda.synchronize()
            assert torch.equal(first, fn(*args32)), fn.__name__
            assert torch.equal(first, fn(*args16)), fn.__name__


@pytest.mark.cuda
def test_card_places_the_16_block_norm_clusters():
    """The plans of 16 blocks per sample (bf16 and f32 64x64x128 at B = 32) are ones this
    card can run (an H100 SXM holds a cluster of 16 such blocks in one GPC), so the
    wrappers launch them as planned, not their 8-block fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch import kernels
    from diamond_tpu_torch.ops.fused_norms import launch_plan
    from diamond_tpu_torch.ops.norm_plan import norm_plan

    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros(32, 64, 64, 128, dtype=dt, device="cuda")
        p = norm_plan(32, 64 * 64, 128, 4, x.element_size())
        assert p.n == 16
        for fn, q8 in ((kernels.lib().gn_max_clusters, False),
                       (kernels.lib().gn_q8_max_clusters, True)):
            assert fn(p.c_ints) > 0
            assert launch_plan(x, 4, "adagn_silu", q8) is p


@pytest.mark.cuda
def test_k4_quantizes_near_rounding_ties_like_a_true_division():
    """K4 quantizes by a multiply with 1/s_c and falls back to the true division near a
    rounding tie: with act_max chosen so that a value K1 writes in each channel lands
    within an ulp of code 2.5 (y0 / s_c = 2.5), K4's codes still equal quantize_static of
    K1's output, which divides truly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops.conv3x3_q8 import static_scale

    g = torch.Generator(device="cuda").manual_seed(6)
    for b, h, c, dt in [(32, 8, 64, torch.bfloat16), (4, 32, 128, torch.bfloat16),
                        (8, 16, 32, torch.float32)]:
        gr = max(1, c // 32)
        x, ss, _, _ = _norm_inputs(b, h, c, dt, g, torch.bfloat16)
        y = adagn_silu(x, ss, gr).float()
        y0 = y.reshape(-1, c).abs().median(dim=0).values.clamp_min(1e-3)
        am = (y0.double() / 2.5 * 127 / 1.05).float()
        t = y / static_scale(am)
        assert ((t.abs() - 2.5).abs() < 1e-4).sum().item() > 0  # ties are there to hit
        q = adagn_silu_q8(x, ss, gr, am)
        torch.cuda.synchronize()
        assert torch.equal(q, quantize_static(adagn_silu(x, ss, gr), am))


# K6 at the int8 sites' shapes, (M, K, N): the denoiser's up-path projections (B = 32,
# 8x8 to 64x64), its mid attention and the rew/end attention, the csgo dynamics U-Net's
# projections at batch 1 (16x16 frames, down to 2x2: M = 4), the int8_sites=all sites (the
# AdaGN and cond linears at M = B, the rew/end LSTM's input and hidden gates, its heads),
# then ragged shapes: M = 1, K = 15 and 33, N = 5 and 70, M one past or short of a tile
# edge (16, 32 and 64 rows, and the bulk variant's threshold of 16,384), K = 2048 at N = 5
# and K = 512 at N = 70 split over clusters.
MATMUL_SHAPES = [(32 * 4096, 128, 64), (32 * 1024, 128, 64), (32 * 256, 128, 64),
                 (32 * 64, 128, 64), (2048, 64, 192), (2048, 64, 64), (2048, 32, 96),
                 (2048, 32, 32), (256, 128, 64), (64, 128, 64), (16, 128, 64), (4, 128, 64),
                 (32, 256, 128), (32, 256, 256), (32, 2048, 2048), (32, 512, 2048),
                 (32, 512, 512), (32, 512, 5), (1, 15, 5), (7, 33, 70), (300, 15, 24),
                 (16 * 9 + 1, 128, 64), (32 * 77 - 1, 64, 192), (16383, 128, 64),
                 (16385, 128, 64), (64 * 513 - 1, 128, 64), (64 * 513 + 1, 128, 70),
                 (33, 2048, 5), (65, 512, 70)]


def _matmul_inputs(m, k, n, x_dtype, g):
    x = (torch.randn(m, k, device="cuda", generator=g)
         * torch.logspace(-2, 1, k, device="cuda")).to(x_dtype)
    am = x.float().abs().amax(dim=0) * 0.9  # some values clip
    wq = torch.randint(-127, 128, (k, n), device="cuda", generator=g, dtype=torch.int8)
    ws = torch.rand(n, device="cuda", generator=g) * 1e-3 + 1e-5
    return x, wq, ws, am, torch.randn(n, device="cuda", generator=g)


@pytest.mark.cuda
def test_int8_matmul_routes_agree_on_the_card():
    """K6 (the only route of matmul_int8 on the card) against its plain version, bit for
    bit (int8 sums, then the same IEEE steps), at every int8 site shape and the ragged
    ones, bf16/f32 x, bf16/f32 out, with and without the bias, on the plan the wrapper
    chooses; a row-strided x (a time step of the LSTM's input) and an odd K read element
    by element."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import kmajor_2d, matmul_int8, matmul_int8_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    for m, k, n in MATMUL_SHAPES:
        for x_dtype, out_dtype, bias in [(torch.bfloat16, torch.bfloat16, True),
                                         (torch.float32, torch.float32, False),
                                         (torch.bfloat16, torch.float32, True),
                                         (torch.float32, torch.bfloat16, False)]:
            x, wq, ws, am, b = _matmul_inputs(m, k, n, x_dtype, g)
            b = b if bias else None
            before = matmul_int8.launches
            y = matmul_int8(x, wq, ws, am, b, out_dtype, w_k=kmajor_2d(wq))
            ref = matmul_int8_plain(x, wq, ws, am, b, out_dtype)
            torch.cuda.synchronize()
            assert matmul_int8.launches == before + 1
            assert y.dtype == out_dtype and y.shape == (m, n)
            assert torch.equal(y, ref), (m, k, n, x_dtype, out_dtype, bias)
    seq = torch.randn(32, 5, 2048, device="cuda", generator=g)
    x = seq[:, 2]  # rows 5 * 2048 apart
    _, wq, ws, _, _ = _matmul_inputs(32, 2048, 512, torch.float32, g)
    am = x.abs().amax(dim=0)
    assert torch.equal(matmul_int8(x, wq, ws, am), matmul_int8_plain(x.contiguous(), wq, ws, am))


@pytest.mark.cuda
def test_int8_matmul_every_plan_agrees_on_the_card():
    """K6 under every variant its plans can take, forced (ops/matmul_plan.py plan_for):
    the bulk pipeline at 2 to 4 ring stages, the small
    variant at 16, 32 and 64 rows and split over clusters of 1, 2, 4 and 8 blocks (and
    its element path for an unaligned x), each bit for bit with the plain version at
    ragged M, N and K, bf16 and f32 x and y."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch import kernels
    from diamond_tpu_torch.ops import kmajor_2d, matmul_int8_plain
    from diamond_tpu_torch.ops import matmul_plan as mp

    g = torch.Generator(device="cuda").manual_seed(4)
    lib = kernels.lib()
    cases = [(mp.BULK, 64, None, s) for s in (2, 3, 4)]
    cases += [(mp.SMALL, bm, split, None) for bm in (16, 32, 64) for split in (1, 2, 4, 8)]
    ran = set()
    for m, k, n in [(128 * 65 + 1, 128, 70), (8191, 64, 24), (16 * 33 - 1, 2048, 5),
                    (32 * 5 + 1, 512, 192)]:
        for x_dtype, out_dtype in [(torch.bfloat16, torch.bfloat16), (torch.float32,
                                                                       torch.float32)]:
            x, wq, ws, am, b = _matmul_inputs(m, k, n, x_dtype, g)
            wk = kmajor_2d(wq)
            ref = matmul_int8_plain(x, wq, ws, am, b, out_dtype)
            xu = torch.empty(m * k + 1, device="cuda", dtype=x_dtype)[1:].view(m, k)
            xu.copy_(x)  # the same x at a base 2 or 4 bytes past 16-byte alignment
            for variant, bm, split, stages in cases:
                for xin, aligned in ((x, True), (xu, False)):
                    xb, ob = x.element_size(), ref.element_size()
                    if variant == mp.BULK and not mp.bulk_takes(m, k, n, k, xb, ob, aligned):
                        continue
                    p = mp.plan_for(m, k, n, k, xb, ob, aligned, variant, bm=bm, split=split,
                                    stages=stages)
                    if p.smem > mp.SMEM_BLOCK:
                        continue
                    y = torch.full_like(ref, float("nan"))
                    kernels.check(lib.matmul_q8_fwd(
                        xin.data_ptr(), am.data_ptr(), wk.data_ptr(), ws.data_ptr(),
                        b.data_ptr(), y.data_ptr(), p.c_ints,
                        torch.cuda.current_stream().cuda_stream), "matmul_q8_fwd")
                    torch.cuda.synchronize()
                    assert torch.equal(y, ref), (m, k, n, x_dtype, mp.describe(p), aligned)
                    ran.add((p.variant, p.bm, p.split, p.stages, p.vec))
    assert {(v, bm) for v, bm, *_ in ran} == {(v, bm) for v, bm, *_ in cases}
    assert {s for v, _, s, _, _ in ran if v == mp.SMALL} == {1, 2, 4, 8}
    assert {s for v, _, _, s, _ in ran if v == mp.BULK} == {2, 3, 4}
    assert {vec for v, *_, vec in ran if v == mp.SMALL} == {0, 1}


@pytest.mark.cuda
def test_int8_sites_on_the_card_make_one_k6_launch_and_no_int_mm():
    """A quantized Conv1x1 and QDense on the card: one K6 launch per call, and no
    aten::_int_mm, round, clamp or float64 matmul under the call; the same result as on
    the CPU bit for bit (the CPU takes the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from diamond_tpu_torch.models.blocks import Conv1x1, QDense, init_weights
    from diamond_tpu_torch.ops import matmul_int8

    gen = torch.Generator().manual_seed(3)
    for mod, shape in [(Conv1x1(128, 64, torch.bfloat16), (32, 8, 8, 128)),
                       (QDense(256, 128, torch.bfloat16), (32, 256))]:
        init_weights(mod, gen)
        x = torch.randn(shape, generator=gen)
        kind = "conv1x1" if isinstance(mod, Conv1x1) else "dense"
        w = mod.kernel[0, 0] if kind == "conv1x1" else mod.kernel
        reg = {}
        with torch.no_grad(), quant.int8_scope(True), quant.calibration_scope(reg, mod):
            mod(x)
        coll = quant.registry_to_collection(reg)
        assert set(coll) == {"act_scale", "w_q", "w_scale"} and w.shape == coll["w_q"].shape
        quant.install(mod, coll)
        with torch.no_grad(), quant.int8_scope(True):
            y_cpu = mod(x)
            mod.cuda()
            xc = x.cuda()
            mod(xc)
            before = matmul_int8.launches
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                y = mod(xc)
            torch.cuda.synchronize()
        ops = {e.key for e in prof.key_averages()}
        assert matmul_int8.launches == before + 1
        assert not ops & {"aten::_int_mm", "aten::round", "aten::clamp", "aten::mm",
                          "aten::matmul"}, ops
        assert y.dtype == torch.bfloat16 and torch.equal(y.cpu(), y_cpu)


K7_SHAPES = [((32, 64, 64, 64), 1), ((32, 64, 64, 64), 2), ((32, 64, 64, 15), 1),
             ((4, 9, 9, 15), 2), ((1, 5, 7, 64), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_int8_conv_matches_plain_bit_for_bit_without_a_sync(dtype):
    """K7 (``quant.conv3x3_q8``): its codes and sx against ``absmax_quantize_q8_plain``,
    and the conv through K5 against the plain conv of the plain codes, bit for bit, at the
    denoiser's 3x3 shapes (64x64 64 -> 64 at stride 1 and 2, conv_in's Cin 15) and ragged
    ones; the call makes no host-device synchronisation (sx stays on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (absmax_quantize_q8, absmax_quantize_q8_plain,
                                       conv3x3_int8_plain)

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(17)
    for shape, stride in K7_SHAPES:
        x = (torch.randn(shape, device="cuda", generator=g) * 3).to(dt)
        w = torch.randn(3, 3, shape[-1], 64, device="cuda", generator=g) / 24
        before = absmax_quantize_q8.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            qt = absmax_quantize_q8(x)
            y = quant.conv3x3_q8(x, w, stride)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = absmax_quantize_q8_plain(x)
        torch.cuda.synchronize()
        assert absmax_quantize_q8.launches == before + 2  # two calls: here and in the conv
        assert torch.equal(qt.q, ref.q) and torch.equal(qt.scale, ref.scale)
        assert (ref.scale == ref.scale[0]).all() and ref.scale.shape == (shape[0], 1)
        sw = w.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8) / torch.full((), 127.0, device="cuda")
        wq = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
        y_ref = conv3x3_int8_plain(ref.q, wq, sw, stride=stride, sample_scale=ref.scale)
        assert y.dtype == torch.float32 and torch.equal(y, y_ref)


@pytest.mark.cuda
def test_agent_defaults_to_the_card():
    """``Agent(cfg)`` without a device puts every model on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.config import AgentConfig
    from diamond_tpu_torch.models import Agent

    agent = Agent(AgentConfig(), generator=torch.Generator().manual_seed(0))
    for net in agent.nets.values():
        assert all(p.is_cuda for p in net.parameters())


# The backward kernels of the actor-critic train step: K2's backward at every norm
# signature class of the AC trunk (B, H, C) and ragged cases (odd H * W, C = 96 with
# three groups, B = 1, 64x64x128 on 16-block clusters, f32 64x64x128 and 64x64x256 whose
# x and dy spill out of shared memory), K3's
# weight and data gradients at every 3x3 conv signature of the trunk (B, H, W, Cin,
# Cout) and ragged cases (Cin = 3 and 6, odd H * W, Cout = 24 and 3, B = 1).
GN_BWD_SHAPES = [(32, 64, 32), (32, 32, 32), (32, 16, 32), (32, 8, 64), (1, 9, 32),
                 (3, 5, 96), (2, 64, 64), (4, 32, 128), (2, 64, 128)]
GN_BWD_F32_ONLY = [(1, 64, 256)]
WGRAD_SHAPES = [(32, 64, 64, 3, 32), (32, 64, 64, 32, 32), (32, 32, 32, 32, 32),
                (32, 16, 16, 32, 64), (32, 8, 8, 64, 64), (2, 9, 9, 3, 24), (3, 5, 7, 6, 3),
                (1, 33, 33, 64, 64), (2, 4, 150, 16, 8)]


def _bwd_close(a, b, tol):
    torch.cuda.synchronize()
    scale = max(1.0, b.float().abs().max().item())
    err = (a.float() - b.float()).abs().max().item()
    assert err <= tol * scale, (err, tol, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_versions(dtype):
    """K2's backward (dx, dscale, dbias, on the moments K2's forward kernel wrote) and
    K3's weight and data gradients against their plain versions (K2's recomputing the
    moments): bf16 within 1/64 of max(1, max |plain|) (one rounding to bf16 on each
    side); f32 with TF32 off, dx within 1e-4 and dscale, dbias, dW within 1e-3 (sums of
    up to 131k terms in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (conv3x3_dgrad, conv3x3_dgrad_plain, conv3x3_wgrad,
                                       conv3x3_wgrad_plain, groupnorm_silu_bwd,
                                       groupnorm_silu_bwd_plain, groupnorm_silu_with_moments)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    g = torch.Generator(device="cuda").manual_seed(7)
    for b, h, c in GN_BWD_SHAPES + (GN_BWD_F32_ONLY if f32 else []):
        x, _, sc, bi = _norm_inputs(b, h, c, dt, g)
        dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
        for silu in (True, False):
            _, mom = groupnorm_silu_with_moments(x, sc, bi, max(1, c // 32), silu)
            got = groupnorm_silu_bwd(x, dy, sc, bi, max(1, c // 32), silu, mom)
            ref = groupnorm_silu_bwd_plain(x, dy, sc, bi, max(1, c // 32), silu)
            for k, (a, r) in enumerate(zip(got, ref)):
                _bwd_close(a, r, (1e-4 if k == 0 else 1e-3) if f32 else 1 / 64)
    for b, h, w, cin, cout in WGRAD_SHAPES:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).to(dt)
        dy = torch.randn(b, h, w, cout, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        _bwd_close(conv3x3_wgrad(x, dy), conv3x3_wgrad_plain(x, dy), 1e-3 if f32 else 1 / 64)
        _bwd_close(conv3x3_dgrad(dy, k), conv3x3_dgrad_plain(dy, k), 1e-3 if f32 else 1 / 64)


@pytest.mark.cuda
def test_backward_kernels_repeat_bit_for_bit():
    """K2's backward (its last block sums the samples' partials in sample order, whichever
    block finishes last) and K3's weight gradient sum their partials in a fixed order: two
    calls on the same inputs give the same bits, in bf16 and f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (conv3x3_wgrad, groupnorm_silu_bwd,
                                       groupnorm_silu_with_moments)

    g = torch.Generator(device="cuda").manual_seed(8)
    for dt in (torch.bfloat16, torch.float32):
        for b, h, c in [(32, 64, 32), (32, 8, 64), (2, 64, 128)]:
            x, _, sc, bi = _norm_inputs(b, h, c, dt, g)
            dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
            _, mom = groupnorm_silu_with_moments(x, sc, bi, c // 32)
            first = groupnorm_silu_bwd(x, dy, sc, bi, c // 32, True, mom)
            again = groupnorm_silu_bwd(x, dy, sc, bi, c // 32, True, mom)
            torch.cuda.synchronize()
            assert all(torch.equal(a, r) for a, r in zip(first, again))
        for b, h, w, cin, cout in WGRAD_SHAPES[:5]:
            x = torch.randn(b, h, w, cin, device="cuda", generator=g).to(dt)
            dy = torch.randn(b, h, w, cout, device="cuda", generator=g).to(dt)
            assert torch.equal(conv3x3_wgrad(x, dy), conv3x3_wgrad(x, dy))


def _directional_check(fn, inputs, eps=1e-2, rtol=2e-2):
    """d/dh sum(fn(inputs + h v) * u) at h = 0 by central differences in f32, against
    autograd's <grad, v>: a gradcheck for f32 kernels (f32 steps cannot reach
    gradcheck's double-precision tolerances)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    vs = [torch.randn(t.shape, device="cuda", generator=g) for t in inputs]
    out = fn(*inputs)
    u = torch.randn(out.shape, device="cuda", generator=g)
    grads = torch.autograd.grad((out * u).sum(), inputs)
    analytic = sum((gr * v).sum() for gr, v in zip(grads, vs)).item()
    with torch.no_grad():
        plus = (fn(*(t + eps * v for t, v in zip(inputs, vs))).double() * u).sum().item()
        minus = (fn(*(t - eps * v for t, v in zip(inputs, vs))).double() * u).sum().item()
    numeric = (plus - minus) / (2 * eps)
    assert abs(numeric - analytic) <= rtol * max(1.0, abs(numeric)), (numeric, analytic)


@pytest.mark.cuda
def test_autograd_functions_pass_a_directional_gradcheck():
    """GroupNormSiLU and Conv3x3Fn on the card in f32 at a tiny shape: autograd's
    directional derivative (the backward kernels) equals central differences of the
    forward kernels to 2 % (f32 differences with step 1e-2), and the launch counters of
    the backward kernels rise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (conv3x3, conv3x3_dgrad, conv3x3_wgrad, groupnorm_silu,
                                       groupnorm_silu_bwd)

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(10)
    x = (torch.randn(2, 6, 6, 64, device="cuda", generator=g) * 2 + 0.5).requires_grad_()
    sc = (1 + 0.1 * torch.randn(64, device="cuda", generator=g)).requires_grad_()
    bi = (0.1 * torch.randn(64, device="cuda", generator=g)).requires_grad_()
    before = (groupnorm_silu_bwd.launches, conv3x3_dgrad.launches, conv3x3_wgrad.launches)
    for silu in (True, False):
        _directional_check(lambda a, s, b: groupnorm_silu(a, s, b, 2, silu), [x, sc, bi])
    xc = torch.randn(2, 7, 5, 16, device="cuda", generator=g).requires_grad_()
    k = (torch.randn(3, 3, 16, 8, device="cuda", generator=g) / 12).requires_grad_()
    bc = torch.randn(8, device="cuda", generator=g).requires_grad_()
    _directional_check(lambda a, w, b: conv3x3(a, w, b), [xc, k, bc])
    after = (groupnorm_silu_bwd.launches, conv3x3_dgrad.launches, conv3x3_wgrad.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
def test_norm_forwards_write_the_moments_their_backwards_read():
    """K1's and K2's forward kernels with the moments output: the same y bit for bit as
    without it (the rollout's calls pass none), and each group's mean and 1/std within
    1e-6 of max(1, their largest |value|) of the plain ones (f32 on both sides), at the
    step signatures and ragged cases, bf16 and f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (adagn_silu_with_moments, group_moments,
                                       groupnorm_silu_with_moments)

    g = torch.Generator(device="cuda").manual_seed(13)
    for dt in (torch.bfloat16, torch.float32):
        for b, h, c in K1_BWD_SHAPES + GN_BWD_SHAPES:
            gr = max(1, c // 32)
            x, ss, sc, bi = _norm_inputs(b, h, c, dt, g, torch.bfloat16)
            ref = group_moments(x, gr)
            for fn, with_moments, args in (
                    (adagn_silu, adagn_silu_with_moments, (x, ss, gr)),
                    (groupnorm_silu, groupnorm_silu_with_moments, (x, sc, bi, gr))):
                y, mom = with_moments(*args)
                torch.cuda.synchronize()
                assert torch.equal(y, fn(*args)), (fn.__name__, b, h, c, dt)
                assert mom.shape == (b, gr, 2) and mom.dtype == torch.float32
                err = (mom - ref).abs().max().item()
                assert err <= 1e-6 * max(1.0, ref.abs().max().item()), (b, h, c, dt, err)


@pytest.mark.cuda
def test_backward_plans_are_portable_and_k2_needs_one_launch():
    """The backward plans of every step signature use portable clusters (at most 8
    blocks); K2's backward is one launch (its last block sums the samples) and leaves its
    ticket counter at 0; both kernels refuse a call without the forward's moments."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from diamond_tpu_torch.ops import (adagn_silu_bwd, groupnorm_silu_bwd,
                                       groupnorm_silu_with_moments)
    from diamond_tpu_torch.ops.fused_norms import _ticket
    from diamond_tpu_torch.ops.norm_plan import bwd_plan

    for b, h, c in K1_BWD_SHAPES + GN_BWD_SHAPES:
        for es in (2, 4):
            assert bwd_plan(b, h * h, c, max(1, c // 32), es).n <= 8
    g = torch.Generator(device="cuda").manual_seed(14)
    x, ss, sc, bi = _norm_inputs(32, 64, 64, torch.bfloat16, g)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(torch.bfloat16)
    _, mom = groupnorm_silu_with_moments(x, sc, bi, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        groupnorm_silu_bwd(x, dy, sc, bi, 2, True, mom)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    assert launches == 1
    assert int(_ticket(x.device).item()) == 0
    with pytest.raises(ValueError, match="moments"):
        groupnorm_silu_bwd(x, dy, sc, bi, 2)
    with pytest.raises(ValueError, match="moments"):
        adagn_silu_bwd(x, dy, ss, 2)


# K1's backward at the denoiser step's signatures (B, H, C) and ragged cases; the
# stride-2 gradients at its Downsample convs (B, H, W, C -> C) and ragged cases (odd H
# and W, Cout = 3 and 24, Cin = 3).
K1_BWD_SHAPES = [(32, 64, 64), (32, 64, 128), (32, 32, 64), (32, 32, 128), (32, 16, 64),
                 (32, 16, 128), (32, 8, 64), (32, 8, 128), (1, 9, 32), (3, 5, 96)]
S2_SHAPES = [(32, 64, 64, 64, 64), (32, 32, 32, 64, 64), (32, 16, 16, 64, 64),
             (2, 9, 9, 32, 24), (3, 7, 5, 3, 32), (2, 9, 6, 16, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_backward_and_stride2_gradients_match_plain_versions(dtype):
    """K1's backward (dx, and the FiLM gradient from f32 and from bf16 rows, in their
    dtype, on the moments K1's forward kernel wrote) and K3's stride-2 data and weight
    gradients against their plain versions: bf16 outputs within 1/64 of max(1, max
    |plain|); f32 with TF32 off, dx within 1e-4, the FiLM gradient (per-sample sums over up
    to 4096 pixels) and the conv gradients within 1e-3. Both repeat bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (adagn_silu_bwd, adagn_silu_bwd_plain,
                                       adagn_silu_with_moments, conv3x3_dgrad,
                                       conv3x3_dgrad_plain, conv3x3_wgrad, conv3x3_wgrad_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    g = torch.Generator(device="cuda").manual_seed(11)
    for b, h, c in K1_BWD_SHAPES:
        for ss_dt in (torch.float32, torch.bfloat16):
            x, ss, _, _ = _norm_inputs(b, h, c, dt, g, ss_dt)
            dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
            for silu in (True, False):
                _, mom = adagn_silu_with_moments(x, ss, max(1, c // 32), silu)
                got = adagn_silu_bwd(x, dy, ss, max(1, c // 32), silu, mom)
                ref = adagn_silu_bwd_plain(x, dy, ss, max(1, c // 32), silu)
                assert got[1].shape == (b, 2 * c) and got[1].dtype == ss_dt
                for k, (a, r) in enumerate(zip(got, ref)):
                    bf = a.dtype == torch.bfloat16  # bf16 x, or the gradient of bf16 rows
                    _bwd_close(a, r, 1 / 64 if bf else 1e-4 if k == 0 else 1e-3)
            again = adagn_silu_bwd(x, dy, ss, max(1, c // 32), True, mom)
            first = adagn_silu_bwd(x, dy, ss, max(1, c // 32), True, mom)
            torch.cuda.synchronize()
            assert all(torch.equal(a, r) for a, r in zip(first, again))
    tol = 1e-3 if f32 else 1 / 64
    for b, h, w, cin, cout in S2_SHAPES:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).to(dt)
        dy = torch.randn(b, (h + 1) // 2, (w + 1) // 2, cout, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        _bwd_close(conv3x3_wgrad(x, dy, 2), conv3x3_wgrad_plain(x, dy, 2), tol)
        _bwd_close(conv3x3_dgrad(dy, k, 2, (h, w)), conv3x3_dgrad_plain(dy, k, 2, (h, w)), tol)
        assert torch.equal(conv3x3_wgrad(x, dy, 2), conv3x3_wgrad(x, dy, 2))


@pytest.mark.cuda
def test_k1_and_stride2_autograd_pass_a_directional_gradcheck():
    """AdaGroupNormSiLU and the stride-2 Conv3x3Fn on the card in f32 at a tiny shape:
    autograd's directional derivative (K1's backward, K3's stride-2 gradients: the
    stride-2 data-gradient kernel and the weight gradient with the bias's) equals central
    differences of the forward kernels to 2 %, and their counters rise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import adagn_silu_bwd, conv3x3_dgrad_s2, conv3x3_wgrad

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(12)
    x = (torch.randn(2, 6, 6, 64, device="cuda", generator=g) * 2 + 0.5).requires_grad_()
    ss = (0.5 * torch.randn(2, 128, device="cuda", generator=g)).requires_grad_()
    before = (adagn_silu_bwd.launches, conv3x3_dgrad_s2.launches, conv3x3_wgrad.launches)
    for silu in (True, False):
        _directional_check(lambda a, s: adagn_silu(a, s, 2, silu), [x, ss])
    xc = torch.randn(2, 7, 6, 16, device="cuda", generator=g).requires_grad_()
    k = (torch.randn(3, 3, 16, 8, device="cuda", generator=g) / 12).requires_grad_()
    bc = torch.randn(8, device="cuda", generator=g).requires_grad_()
    _directional_check(lambda a, w, b: conv3x3(a, w, b, 2), [xc, k, bc])
    after = (adagn_silu_bwd.launches, conv3x3_dgrad_s2.launches, conv3x3_wgrad.launches)
    assert all(a > b for a, b in zip(after, before))


# The redesigned gradients: the weight gradient (B, H, W, Cin, Cout, stride) at every
# signature of the denoiser step and the AC step (B = 32), then odd sizes and Cin = 3, 15
# and 128; the stride-2 data gradient (B, H, W, Cin, Cout) at the denoiser's Downsample
# convs, then odd sizes and Cin = 3, 15 and 128.
WGRAD_STEP_SHAPES = [(32, h, h, ci, co, s) for h, ci, co, s in [
    (64, 128, 64, 1), (64, 64, 64, 1), (64, 64, 64, 2), (64, 15, 64, 1), (64, 64, 3, 1),
    (32, 128, 64, 1), (32, 64, 64, 1), (32, 64, 64, 2), (16, 128, 64, 1), (16, 64, 64, 1),
    (16, 64, 64, 2), (8, 128, 64, 1), (8, 64, 64, 1), (64, 3, 32, 1), (64, 32, 32, 1),
    (32, 32, 32, 1), (16, 32, 64, 1)]] + [
    (2, 9, 9, 32, 24, 2), (2, 9, 9, 32, 24, 1), (3, 7, 5, 3, 32, 2), (3, 7, 5, 15, 8, 1),
    (2, 9, 6, 16, 3, 2), (2, 9, 6, 128, 64, 2), (2, 9, 9, 128, 40, 1), (1, 5, 300, 48, 16, 1)]
DGRAD_S2_SHAPES = [(32, 64, 64, 64, 64), (32, 32, 32, 64, 64), (32, 16, 16, 64, 64),
                   (2, 9, 9, 32, 24), (3, 7, 5, 3, 32), (2, 9, 6, 15, 3), (2, 9, 9, 128, 64),
                   (2, 7, 9, 64, 80), (1, 5, 300, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_with_bias_and_stride2_dgrad_match_plain_versions(dtype):
    """The weight-gradient kernel (wgmma, native stride 2, the bias gradient folded in)
    and the stride-2 data-gradient kernel against their plain versions: bf16 within 1/64
    of max(1, max |plain|), f32 (TF32 off) within 1e-3; db against dy's f32 sum within
    1e-3 of max(1, its largest |value|); the weight gradient without the bias equal to it
    with; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (conv3x3_dgrad, conv3x3_dgrad_s2, conv3x3_dgrad_s2_plain,
                                       conv3x3_wgrad, conv3x3_wgrad_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-3 if dt == torch.float32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(14)
    for b, h, w, cin, cout, s in WGRAD_STEP_SHAPES:
        x = torch.randn(b, h, w, cin, device="cuda", generator=g).to(dt)
        dy = torch.randn(b, (h - 1) // s + 1, (w - 1) // s + 1, cout, device="cuda",
                         generator=g).to(dt)
        dw, db = conv3x3_wgrad(x, dy, s, with_bias=True)
        _bwd_close(dw, conv3x3_wgrad_plain(x, dy, s), tol)
        _bwd_close(db, dy.sum(dim=(0, 1, 2), dtype=torch.float32), 1e-3)
        again = conv3x3_wgrad(x, dy, s, with_bias=True)
        alone = conv3x3_wgrad(x, dy, s)
        torch.cuda.synchronize()
        assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
        assert torch.equal(dw, alone), (b, h, w, cin, cout, s)
    for b, h, w, cin, cout in DGRAD_S2_SHAPES:
        dy = torch.randn(b, (h + 1) // 2, (w + 1) // 2, cout, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        dx = conv3x3_dgrad_s2(dy, k, (h, w))
        _bwd_close(dx, conv3x3_dgrad_s2_plain(dy, k, (h, w)), tol)
        again = conv3x3_dgrad(dy, k, 2, (h, w))  # the data gradient's stride-2 route
        torch.cuda.synchronize()
        assert torch.equal(dx, again), (b, h, w, cin, cout)


@pytest.mark.cuda
def test_stride2_conv_with_bias_passes_a_directional_gradcheck():
    """Conv3x3Fn at stride 2 with a bias, f32 on the card, at odd sizes and Cin = 3 and 15:
    autograd's directional derivative (the stride-2 data-gradient kernel and the weight
    gradient with the bias's in one call) equals central differences of K3 to 2 %; the
    stride-2 kernel and the weight gradient count their launches, the stride-1 data
    gradient (K3 on dy) none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import conv3x3_dgrad, conv3x3_dgrad_s2, conv3x3_wgrad

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(15)
    for b, h, w, cin, cout in [(2, 9, 9, 16, 24), (3, 7, 5, 3, 8), (2, 9, 6, 15, 32)]:
        xc = torch.randn(b, h, w, cin, device="cuda", generator=g).requires_grad_()
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (3 * cin ** .5)
             ).requires_grad_()
        bc = torch.randn(cout, device="cuda", generator=g).requires_grad_()
        before = (conv3x3_dgrad_s2.launches, conv3x3_wgrad.launches, conv3x3_dgrad.launches)
        _directional_check(lambda a, w_, b_: conv3x3(a, w_, b_, 2), [xc, k, bc])
        after = (conv3x3_dgrad_s2.launches, conv3x3_wgrad.launches, conv3x3_dgrad.launches)
        assert after[0] > before[0] and after[1] > before[1] and after[2] == before[2]


@pytest.mark.cuda
def test_int8_wrappers_refuse_a_gradient_under_grad_mode():
    """The forward-only int8 wrappers raise where an input of a CUDA call needs a
    gradient under grad mode, instead of returning a result cut from the graph; under
    no grad they run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(13)
    x, ss, sc, bi = _norm_inputs(2, 8, 64, torch.bfloat16, g)
    am = torch.rand(64, device="cuda", generator=g) + 0.5
    w = torch.randn(3, 3, 64, 32, device="cuda", generator=g) / 24
    wd = torch.randn(64, 16, device="cuda", generator=g) / 8
    mc, ic = torch.zeros(2, 64, device="cuda"), torch.ones(2, 64, device="cuda")
    calls = {
        "adagn_silu_q8": lambda x_, ss_: adagn_silu_q8(x_, ss_, 2, am),
        "groupnorm_silu_q8": lambda x_, ss_: groupnorm_silu_q8(x_, sc, ss_[0, :64], 2, am),
        "norm_affine_silu_q8": lambda x_, ss_: norm_affine_silu_q8(
            x_, mc, ic, 1 + ss_[:, :64], ss_[:, 64:]),
        "conv3x3_q8_static": lambda x_, ss_: quant.conv3x3_q8_static(
            x_, w, am, bias=ss_[0, :32], out_dtype=torch.bfloat16),
        "matmul_q8_static": lambda x_, ss_: quant.matmul_q8_static(x_, wd * ss_[0, 0], am),
    }
    for name, call in calls.items():
        with torch.no_grad():
            call(x, ss)
        for needs in ("x", "ss"):
            xa = x.detach().requires_grad_(needs == "x")
            sa = ss.detach().requires_grad_(needs == "ss")
            with pytest.raises(RuntimeError, match="no gradient"):
                call(xa, sa)



# The rew/end step's shapes: B * (T - 1) = 32 * 18 = 576 samples through the encoder at
# 32 channels (one group), 64x64 down to 8x8; conv_in reads concat(obs, next_obs), Cin 6.
REW_END_B = 576


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rew_end_step_shapes_match_plain_versions(dtype):
    """The backward kernels at the rew/end step's shapes against their plain versions,
    each repeating bit for bit: K1's backward at C = 32 (one group) and 576 samples from
    64x64 to 8x8 (FiLM rows in the run's dtype); K2's backward at B = 576, 8x8x32 without
    SiLU (the attention pre-norms: its last block sums 576 rows); the weight gradient
    with the bias at Cin = 6 (conv_in, 64x64) and 32 -> 32 at strides 1 and 2; the
    stride-2 data gradient at Cout = 32. bf16 within 1/64 of max(1, max |plain|); f32
    (TF32 off) dx within 1e-4, the affine, FiLM and conv gradients within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (adagn_silu_bwd, adagn_silu_bwd_plain,
                                       adagn_silu_with_moments, conv3x3_dgrad,
                                       conv3x3_dgrad_plain, conv3x3_wgrad, conv3x3_wgrad_plain,
                                       groupnorm_silu_bwd, groupnorm_silu_bwd_plain,
                                       groupnorm_silu_with_moments)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    g = torch.Generator(device="cuda").manual_seed(21)

    def same_bits(first, again):
        torch.cuda.synchronize()
        assert all(torch.equal(a, r) for a, r in zip(first, again))

    for h in (64, 32, 16, 8):
        x, ss, _, _ = _norm_inputs(REW_END_B, h, 32, dt, g, dt)
        dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
        _, mom = adagn_silu_with_moments(x, ss, 1)
        got = adagn_silu_bwd(x, dy, ss, 1, True, mom)
        for k, (a, r) in enumerate(zip(got, adagn_silu_bwd_plain(x, dy, ss, 1, True))):
            _bwd_close(a, r, 1 / 64 if not f32 else 1e-4 if k == 0 else 1e-3)
        same_bits(got, adagn_silu_bwd(x, dy, ss, 1, True, mom))
    x, _, sc, bi = _norm_inputs(REW_END_B, 8, 32, dt, g)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
    _, mom = groupnorm_silu_with_moments(x, sc, bi, 1, False)
    got = groupnorm_silu_bwd(x, dy, sc, bi, 1, False, mom)
    for k, (a, r) in enumerate(zip(got, groupnorm_silu_bwd_plain(x, dy, sc, bi, 1, False))):
        _bwd_close(a, r, (1e-4 if k == 0 else 1e-3) if f32 else 1 / 64)
    same_bits(got, groupnorm_silu_bwd(x, dy, sc, bi, 1, False, mom))
    tol = 1e-3 if f32 else 1 / 64
    for h, cin, s in ((64, 6, 1), (64, 32, 1), (64, 32, 2), (16, 32, 2), (8, 32, 1)):
        x = torch.randn(REW_END_B, h, h, cin, device="cuda", generator=g).to(dt)
        dy = torch.randn(REW_END_B, (h - 1) // s + 1, (h - 1) // s + 1, 32, device="cuda",
                         generator=g).to(dt)
        dw, db = conv3x3_wgrad(x, dy, s, with_bias=True)
        _bwd_close(dw, conv3x3_wgrad_plain(x, dy, s), tol)
        _bwd_close(db, dy.sum(dim=(0, 1, 2), dtype=torch.float32), 1e-3)
        same_bits((dw, db), conv3x3_wgrad(x, dy, s, with_bias=True))
        if cin == 32:
            k = (torch.randn(3, 3, cin, 32, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
            dx = conv3x3_dgrad(dy, k, s, (h, h))
            _bwd_close(dx, conv3x3_dgrad_plain(dy, k, s, (h, h)), tol)
            same_bits((dx,), (conv3x3_dgrad(dy, k, s, (h, h)),))


# the tiny trainer of tests/test_trainer_e2e.py (TINY_OVERRIDES, without importing that
# file: it imports jax)
TRAINER_TINY = [
    "env=fake", "env.train.size=16", "env.train.max_episode_steps=30", "common.seed=7",
    "agent.denoiser.inner_model.cond_channels=16", "agent.denoiser.inner_model.depths=[1,1]",
    "agent.denoiser.inner_model.channels=[8,8]", "agent.denoiser.inner_model.attn_depths=[0,0]",
    "agent.rew_end_model.lstm_dim=32", "agent.rew_end_model.cond_channels=8",
    "agent.rew_end_model.depths=[1,1]", "agent.rew_end_model.channels=[8,8]",
    "agent.rew_end_model.attn_depths=[0,0]", "agent.actor_critic.lstm_dim=32",
    "agent.actor_critic.channels=[8,8]", "agent.actor_critic.down=[1,1]",
    "collection.train.first_epoch.min=60", "collection.train.first_epoch.max=60",
    "collection.train.first_epoch.threshold_rew=1", "collection.train.num_steps_total=90",
    "collection.train.steps_per_epoch=30", "collection.test.num_episodes=1",
    "collection.test.num_final_episodes=2", "training.num_final_epochs=1",
    "denoiser.training.steps_first_epoch=3", "denoiser.training.steps_per_epoch=2",
    "denoiser.training.batch_size=4", "denoiser.training.lr_warmup_steps=2",
    "rew_end_model.training.steps_first_epoch=3", "rew_end_model.training.steps_per_epoch=2",
    "rew_end_model.training.batch_size=4", "actor_critic.training.steps_first_epoch=2",
    "actor_critic.training.steps_per_epoch=2", "actor_critic.training.batch_size=4",
    "actor_critic.actor_critic_loss.backup_every=5", "world_model_env.horizon=5",
    "world_model_env.num_batches_to_preload=8",
    "world_model_env.diffusion_sampler.num_steps_denoising=2", "evaluation.every=1"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["imagination", "model_free", "static"])
def test_trainer_runs_on_the_card_and_resumes(tmp_path, mode):
    """The tiny trainer on the card (bf16, int8 rollout, device store): two epochs and
    the final collection, then a resume that equals the saved state and runs one epoch
    more; model-free and static-dataset runs too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json

    import numpy as np

    from diamond_tpu_torch import ops
    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.data.episode import Episode
    from diamond_tpu_torch.trainer import Trainer

    extra = {"imagination": [],
             "model_free": ["training.model_free=True", "training.num_final_epochs=2"],
             "static": [f"static_dataset.path={tmp_path / 'static'}",
                        "training.num_final_epochs=2"]}[mode]
    if mode == "static":
        rng = np.random.default_rng(0)
        for split in ("train", "test"):
            ds = Dataset(tmp_path / "static" / split, f"{split}_dataset")
            for _ in range(3):
                end = np.zeros(24, np.uint8)
                end[-1] = 1
                ds.add_episode(Episode(
                    obs=rng.integers(0, 255, (24, 16, 16, 3), dtype=np.uint8),
                    act=rng.integers(0, 3, 24).astype(np.int32),
                    rew=rng.choice([-1.0, 0.0, 1.0], 24).astype(np.float32), end=end,
                    trunc=np.zeros(24, np.uint8),
                    info={"final_observation": rng.integers(0, 255, (16, 16, 3),
                                                            dtype=np.uint8)}))
            ds.save_to_default_path()
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    for name in ("conv3x3", "conv3x3_wgrad"):
        getattr(ops, name).launches = 0
    trainer = Trainer(load_config(TRAINER_TINY + extra), run_dir, run_dir=run_dir)
    trainer.run()
    assert trainer.epoch == 2
    assert ops.conv3x3.launches > 0 and ops.conv3x3_wgrad.launches > 0
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if k.endswith(("loss_total", "loss_denoising")))
    if mode != "static":
        assert any("final_return_mean" in r for r in rows)
    saved = torch.load(run_dir / "checkpoints" / "state.pt", weights_only=False)
    resumed = Trainer(load_config(TRAINER_TINY + extra + ["common.resume=True"]), run_dir,
                      run_dir=run_dir)
    state = resumed.state_dict()
    for name, ts in saved["train_states"].items():
        for k, v in ts["net"].items():
            assert torch.equal(v, state["train_states"][name]["net"][k]), (name, k)
    assert (resumed.epoch, resumed.num_batch_train) == (saved["epoch"], saved["num_batch_train"])
    resumed._cfg.training.num_final_epochs += 1
    resumed.run()
    assert resumed.epoch == 3


@pytest.mark.cuda
def test_trainer_epoch_1_trace_on_the_card(tmp_path):
    """``tpu.profile_dir`` on the card: the epoch-1 trace holds the device's kernels, the
    trainer's parts and the program's spans, the IC pool's background build on its own
    thread among them; each epoch's timings hold the pool's counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json

    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.trainer import Trainer

    run_dir = tmp_path / "run"
    run_dir.mkdir()
    trainer = Trainer(load_config(TRAINER_TINY + [f"tpu.profile_dir={tmp_path / 'prof'}"]),
                      run_dir, run_dir=run_dir)
    trainer.run()
    events = json.loads((tmp_path / "prof" / "epoch_1_trace.json").read_text())["traceEvents"]
    by_name = {}
    for e in events:
        by_name.setdefault(e.get("name"), []).append(e)
    assert any(e.get("cat") == "kernel" for e in events)
    assert {"trainer::collect_s", "trainer::actor_critic_s", "pool::ensure", "ac::rollout",
            "wm::transition", "ac::policy", "ac::loss", "train::backward",
            "train::update"} <= set(by_name)
    tids = lambda name: {e["tid"] for e in by_name.get(name, [])  # noqa: E731
                         if e.get("cat") == "user_annotation"}
    caller = tids("pool::ensure")
    # the first build on the caller's thread, the next ones on build threads
    assert tids("pool::build") & caller and tids("pool::build") - caller, by_name["pool::build"]
    epoch_1 = trainer.timings[1]
    assert epoch_1["epoch"] == 1 and epoch_1["pool_builds"] >= 2
    assert epoch_1["pool_gather_bytes"] > 0 and epoch_1["pool_build_s"] > 0


# ---------------------------------------------------------------------------
# The two-stage (csgo) world model: its shapes, a play step, its train steps, its trainer


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_stage_shapes_match_plain_versions(dtype):
    """The kernels at the two-stage model's new shapes against their plain versions: the
    dynamics U-Net's 4x4 and 2x2 levels at 64 channels (B = 1 in play, 32 in training),
    the stride-2 conv 4x4 -> 2x2, the upsampler's conv_in (Cin 6 at 64x64, B 1 and 32) and
    the dynamics conv_in (Cin 15 at 16x16); K1/K2 at 2x2x64 (two groups of four pixels)
    and at 64x64x64 with B = 1; their backwards, the data and weight gradients at 2x2 and
    4x4 and the weight gradient at Cin 6; K4 and K5 at B = 1. The tolerances of
    test_cuda_kernels_match_plain_versions and test_backward_kernels_match_plain_versions;
    K5 exactly; K4 on eight inputs a shape, within one code, and only where the plain
    value lies at a rounding boundary (as chip_smoke.py holds it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch.ops import (adagn_silu_bwd, adagn_silu_bwd_plain,
                                       adagn_silu_with_moments, conv3x3_dgrad,
                                       conv3x3_dgrad_plain, conv3x3_wgrad, conv3x3_wgrad_plain,
                                       groupnorm_silu_bwd, groupnorm_silu_bwd_plain,
                                       groupnorm_silu_with_moments)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    tol = 1e-3 if f32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(31)
    for b, h, cin, cout, s in ((1, 2, 64, 64, 1), (32, 2, 128, 64, 1), (1, 4, 64, 64, 1),
                               (1, 4, 64, 64, 2), (32, 4, 64, 64, 2), (1, 64, 6, 64, 1),
                               (32, 64, 6, 64, 1), (1, 16, 15, 64, 1), (1, 64, 64, 3, 1)):
        x = torch.randn(b, h, h, cin, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        bb = torch.randn(cout, device="cuda", generator=g)
        _bwd_close(conv3x3(x, k, bb, s), conv3x3_plain(x, k, bb, s), tol)
        dy = torch.randn(b, (h - 1) // s + 1, (h - 1) // s + 1, cout, device="cuda",
                         generator=g).to(dt)
        dw, db = conv3x3_wgrad(x, dy, s, with_bias=True)
        _bwd_close(dw, conv3x3_wgrad_plain(x, dy, s), tol)
        _bwd_close(db, dy.sum(dim=(0, 1, 2), dtype=torch.float32), 1e-3)
        if cin in (64, 128):
            _bwd_close(conv3x3_dgrad(dy, k, s, (h, h)), conv3x3_dgrad_plain(dy, k, s, (h, h)),
                       tol)
    for b, h in ((1, 2), (32, 2), (1, 4), (1, 64), (32, 8)):
        x, ss, sc, bi = _norm_inputs(b, h, 64, dt, g, dt)
        _bwd_close(adagn_silu(x, ss, 2), adagn_silu_plain(x, ss, 2), tol if f32 else 1 / 64)
        _bwd_close(groupnorm_silu(x, sc, bi, 2), groupnorm_silu_plain(x, sc, bi, 2),
                   tol if f32 else 1 / 64)
        dy = torch.randn(x.shape, device="cuda", generator=g).to(dt)
        _, mom = adagn_silu_with_moments(x, ss, 2)
        for k, (a, r) in enumerate(zip(adagn_silu_bwd(x, dy, ss, 2, True, mom),
                                       adagn_silu_bwd_plain(x, dy, ss, 2, True))):
            _bwd_close(a, r, (1e-4 if k == 0 else 1e-3) if f32 else 1 / 64)
        _, mom = groupnorm_silu_with_moments(x, sc, bi, 2)
        for k, (a, r) in enumerate(zip(groupnorm_silu_bwd(x, dy, sc, bi, 2, True, mom),
                                       groupnorm_silu_bwd_plain(x, dy, sc, bi, 2, True))):
            _bwd_close(a, r, (1e-4 if k == 0 else 1e-3) if f32 else 1 / 64)
        if b == 1:  # K4 and K5 as the int8 play path runs them, K4 on several inputs
            for i in range(8):
                if i:
                    x, ss = _norm_inputs(b, h, 64, dt, g, dt)[:2]
                am = adagn_silu_plain(x, ss, 2).float().abs().amax(dim=(0, 1, 2)) * 0.95
                q, ref = adagn_silu_q8(x, ss, 2, am), adagn_silu_q8_plain(x, ss, 2, am)
                torch.cuda.synchronize()
                _codes_at_boundary(static_code_flips(q, ref, adagn_silu_plain, x, ss, 2,
                                                     act_max=am), q.numel())
            wq = torch.randint(-127, 128, (3, 3, 64, 64), generator=g, device="cuda",
                               dtype=torch.int8)
            ws = torch.rand(64, generator=g, device="cuda") * 1e-3 + 1e-4
            args = (q, wq, ws, None, 0.1 * torch.randn(64, device="cuda", generator=g), 1, dt)
            torch.testing.assert_close(conv3x3_int8(*args), conv3x3_int8_plain(*args),
                                       rtol=0, atol=0)


def _two_stage_tiny(device, dtype=torch.float32):
    """A tiny two-stage agent (factor 2, 16x16 frames, 8x8 dynamics) with its engine."""
    from diamond_tpu_torch import config as tc
    from diamond_tpu_torch.envs.world_model_env import ImaginationEngine
    from diamond_tpu_torch.models import Agent

    inner = dict(cond_channels=16, depths=[1, 1], channels=[32, 32], attn_depths=[0, 0])
    cfg = tc.AgentConfig(
        denoiser=tc.DenoiserConfig(inner_model=tc.InnerModelConfig(num_steps_conditioning=2,
                                                                   **inner)),
        rew_end_model=tc.RewEndModelConfig(lstm_dim=32, img_size=8, cond_channels=8,
                                           depths=[1, 1], channels=[32, 32],
                                           attn_depths=[0, 0]),
        actor_critic=tc.ActorCriticConfig(lstm_dim=32, img_size=8, channels=[16, 32],
                                          down=[1, 1]),
        num_actions=3,
        upsampler=tc.DenoiserConfig(inner_model=tc.InnerModelConfig(
            num_steps_conditioning=1, **inner), upsampling_factor=2))
    agent = Agent(cfg, dtype, device=device, generator=torch.Generator().manual_seed(0))
    wm = tc.WorldModelEnvConfig(horizon=3)
    return agent, ImaginationEngine(agent.denoiser, agent.rew_end_model, agent.actor_critic, wm)


@pytest.mark.cuda
def test_two_stage_play_steps_on_the_card_match_the_cpu():
    """Four steps of the two-stage WorldModelEnv (B = 2, horizon 3: a refill) in f32 on
    the card (kernels, TF32 off) against the CPU (plain versions), the same weights, ICs
    and injected draws: rewards, ends and truncations equal, frames within one grid
    level; the card's step reads back once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from diamond_tpu_torch import ops
    from diamond_tpu_torch.envs.wm_env_stateful import StepDraws, WorldModelEnv
    from diamond_tpu_torch.envs.world_model_env import gumbel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    ics = (rng.integers(0, 256, (8, 2, 16, 16, 3), dtype=np.uint8),
           rng.integers(0, 3, (8, 2)).astype(np.int32),
           (0.1 * rng.normal(size=(8, 32))).astype(np.float32),
           (0.1 * rng.normal(size=(8, 32))).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    draws = [StepDraws(torch.randn(2, 8, 8, 3, generator=g), gumbel((2, 3), g, "cpu"),
                       gumbel((2, 2), g, "cpu"), torch.randn(2, 16, 16, 3, generator=g))
             for _ in range(4)]
    outs = []
    for dev in ("cuda", "cpu"):
        agent, engine = _two_stage_tiny(dev)
        pos = [0]

        def provider(n):
            out = tuple(a[pos[0]:pos[0] + n] for a in ics)
            pos[0] += n
            return out

        env = WorldModelEnv(engine, provider, 2, upsampler=agent.upsampler)
        env.reset()
        ops.conv3x3.launches = 0
        outs.append([env.step([i % 3, 1], StepDraws(*(d.to(dev) for d in dr)))
                     for i, dr in enumerate(draws)])
        if dev == "cuda":
            assert ops.conv3x3.launches > 0
    for c, p in zip(*outs):
        for k in (1, 2, 3):
            np.testing.assert_array_equal(c[k], p[k])
        assert np.abs(c[0].astype(int) - p[0].astype(int)).max() <= 1
        assert np.abs(c[4]["low_res_obs"].astype(int)
                      - p[4]["low_res_obs"].astype(int)).max() <= 1
    assert any("final_observation" in c[4] for c in outs[0])


@pytest.mark.cuda
def test_two_stage_train_steps_make_no_sync():
    """The upsampler step and the two-stage denoiser step (frames downsampled in the step)
    on the card under the sync debug mode set to error: no host-device synchronisation,
    finite metrics, the backward kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch import config as tc
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.data.segment import DeviceBatch
    from diamond_tpu_torch.models.agent import configure_opt
    from diamond_tpu_torch.training import (TrainState, make_denoiser_train_step,
                                            make_upsampler_train_step)

    agent, _ = _two_stage_tiny("cuda", torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(2)

    def batch(b, t):
        z = dict(device="cuda", dtype=torch.int32)
        return DeviceBatch(
            obs=torch.randint(0, 256, (b, t, 16, 16, 3), generator=g, device="cuda",
                              dtype=torch.uint8),
            act=torch.randint(0, 3, (b, t), generator=g, device="cuda", dtype=torch.int32),
            rew=torch.zeros((b, t), device="cuda"), end=torch.zeros((b, t), **z),
            trunc=torch.zeros((b, t), **z),
            mask_padding=torch.ones((b, t), dtype=torch.bool, device="cuda"),
            final_obs=torch.zeros((b, 16, 16, 3), dtype=torch.uint8, device="cuda"),
            has_final_obs=torch.zeros((b,), dtype=torch.bool, device="cuda"))

    sigma = tc.SigmaDistributionConfig()
    for model, make, b, t in ((agent.upsampler, make_upsampler_train_step, 4, 2),
                              (agent.denoiser, make_denoiser_train_step, 4, 4)):
        tx = configure_opt(1e-4, 1e-2, 1e-8, 1.0, 0)
        kw = {} if make is make_upsampler_train_step else {"downsample_factor": 2}
        step = make(model, tx, sigma, **kw)
        state = TrainState.create(model.inner_model, tx)
        data = batch(b, t)
        step(state, data, generator=g)  # warm-up: the kernels' first loads
        ops.conv3x3_wgrad.launches = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, data, generator=g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ops.conv3x3_wgrad.launches > 0
        assert all(torch.isfinite(v).all() for v in m.values())


@pytest.mark.cuda
def test_two_stage_trainer_runs_on_the_card_and_resumes(tmp_path):
    """The tiny wm_only two-stage trainer (agent=csgo, factor 2, 16x16 frames) on a
    static dataset on the card: two epochs with evaluation, a resume equal to the saved
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from diamond_tpu_torch.config import load_config
    from diamond_tpu_torch.data.dataset import Dataset
    from diamond_tpu_torch.data.episode import Episode
    from diamond_tpu_torch.trainer import Trainer

    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        ds = Dataset(tmp_path / "static" / split, f"{split}_dataset")
        for _ in range(3):
            end = np.zeros(24, np.uint8)
            end[-1] = 1
            ds.add_episode(Episode(obs=rng.integers(0, 255, (24, 16, 16, 3), dtype=np.uint8),
                                   act=rng.integers(0, 3, 24).astype(np.int32),
                                   rew=np.zeros(24, np.float32), end=end,
                                   trunc=np.zeros(24, np.uint8)))
        ds.save_to_default_path()
    overrides = [o for o in TRAINER_TINY if not o.startswith(("collection.", "training."))] + [
        "agent=csgo", "agent.upsampler.upsampling_factor=2",
        "agent.upsampler.inner_model.cond_channels=16", "agent.upsampler.inner_model.depths=[1]",
        "agent.upsampler.inner_model.channels=[8]", "agent.upsampler.inner_model.attn_depths=[0]",
        "upsampler.training.steps_first_epoch=3", "upsampler.training.steps_per_epoch=2",
        "upsampler.training.batch_size=2", "upsampler.training.lr_warmup_steps=2",
        "training.wm_only=True", "training.num_final_epochs=2",
        f"static_dataset.path={tmp_path / 'static'}"]
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    trainer = Trainer(load_config(overrides), run_dir, run_dir=run_dir)
    trainer.run()
    assert trainer.epoch == 2 and trainer.train_states["upsampler"].step == 5
    lines = (run_dir / "metrics.jsonl").read_text()
    assert "upsampler/test/loss_denoising" in lines and "rew_end_model/" not in lines
    saved = torch.load(run_dir / "checkpoints" / "state.pt", weights_only=False)
    resumed = Trainer(load_config(overrides + ["common.resume=True"]), run_dir, run_dir=run_dir)
    state = resumed.state_dict()
    for name, ts in saved["train_states"].items():
        for k, v in ts["net"].items():
            assert torch.equal(v, state["train_states"][name]["net"][k]), (name, k)


# ---------------------------------------------------------------------------
# The play app at batch 1: the default Atari agent's shapes, the actor-critic, the app

# (B, H, Cin, Cout, stride) of the default agent's 3x3 convs at B = 1: the denoiser's
# conv_in (Cin 15: four conditioning frames and the noisy one), its levels at 64 channels
# and its conv_out; the rew/end encoder's conv_in (Cin 6) and levels at 32 channels; the
# actor-critic's conv_in (Cin 3) and its SmallResBlocks' convs
PLAY_CONVS = ([(1, 64, 15, 64, 1), (1, 64, 64, 3, 1), (1, 64, 6, 32, 1), (1, 64, 3, 32, 1),
               (1, 16, 32, 64, 1)]
              + [(1, h, 64, 64, s) for h in (64, 32, 16, 8) for s in (1, 2) if h > 8 or s == 1]
              + [(1, h, 32, 32, s) for h in (64, 32, 16, 8) for s in (1, 2) if h > 8 or s == 1])
PLAY_NORMS = [(h, c) for h in (64, 32, 16, 8) for c in (32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_play_shapes_match_plain_versions(dtype):
    """The kernels at the play app's batch-1 shapes against their plain versions: K3 at
    every 3x3 conv of the default agent (the actor-critic's Cin 3 and 32 -> 64 among
    them); K1 and K2 (the actor-critic's SmallResBlock norms) at 64/32/16/8 with 32 and 64
    channels; K4's static epilogue on eight inputs a shape, within one code and only where
    the plain value lies at a rounding boundary; K5 exactly. The tolerances of
    test_cuda_kernels_match_plain_versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    tol = 1e-3 if dt == torch.float32 else 1 / 64
    g = torch.Generator(device="cuda").manual_seed(41)
    for b, h, cin, cout, s in PLAY_CONVS:
        x = torch.randn(b, h, h, cin, device="cuda", generator=g).to(dt)
        k = (torch.randn(3, 3, cin, cout, device="cuda", generator=g) / (9 * cin) ** .5).to(dt)
        bb = torch.randn(cout, device="cuda", generator=g)
        _bwd_close(conv3x3(x, k, bb, s), conv3x3_plain(x, k, bb, s), tol)
    for h, c in PLAY_NORMS:
        gr = max(1, c // 32)
        x, ss, sc, bi = _norm_inputs(1, h, c, dt, g, dt)
        _bwd_close(adagn_silu(x, ss, gr), adagn_silu_plain(x, ss, gr),
                   1e-4 if dt == torch.float32 else 1 / 64)
        _bwd_close(groupnorm_silu(x, sc, bi, gr), groupnorm_silu_plain(x, sc, bi, gr),
                   1e-4 if dt == torch.float32 else 1 / 64)
        for i in range(8):
            if i:
                x, ss = _norm_inputs(1, h, c, dt, g, dt)[:2]
            am = adagn_silu_plain(x, ss, gr).float().abs().amax(dim=(0, 1, 2)) * 0.95
            q, ref = adagn_silu_q8(x, ss, gr, am), adagn_silu_q8_plain(x, ss, gr, am)
            torch.cuda.synchronize()
            _codes_at_boundary(static_code_flips(q, ref, adagn_silu_plain, x, ss, gr,
                                                 act_max=am), q.numel())
        wq = torch.randint(-127, 128, (3, 3, c, c), generator=g, device="cuda",
                           dtype=torch.int8)
        ws = torch.rand(c, generator=g, device="cuda") * 1e-3 + 1e-4
        args = (q, wq, ws, None, 0.1 * torch.randn(c, device="cuda", generator=g), 1, dt)
        torch.testing.assert_close(conv3x3_int8(*args), conv3x3_int8_plain(*args), rtol=0,
                                   atol=0)


@pytest.mark.cuda
def test_actor_critic_at_batch_1_bf16_matches_the_cpu():
    """The default agent's actor-critic ([32, 32, 64, 64], LSTM 512, 64x64 frames) at
    B = 1 in bf16 on the card (K3 at Cin 3, K2 in the SmallResBlocks) against the same
    weights on the CPU (plain versions, bf16): logits and value within 1/32 of max(1,
    max |CPU|) (bf16 rounded after each layer on both sides, in other orders), the carry
    within the same; the kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diamond_tpu_torch import config as tc
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.models import ActorCritic

    cfg = tc.ActorCriticConfig(num_actions=4)
    gen = torch.Generator().manual_seed(7)
    obs = torch.rand(1, 64, 64, 3, generator=gen) * 2 - 1
    carry = tuple(0.1 * torch.randn(1, 512, generator=gen) for _ in range(2))
    outs = []
    for dev in ("cuda", "cpu"):
        ac = ActorCritic(cfg, torch.bfloat16)
        torch.manual_seed(3)
        with torch.no_grad():
            for p in ac.net.parameters():  # every weight non-zero, the heads too
                p.copy_(torch.randn(p.shape) / max(1, p[..., 0].numel()) ** 0.5)
        ac.net.to(dev)
        before = (ops.conv3x3.launches, ops.groupnorm_silu.launches)
        with torch.no_grad():
            out = ac.head(ac.encode(obs.to(dev)), tuple(c.to(dev) for c in carry))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.conv3x3.launches > before[0] and ops.groupnorm_silu.launches > before[1]
        outs.append([out.logits_act.float().cpu(), out.val.float().cpu(),
                     *(c.float().cpu() for c in out.carry)])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= max(1.0, b.abs().max().item()) / 32


@pytest.mark.cuda
def test_play_app_builds_and_plays_on_the_card(tmp_path):
    """python -m diamond_tpu_torch.play's builder on the card from a tiny run dir
    (config/trainer.json, an agent snapshot): --int8 --record, frames in both controls,
    the env cycle, then --dataset-mode over the recording."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    import numpy as np

    from diamond_tpu_torch import config as tc
    from diamond_tpu_torch import ops
    from diamond_tpu_torch.models import Agent
    from diamond_tpu_torch.play import build_app, parse_args

    cfg = tc.load_config(["env=fake", "env.train.size=16"] + [
        f"agent.{m}.{k}" for m, k in (
            ("denoiser.inner_model", "channels=[32,32]"), ("denoiser.inner_model", "depths=[1,1]"),
            ("denoiser.inner_model", "attn_depths=[0,0]"),
            ("denoiser.inner_model", "cond_channels=16"), ("rew_end_model", "lstm_dim=32"),
            ("rew_end_model", "channels=[32,32]"), ("rew_end_model", "depths=[1,1]"),
            ("rew_end_model", "attn_depths=[0,0]"), ("rew_end_model", "cond_channels=8"),
            ("actor_critic", "lstm_dim=32"), ("actor_critic", "channels=[32,32]"),
            ("actor_critic", "down=[1,1]"))])
    tc.save_config(cfg, tmp_path / "config" / "trainer.json")
    acfg = copy.deepcopy(cfg.agent)
    acfg.num_actions = 3
    acfg.__post_init__()
    (tmp_path / "checkpoints" / "agent_versions").mkdir(parents=True)
    Agent(acfg, torch.float32, device="cpu", generator=torch.Generator().manual_seed(0)).save(
        tmp_path / "checkpoints" / "agent_versions" / "agent_epoch_00001.npz")
    app = build_app(parse_args(["--run-dir", str(tmp_path), "-n", "40", "--horizon", "4",
                                "--int8", "-r"]), device="cuda")
    app.reset()
    ops.conv3x3_int8.launches = ops.conv3x3.launches = 0
    for i in range(16):
        app.human = i < 8
        obs, *_ = app.step(i % 3)
        assert obs.shape == (16, 16, 3) and obs.dtype == np.uint8
    assert ops.conv3x3_int8.launches > 0 and ops.conv3x3.launches > 0
    for _ in app.envs:
        app.cycle_env(1)
        app.step(1)
    browser = build_app(parse_args(["--run-dir", str(tmp_path), "-d"]))
    assert browser.datasets and browser.reset()[0].shape == (16, 16, 3)
