"""The host side of the fused GroupNorm kernels (K1 adagn_silu, K2 groupnorm_silu, K4's
static epilogue): the launch plans of diamond_tpu_torch/ops/norm_plan.py and the way the
kernel (kernels/csrc/gn_common.cuh gn_cluster_kernel) walks a sample under them,
replayed here. The kernels themselves run on a card (tests/test_torch_cuda.py); these
checks need none."""

import numpy as np
import pytest

from diamond_tpu_torch.ops import norm_plan as npl
from diamond_tpu_torch.ops.norm_plan import norm_plan, plan_for, plan_ok

# Every norm signature of both rollout paths at B = 32, (H, C) of x (B, H, H, C): the
# denoiser's AdaGN at 64/32/16/8 with C = 64 and 128, the rew/end model's (C = 32, one
# group) and the actor-critic's GroupNorms (C = 32 and 64); each in bf16 (2-byte) and
# f32 (4-byte) elements.
ROLLOUT = [(h, c) for h in (64, 32, 16, 8) for c in (32, 64, 128)]
DTYPES = {"bf16": 2, "f32": 4}
# Ragged cases (B, H, C, G, elem_bytes): B = 1, C = 32 with one group, C = 128, odd
# H = W = 9, a C that is not a power of two, the f32 sample too large to stay on chip.
RAGGED = [(1, 64, 64, 2, 2), (2, 9, 32, 1, 2), (2, 9, 128, 4, 4), (3, 5, 96, 3, 2),
          (1, 64, 256, 8, 4), (4, 7, 512, 16, 2)]


def _groups(c):
    return max(1, c // 32)


def _cases():
    for h, c in ROLLOUT:
        for name, es in DTYPES.items():
            yield pytest.param(32, h, c, _groups(c), es, id=f"{name}-{h}x{h}x{c}")
    for b, h, c, g, es in RAGGED:
        yield pytest.param(b, h, c, g, es, id=f"ragged-b{b}-{h}x{h}x{c}-g{g}-e{es}")


def walk(p, rank):
    """The element offsets (within its sample) that each thread of block ``rank`` visits,
    in order, as the kernel's statistics pass runs them: chunk by chunk over the part on
    chip, then the rest. Also the bulk copies' (offset, bytes). The apply pass visits
    the same offsets in the same order, two steps at a time."""
    c, v, nt = p.C, p.vec, p.threads
    span_px = min(p.ppb, p.HW - rank * p.ppb)
    span, res, chunk, step = span_px * c, min(span_px, p.rpx) * c, p.cpx * c, nt * v
    base = rank * p.ppb * c
    nchunks = -(-res // chunk)
    copies = [(base + k * chunk, min(chunk, res - k * chunk) * p.elem_bytes)
              for k in range(nchunks)]
    seqs = []
    for t in range(nt):
        parts = [np.arange(k * chunk + t * v, min((k + 1) * chunk, res), step)
                 for k in range(nchunks)]
        parts.append(np.arange(res + t * v, span, step))
        seqs.append(base + np.concatenate(parts))
    return seqs, copies


@pytest.mark.parametrize("b,h,c,g,es", list(_cases()))
def test_plan_fits_the_card_and_the_kernel(b, h, c, g, es):
    """The plan agrees with the kernel's own check (norm_plan_ok), has at most 16 blocks
    per sample (more than 8 only where 8 would hold more than 64 KB each), and stays
    within a block's 227 KB of shared memory with the kernel's static part; its dynamic
    part is x's span, C floats of 1/s_c and the n ranks' G partials."""
    p = norm_plan(b, h * h, c, g, es)
    assert plan_ok(p)
    assert p.n in (1, 2, 4, 8, 16) and p.blocks == b * p.n
    assert p.n <= 8 or h * h * c * es > 8 * npl.WIDE_BYTES
    assert p.smem == p.rpx * c * es + 4 * c + 8 * p.n * g
    assert p.smem + npl.SMEM_STATIC <= npl.SMEM_BLOCK == 232_448
    assert p.threads % (c // p.vec) == 0 and p.threads <= 256
    assert list(p.c_ints) == [getattr(p, f) for f in npl.PLAN_FIELDS]
    assert norm_plan(b, h * h, c, g, es) is p  # cached: computed from shape and dtype only


@pytest.mark.parametrize("b,h,c,g,es", list(_cases()))
def test_spans_cover_every_pixel_once_and_threads_keep_their_channels(b, h, c, g, es):
    """Replays the kernel's walk: the blocks' spans are whole pixels that cover the
    sample once; every element is visited by exactly one thread; a thread's offsets all
    fall on the same V channels ((t * V) % C onwards); the bulk copies are 16-byte sized
    and aligned, within an mbarrier's transaction count, and copy exactly the part on
    chip."""
    p = norm_plan(b, h * h, c, g, es)
    per_sample = h * h * c
    seen = np.zeros(per_sample, dtype=np.int64)
    for rank in range(p.n):
        assert rank * p.ppb < h * h  # no block without pixels
        seqs, copies = walk(p, rank)
        for t, seq in enumerate(seqs):
            assert (seq % c == (t * p.vec) % c).all()
            assert (np.diff(seq) > 0).all()
            for j in range(p.vec):
                seen[seq + j] += 1
        base = rank * p.ppb * c
        assert base % c == 0 and copies[0][0] == base
        on_chip = min(p.ppb, h * h - rank * p.ppb, p.rpx) * c * es
        assert sum(n for _, n in copies) == on_chip <= p.smem
        for off, n in copies:
            assert (off * es) % 16 == 0 and n % 16 == 0 and 0 < n < 1 << 20
    assert (seen == 1).all()


@pytest.mark.parametrize("h,c", ROLLOUT)
def test_every_bf16_rollout_signature_keeps_x_on_chip(h, c):
    """x is read from device memory once: each block holds its whole span."""
    p = norm_plan(32, h * h, c, _groups(c), 2)
    assert p.resident and p.rpx == p.ppb


@pytest.mark.parametrize("h,c", ROLLOUT)
def test_every_f32_rollout_signature_keeps_x_on_chip(h, c):
    """The f32 parity runs' shapes fit too (f32 64x64x128, 2 MB, in 16 blocks of 128 KB)."""
    p = norm_plan(32, h * h, c, _groups(c), 4)
    assert p.resident


def test_a_sample_too_large_for_the_cluster_is_planned_as_a_spill():
    """f32 64x64x128 at 8 blocks (256 KB each) and f32 64x64x256 at 16 keep what fits
    on chip, in whole steps, and read the rest of their spans from device memory."""
    for p in (plan_for(32, 64 * 64, 128, 4, 4, 8), norm_plan(1, 64 * 64, 256, 8, 4)):
        assert plan_ok(p) and not p.resident and p.rpx < p.ppb
        assert p.rpx % p.step_px == 0 and p.chunks <= npl.MAX_CHUNKS
        assert p.smem <= npl.SMEM_DYNAMIC


def test_cluster_size_follows_the_sample_bytes():
    """One block for a sample of at most 16 KB, twice as many for each doubling up to 8,
    and 16 where 8 blocks would hold more than 64 KB each."""
    assert norm_plan(32, 64, 64, 2, 2).n == 1            # 8x8x64 bf16, 8 KB
    assert norm_plan(32, 256, 64, 2, 2).n == 2           # 16x16x64, 32 KB
    assert norm_plan(32, 1024, 64, 2, 2).n == 8          # 32x32x64, 128 KB
    assert norm_plan(32, 4096, 64, 2, 2).n == 8          # 64x64x64, 512 KB: 64 KB blocks
    assert norm_plan(32, 4096, 128, 4, 2).n == 16        # 64x64x128, 1 MB: 64 KB blocks


@pytest.mark.parametrize("c,g,es", [(1024, 128, 2), (36, 1, 2), (66, 1, 4), (64, 16, 2),
                                    (96, 3, 3), (4096, 64, 2)])
def test_plan_refuses_what_the_kernel_cannot_take(c, g, es):
    """More than 64 groups; C not a whole number of 16-byte vectors (bf16, f32); a group
    narrower than a vector; an element size other than 2 or 4 bytes; C / V above 256."""
    with pytest.raises(ValueError):
        norm_plan(2, 64, c, g, es)


def test_plan_ok_refuses_a_plan_that_disagrees_with_the_kernel():
    """A plan whose fields do not fit together is refused, as the kernel refuses it."""
    import dataclasses

    p = norm_plan(32, 1024, 64, 2, 2)
    for bad in (dict(n=17), dict(n=p.n - 1), dict(threads=p.threads + 8), dict(smem=p.smem - 4),
                dict(chunks=p.chunks + 1), dict(cpx=p.cpx + 1), dict(resident=0),
                dict(smem=npl.SMEM_DYNAMIC + 16), dict(G=65)):
        assert not plan_ok(dataclasses.replace(p, **bad)), bad


@pytest.mark.parametrize("clusters,q8", [(0, False), (0, True), (3, False), (3, True)])
def test_wide_plan_falls_back_to_8_blocks_where_the_card_cannot_place_it(monkeypatch,
                                                                          clusters, q8):
    """The wrapper asks the card (gn_max_clusters / gn_q8_max_clusters) whether it can
    place a 16-block cluster: it keeps the plan where the card holds at least one, and
    launches the 8-block plan of the same call where it holds none."""
    import contextlib
    import types

    import torch

    from diamond_tpu_torch.ops import fused_norms

    asked = []

    def ask(kind):
        return lambda c_ints: asked.append((kind, list(c_ints))) or clusters

    fake = types.SimpleNamespace(gn_max_clusters=ask("gn"), gn_q8_max_clusters=ask("q8"))
    monkeypatch.setattr(fused_norms.kernels, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    fused_norms.placed_plan.cache_clear()
    try:
        p = norm_plan(32, 64 * 64, 128, 4, 2)
        got = fused_norms.placed_plan(p, q8, 0)
        assert fused_norms.placed_plan(p, q8, 0) is got  # asked once per plan and card
    finally:
        fused_norms.placed_plan.cache_clear()
    assert asked == [("q8" if q8 else "gn", list(p.c_ints))]
    if clusters:
        assert got is p
    else:
        assert got == plan_for(32, 64 * 64, 128, 4, 2, 8) and got.n == 8 and plan_ok(got)


def test_a_failed_placement_query_raises(monkeypatch):
    """A CUDA error from the query (returned negated) is raised, not taken as a plan."""
    import contextlib
    import types

    import torch

    from diamond_tpu_torch.ops import fused_norms

    fake = types.SimpleNamespace(gn_max_clusters=lambda c_ints: -98)
    monkeypatch.setattr(fused_norms.kernels, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    fused_norms.placed_plan.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="CUDA error 98"):
            fused_norms.placed_plan(norm_plan(32, 64 * 64, 128, 4, 2), False, 0)
    finally:
        fused_norms.placed_plan.cache_clear()


# ---------------------------------------------------------------------------
# The backward's own plan (kernels/csrc/gn_bwd.cu, norm_plan.bwd_plan)

# Every norm-backward signature of the train steps at B = 32, (H, C, G): the denoiser's K1
# at 64/32/16/8 with C = 64 and 128 and its K2 (norm_out 64x64x64, the attention
# pre-norms 8x8x64), the actor-critic trunk's K2 (64x64x32, 32x32x32, 16x16x32, 8x8x64)
STEP_BWD = sorted({(h, c, c // 32) for h in (64, 32, 16, 8) for c in (64, 128)}
                  | {(64, 32, 1), (32, 32, 1), (16, 32, 1)})
BWD_RAGGED = [(1, 9, 32, 1, 2), (3, 5, 96, 3, 2), (4, 7, 512, 16, 4), (1, 64, 256, 8, 4),
              (2, 33, 64, 2, 2)]


def _bwd_cases():
    for h, c, g in STEP_BWD:
        for name, es in DTYPES.items():
            yield pytest.param(32, h, c, g, es, id=f"{name}-{h}x{h}x{c}")
    for b, h, c, g, es in BWD_RAGGED:
        yield pytest.param(b, h, c, g, es, id=f"ragged-b{b}-{h}x{h}x{c}-g{g}-e{es}")


def bwd_walk(p, rank):
    """The element offsets (within its sample) each thread of block ``rank`` visits in
    the backward's summing pass, in order (the part in device memory first, then the
    chunks on chip), those of its dx pass over the part in device memory (last written
    first), and the bulk copies' (offset, bytes) of each array."""
    c, v, nt = p.C, p.vec, p.threads
    span_px = min(p.ppb, p.HW - rank * p.ppb)
    span, res, chunk, step = span_px * c, min(span_px, p.rpx) * c, p.cpx * c, nt * v
    base = rank * p.ppb * c
    nchunks = -(-res // chunk)
    copies = [(base + k * chunk, min(chunk, res - k * chunk) * p.elem_bytes)
              for k in range(nchunks)]
    sums, back = [], []
    for t in range(nt):
        parts = [np.arange(res + t * v, span, step)]
        parts += [np.arange(k * chunk + t * v, min((k + 1) * chunk, res), step)
                  for k in range(nchunks)]
        sums.append(base + np.concatenate(parts))
        back.append(base + np.arange(res + t * v, span, step)[::-1])
    return sums, back, copies


@pytest.mark.parametrize("b,h,c,g,es", list(_bwd_cases()))
def test_bwd_spans_cover_every_pixel_once_and_fit_the_blocks_per_sm(b, h, c, g, es):
    """Replays the backward kernel's walk: the blocks' spans are whole pixels that cover
    the sample once; the summing pass visits every element by exactly one thread, each
    thread on its V channels; the dx pass revisits the part in device memory, each
    element by the thread that wrote its g there; the bulk copies (x and dy, one barrier
    each chunk) are 16-byte sized and aligned and copy the part on chip; the block's
    shared memory (x and dy on chip, the per-channel sums, the partials, the channel sums
    sent to it) fits four blocks an SM, and the 2C channel sums are owned once (c % n)."""
    p = npl.bwd_plan(b, h * h, c, g, es)
    assert npl.bwd_plan_ok(p) and p.n <= npl.BWD_CLUSTER
    assert npl.BWD_BLOCKS_PER_SM * (p.smem + npl.BWD_STATIC + npl.SMEM_RESERVED) <= npl.SMEM_SM
    seen = np.zeros(h * h * c, dtype=np.int64)
    for rank in range(p.n):
        assert rank * p.ppb < h * h  # no block without pixels
        sums, back, copies = bwd_walk(p, rank)
        for t, (seq, rev) in enumerate(zip(sums, back)):
            assert (seq % c == (t * p.vec) % c).all()
            for j in range(p.vec):
                seen[seq + j] += 1
            assert set(rev.tolist()) <= set(seq.tolist()) and (np.diff(rev) < 0).all()
        on_chip = min(p.ppb, h * h - rank * p.ppb, p.rpx) * c * es
        assert sum(n for _, n in copies) == on_chip
        for off, n in copies:
            assert (off * es) % 16 == 0 and n % 16 == 0 and 0 < 2 * n < 1 << 20
    assert (seen == 1).all()
    owners = [ch % p.n for ch in range(2 * c)]
    mine = [(2 * c - r + p.n - 1) // p.n for r in range(p.n)]
    assert [owners.count(r) for r in range(p.n)] == mine
    assert max(mine) == -(-2 * c // p.n)


def test_bwd_cluster_size_follows_the_block_bytes():
    """The smallest of 1, 2, 4 or 8 blocks per sample that leaves a block at most 16 KB
    of x and dy, at most 8 (a portable cluster): 8x8x64 bf16 (16 KB) one block, 16x16x64
    (64 KB) four, 64x64 and 32x32 eight, whatever the dtype."""
    assert npl.bwd_plan(32, 64, 64, 2, 2).n == 1
    assert npl.bwd_plan(32, 64, 128, 4, 2).n == 2
    assert npl.bwd_plan(32, 256, 64, 2, 2).n == 4
    assert npl.bwd_plan(32, 256, 32, 1, 2).n == 2
    for hw, c, es in [(1024, 32, 2), (1024, 64, 4), (4096, 32, 2), (4096, 128, 4)]:
        assert npl.bwd_plan(32, hw, c, c // 32, es).n == 8
