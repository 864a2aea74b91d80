"""The host side of K6 (ops/matmul_q8.py): the launch plans of
diamond_tpu_torch/ops/matmul_plan.py and the way the kernel (kernels/csrc/matmul_q8.cu)
walks a call under them, replayed here. The kernel itself runs on a card
(tests/test_torch_cuda.py); these checks need none."""

import numpy as np
import pytest

from diamond_tpu_torch.ops import matmul_plan as mp
from diamond_tpu_torch.ops.matmul_plan import BULK, SMALL, matmul_plan, plan_for, plan_ok

from test_torch_cuda import MATMUL_SHAPES

# (M, K, N) of the play and two-stage paths' K6 calls at batch 1 (x (1, H, H, K)): the
# csgo dynamics U-Net's projections at 2x2 to 64x64 and the default agent's at 8x8 to
# 64x64, its attention's qkv (N = 192) and out projections, the rew/end model's
PLAY_SHAPES = [(h * h, 128, 64) for h in (2, 4, 8, 16, 32, 64)] + [
    (m, k, n) for m in (4, 64) for k, n in ((32, 32), (32, 96), (64, 192), (64, 64))]
# ragged M at the edges of every tile size the plans take (16 to 64 rows) and of the
# bulk threshold, and ragged N
EDGES = [(16 * 9 + 1, 128, 64), (32 * 77 - 1, 64, 192), (64 * 129 + 1, 32, 96),
         (16383, 128, 64), (16385, 128, 64), (64 * 513 - 1, 128, 64), (64 * 513 + 1, 128, 70),
         (33, 2048, 5), (65, 512, 70)]
DTYPES = {"bf16": (2, 2), "f32": (4, 4), "bf16-f32": (2, 4), "f32-bf16": (4, 2)}
SHAPES = sorted(set(MATMUL_SHAPES) | set(PLAY_SHAPES) | set(EDGES))


def _cases():
    for m, k, n in SHAPES:
        for name, (xb, ob) in DTYPES.items():
            yield pytest.param(m, k, n, xb, ob, id=f"{name}-{m}x{k}x{n}")


def covered(p):
    """How many times the kernel writes each element of y (M, N), and how many times each
    output tile sums each channel of K, replayed block by block under plan p."""
    writes = np.zeros((p.M, p.N), np.int32)
    sums = {}
    for b in range(p.grid):
        if p.variant == BULK:  # persistent: column tile b % col_tiles, every step-th row tile
            ct, step = b % p.col_tiles, p.grid // p.col_tiles
            tiles = [(rt, ct, 0) for rt in range(b // p.col_tiles, p.row_tiles, step)]
            slab_cols = [(0, p.bn)]  # a consumer warp owns 16 rows and every column
        else:
            rank, tile = b % p.split, b // p.split
            tiles = [(tile // p.col_tiles, tile % p.col_tiles, rank)]
            wn = p.bn // 8 // p.nt
            slab_cols = [(w * p.nt * 8, (w + 1) * p.nt * 8) for w in range(wn)]
        for rt, ct, rank in tiles:
            k0, k1 = rank * p.kspan, min(p.kp, (rank + 1) * p.kspan)
            sums.setdefault((rt, ct), []).append((k0, k1))
            if rank:  # the cluster's first block alone writes y
                continue
            for r0 in range(rt * p.bm, min(p.M, (rt + 1) * p.bm), 16):
                for c0, c1 in slab_cols:
                    n0 = ct * p.bn
                    writes[r0:min(p.M, r0 + 16), n0 + c0:min(p.N, n0 + c1)] += 1
    return writes, sums


@pytest.mark.parametrize("m,k,n,xb,ob", list(_cases()))
def test_plan_fits_the_card_and_covers_the_call_once(m, k, n, xb, ob):
    """Every site and path shape, in every dtype pair, gets a plan the kernel's own check
    takes: shared memory within 227 KB, a cluster of at most 8 blocks, at most 288
    threads; under it the kernel writes each element of y once and each output tile sums
    each channel of K (rounded up to the mma's 32) once."""
    p = matmul_plan(m, k, n, k, xb, ob, True)
    assert plan_ok(p)
    assert 0 < p.smem <= 227 * 1024 and 1 <= p.split <= 8 and p.threads <= 288
    assert p.variant == (BULK if m >= mp.BULK_MIN_M and (n * ob) % 16 == 0
                         and (k * xb) % 16 == 0 else SMALL)
    writes, sums = covered(p)
    assert (writes == 1).all()
    assert len(sums) == p.tiles
    for spans in sums.values():
        spans = sorted(spans)
        assert spans[0][0] == 0 and spans[-1][1] == p.kp
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_rollout_projections_take_the_pipeline_and_small_calls_fill_the_card():
    """The 64² and 32² projections (M >= 16,384) take the bulk variant with a ring of at
    least two stages and at most three blocks an SM, the 16² one (M = 8,192) the small
    variant; a call at M = 2,048 spreads over as many blocks as the card has SMs, or one
    a 16-row tile; the LSTM's gates at M = 32 split K over a cluster."""
    for m in (131072, 32768):
        p = matmul_plan(m, 128, 64, 128, 2, 2, True)
        assert p.variant == BULK and p.stages >= 2
        assert p.grid <= mp.BULK_BLOCKS_PER_SM * mp.NUM_SMS
    assert matmul_plan(8192, 128, 64, 128, 2, 2, True).variant == SMALL
    for k, n in ((128, 64), (64, 64), (64, 192), (32, 96)):
        p = matmul_plan(2048, k, n, k, 2, 2, True)
        assert p.variant == SMALL
        assert p.grid >= min(mp.NUM_SMS, 2048 // 16 * p.col_tiles)
    for k, n in ((2048, 2048), (512, 2048), (512, 512)):
        p = matmul_plan(32, k, n, k, 4, 4, True)
        assert p.split > 1 and p.grid == p.tiles * p.split


@pytest.mark.parametrize("variant,bm,split,stages", [
    (BULK, 64, None, 2), (BULK, 64, None, 3), (BULK, 64, None, 4),
    (SMALL, 16, 1, None), (SMALL, 32, 2, None), (SMALL, 64, 4, None), (SMALL, 16, 8, None)])
def test_every_variant_the_kernel_takes_covers_ragged_calls(variant, bm, split, stages):
    """Each bulk ring depth, each small tile size and split the card tests force: plans
    the kernel takes that cover a call with ragged M, N and K once."""
    for m, k, n in ((128 * 65 + 1, 128, 70), (8191, 64, 24), (16 * 33 - 1, 2048, 5)):
        if variant == BULK and not mp.bulk_takes(m, k, n, k, 2, 2, True):
            continue
        p = plan_for(m, k, n, k, 2, 2, True, variant, bm=bm, split=split, stages=stages)
        assert plan_ok(p) and p.bm == bm and p.smem <= mp.SMEM_BLOCK
        writes, sums = covered(p)
        assert (writes == 1).all() and len(sums) == p.tiles


@pytest.mark.parametrize("m,k,ldx,xb,aligned", [
    (300, 15, 15, 2, True),       # K = 15: rows of 30 bytes
    (7, 33, 33, 4, True),         # K = 33: rows of 132 bytes
    (32, 2048, 2048, 4, False),   # a base that is not 16-byte aligned
    (9000, 128, 131, 2, True),    # a row stride that is not a whole 16 bytes
    (32, 512, 5 * 512 + 2, 4, True)])
def test_rows_bulk_copies_cannot_move_take_the_element_path(m, k, ldx, xb, aligned):
    """A row stride, row length or base that is not 16-byte aligned gets the small
    variant's element-by-element copy, whatever M; aligned ones get 16-byte copies."""
    p = matmul_plan(m, k, 64, ldx, xb, 2, aligned)
    assert p.variant == SMALL and p.vec == 0 and plan_ok(p)
    q = matmul_plan(m, k + -k % 8, 64, k + -k % 8, xb, 2, True)
    assert q.vec == 1 and plan_ok(q)


@pytest.mark.parametrize("args", [(0, 32, 8, 32, 2, 2), (4, 0, 8, 0, 2, 2), (4, 32, 0, 32, 2, 2),
                                  (4, 32, 8, 32, 1, 2), (4, 32, 8, 16, 2, 2),
                                  (4, 32, 8, 32, 2, 1)])
def test_no_plan_for_what_the_kernel_does_not_take(args):
    """Empty shapes, int8 codes (1-byte x) or outputs, and a row stride below K are
    refused."""
    with pytest.raises(ValueError):
        matmul_plan(*args)

