"""Kernel K5's launch plan (surs_tpu_torch/ops/row_gather.py:
row_gather_plan) and its plain version in the kernel's order
(row_gather_tiled_ref), on the CPU: every row copied exactly once, the
sizes the bulk-copy engine and the mbarriers take, a grid that fits the
card at once; the kernel's order against row_gather_ref bit for bit,
rows of zeros for indices outside the map; the wrapper's rejection of a
plan the kernel would refuse.
"""

import dataclasses

import numpy as np
import pytest
import torch

from surs_tpu_torch.ops import row_gather as rg

torch.set_num_threads(1)

SMS, OCCUPANCY = 132, 3
ROW_BYTES = (16, 400, 8192)


def counts(row_bytes):
    """n = 1, T - 1, T, T + 1 around loop's tile T, and the probe's
    49,151 and 49,152."""
    tile = rg.loop_tile(row_bytes)[0]
    return sorted({1, max(1, tile - 1), tile, tile + 1, 49151, 49152})


CASES = [(v, rb, n) for v in rg.VARIANTS for rb in ROW_BYTES
         for n in counts(rb)]


@pytest.mark.parametrize("variant,row_bytes,n", CASES)
def test_plan_covers_every_row_once_and_fits(variant, row_bytes, n):
    plan = rg.row_gather_plan(n, row_bytes, variant, SMS, OCCUPANCY)
    assert 1 <= plan.grid <= SMS * OCCUPANCY
    spans = list(rg.plan_spans(plan, n))
    covered = np.zeros(n, dtype=np.int64)
    for block, row0, cnt in spans:
        assert 0 <= block < plan.grid and cnt >= 1
        covered[row0:row0 + cnt] += 1
    assert (covered == 1).all()
    rg.check_plan(plan, row_bytes)
    if variant == "vec":
        assert plan.threads == rg.VEC_THREADS
        # no more blocks than give each lane VEC_UNROLL vectors
        vectors = n * row_bytes // 16
        assert plan.grid <= max(1, -(-vectors // (rg.VEC_THREADS
                                                  * rg.VEC_UNROLL)))
        assert all(cnt <= rg.VEC_BATCH for _, _, cnt in spans)
        return
    tile_bytes = plan.tile_rows * row_bytes
    assert plan.threads == rg.LOOP_THREADS
    assert 1 <= plan.tile_rows <= rg.LOOP_MAX_TILE
    # bulk copies: a row, a tile and every stage offset a multiple of 16
    assert row_bytes % 16 == 0 and tile_bytes % 16 == 0
    assert plan.stage_bytes == tile_bytes
    assert rg.LOOP_BARRIER_BYTES % 16 == 0
    # a stage's bytes are one mbarrier transaction count
    assert tile_bytes < rg.TX_LIMIT
    assert rg.LOOP_MIN_STAGES <= plan.stages <= rg.LOOP_MAX_STAGES
    assert plan.smem_bytes == rg.LOOP_BARRIER_BYTES + plan.stages * tile_bytes
    assert plan.smem_bytes <= rg.SMEM_PER_BLOCK
    assert rg.LOOP_BARRIER_BYTES >= 8 * plan.stages
    # every block has a tile; tiles of a block are consecutive
    assert plan.grid <= -(-n // plan.tile_rows)
    blocks = [b for b, _, _ in spans]
    assert blocks == sorted(blocks) and set(blocks) == set(range(plan.grid))


def test_largest_loop_row_fits_and_one_more_does_not():
    tile, stages = rg.loop_tile(rg.LOOP_MAX_ROW_BYTES)
    assert (tile, stages) == (1, rg.LOOP_MIN_STAGES)
    assert rg.loop_smem(rg.LOOP_MAX_ROW_BYTES) <= rg.SMEM_PER_BLOCK
    assert rg.loop_smem(rg.LOOP_MAX_ROW_BYTES + 16384) > rg.SMEM_PER_BLOCK


@pytest.mark.parametrize("vecs", [1, 2, 8, 25, 32, 33, 512])
def test_vec_walk_visits_each_vector_of_a_batch(vecs):
    total = 32 * vecs if vecs <= 32 else 3 * vecs + 5
    rows, cols = rg.vec_walk(vecs, total)
    p = np.arange(total)
    np.testing.assert_array_equal(rows, p // vecs)
    np.testing.assert_array_equal(cols, p % vecs)


def _map(rows, channels, dtype, seed=0):
    rng = np.random.default_rng(seed)
    feat = torch.from_numpy(rng.standard_normal((rows, channels)).astype(
        np.float32)).to(dtype)
    return feat, rng


def _raw(x):
    return x.view(torch.uint8)


@pytest.mark.parametrize("dtype,channels", [(torch.bfloat16, 256),
                                            (torch.bfloat16, 200),
                                            (torch.bfloat16, 8),
                                            (torch.float32, 2048)])
@pytest.mark.parametrize("variant", rg.VARIANTS)
def test_kernel_order_matches_plain_version(dtype, channels, variant):
    """At n = 1, T - 1, T + 1 and a count over many tiles; on the card's
    grid, and on 1 SM of 3 blocks (several tiles and batches a block, the
    ring's stages reused)."""
    rows = 97
    feat, rng = _map(rows, channels, dtype)
    row_bytes = channels * feat.element_size()
    tile = rg.loop_tile(row_bytes)[0]
    for n in sorted({1, max(1, tile - 1), tile + 1, 9 * tile + 5}):
        idx = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32))
        want = rg.row_gather_ref(feat, idx)
        for sms, occ in ((SMS, OCCUPANCY), (1, 3)):
            plan = rg.row_gather_plan(n, row_bytes, variant, sms, occ)
            got = rg.row_gather_tiled_ref(feat, idx, plan)
            assert got.dtype == feat.dtype and got.shape == want.shape
            assert torch.equal(_raw(got), _raw(want)), (n, plan)


@pytest.mark.parametrize("variant", rg.VARIANTS)
def test_kernel_order_writes_zero_rows_outside_the_map(variant):
    """A whole tile (and vec batch) of indices outside [0, rows), between
    tiles in range and at the ragged end, and a count of them alone."""
    rows, channels = 64, 256
    feat, rng = _map(rows, channels, torch.bfloat16, seed=1)
    tile = rg.loop_tile(channels * 2)[0]
    outside = np.array([-1, rows, -2 ** 31, 2 ** 31 - 1, rows + 7, -rows])
    mixed = rng.integers(0, rows, 4 * tile + 3)
    mixed[tile:2 * tile] = np.resize(outside, tile)
    mixed[-5:] = outside[:5]
    for case in (mixed, np.resize(outside, tile)):
        idx = torch.from_numpy(case.astype(np.int32))
        inside = ((idx >= 0) & (idx < rows))[:, None]
        at = feat[idx.clamp(0, rows - 1).long()]
        want = torch.where(inside, at, torch.zeros_like(at))
        for sms, occ in ((SMS, OCCUPANCY), (1, 1)):
            plan = rg.row_gather_plan(len(case), channels * 2, variant, sms,
                                      occ)
            got = rg.row_gather_tiled_ref(feat, idx, plan)
            assert torch.equal(_raw(got), _raw(want)), plan


def _bad_plans():
    loop = rg.row_gather_plan(64, 512, "loop", SMS, OCCUPANCY)
    vec = rg.row_gather_plan(64, 512, "vec", SMS, OCCUPANCY)
    return {
        "vec plan for loop": ("loop", vec),
        "loop plan for vec": ("vec", loop),
        "no blocks": ("vec", dataclasses.replace(vec, grid=0)),
        "two stages": ("loop", dataclasses.replace(
            loop, stages=2,
            smem_bytes=rg.LOOP_BARRIER_BYTES + 2 * loop.stage_bytes)),
        "tile over 128 rows": ("loop", dataclasses.replace(
            loop, tile_rows=129, stage_bytes=129 * 512)),
        "stage not its tile": ("loop", dataclasses.replace(
            loop, stage_bytes=loop.stage_bytes + 16)),
        "ring over shared memory": ("loop", dataclasses.replace(
            loop, tile_rows=128, stage_bytes=65536, stages=4,
            smem_bytes=rg.LOOP_BARRIER_BYTES + 4 * 65536)),
    }


@pytest.mark.parametrize("case", sorted(_bad_plans()))
def test_wrapper_rejects_plan_the_kernel_refuses(case):
    variant, plan = _bad_plans()[case]
    feat = torch.zeros((64, 256), dtype=torch.bfloat16)
    idx = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        rg.row_gather(feat, idx, variant, plan)
    assert rg.row_gather.launches == 0


def test_breakdown_ablations_apply_to_the_kernel_source():
    """Each ablation of the K5 breakdown probe finds its text exactly
    once, so the probe builds what it names."""
    from surs_tpu_torch.ops import cuda_build
    from surs_tpu_torch.probes.k5_breakdown import ABLATIONS

    assert "full" in ABLATIONS
    for name, edits in ABLATIONS.items():
        for f, old, _ in edits:
            text = (cuda_build.CSRC / f).read_text()
            assert text.count(old) == 1, (name, f)
