"""The fused-bucketize launcher's launch plan, on the CPU: the grid, which
path a block takes for the column ids of its tile and the table's size, and
the search's trip count for each column width, against hand-worked cases."""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.kernels.fused_transform import fused_transform as ft

SMS = 132  # an H100's SMs


@pytest.mark.parametrize("n,n_bounds,n_cols,blocks,whole", [
    (1_310_720, 340, 20, 132 * 8, True),   # the MSE step: 1,280 tiles, eight blocks an SM stride over them
    (200_000, 3_593, 100, 196, False),     # the operator benchmark: a block a tile of 1,024 values
    (5_000, 340, 20, 5, True),             # fewer tiles than the card's blocks: one block a tile
    (3, 340, 20, 1, True), (1_025, 3_593, 100, 2, False),
    (1_024, 1_024 - 21, 20, 1, True),      # 1,024 words: the whole table fits
    (1_024, 1_024 - 20, 20, 1, False),     # one word over
    (2_000_000, 15_000, 5, 1_954, False),  # a 60 KB table
])
def test_the_grid_follows_n_and_the_table(n, n_bounds, n_cols, blocks, whole):
    plan = ft.launch_plan(n, n_bounds, n_cols, SMS)
    assert plan == (blocks, whole)
    tiles = -(-n // ft.TILE)
    assert plan.blocks == (min(tiles, SMS * ft.BLOCKS_PER_SM) if whole else tiles)


def test_without_staging_every_tile_has_a_block():
    assert ft.launch_plan(1_310_720, 340, 20, SMS, stage=False) == (1_280, False)


def test_the_block_count_follows_the_sm_count():
    assert ft.launch_plan(1_310_720, 340, 20, 10).blocks == 80


def _offsets(widths):
    return np.concatenate([[0], np.cumsum(widths)]).tolist()


@pytest.mark.parametrize("widths,budget,most_boundaries", [
    ([int(w) for w in np.random.default_rng(1).integers(8, 64, 100)], 2_000, 126),  # the operator shape
    ([30] * 50, 700, 90),                                                          # three columns a tile
])
def test_a_tile_of_contiguous_columns_stages_one_to_three_columns(widths, budget, most_boundaries):
    """The engine lays each column's values out contiguously, so the block
    of a tile of 1,024 values stages the boundaries of the few columns it
    reads, not the whole table (here over 1,024 words)."""
    offs = _offsets(widths)
    cids = np.repeat(np.arange(len(widths)), budget)
    for i in range(0, cids.size, ft.TILE):
        t = cids[i:i + ft.TILE]
        assert ft.block_path(t.tolist(), offs) == (ft.STAGED, offs[t.min()], offs[t.max() + 1])
        assert offs[t.max() + 1] - offs[t.min()] <= most_boundaries
    assert len(offs) + offs[-1] > ft.STAGE_WORDS


def test_ids_in_any_order_over_a_large_table_read_through_the_cache():
    """Random column ids over the operator benchmark's 3,593 boundaries
    need all of them, which do not fit: the block reads them through the
    read-only cache; a table that fits is staged whole whatever the ids."""
    widths = [int(w) for w in np.random.default_rng(1).integers(8, 64, 100)]
    ids = np.random.default_rng(2).integers(0, 100, ft.TILE).tolist()
    assert ft.block_path(ids, _offsets(widths)) == (ft.CACHED, 0, sum(widths))
    assert ft.block_path(ids[:10], _offsets([3] * 100))[0] == ft.STAGED  # 401 words: staged whole


def test_a_tile_that_stages_exactly_the_budget():
    """Columns of 1,000, 24 and 5 boundaries (1,033 words: not staged
    whole): the first two take 1,024 boundaries and are staged, all three
    are not; ids of empty ranges (-1, >= C) widen nothing."""
    offs = _offsets([1_000, 24, 5])
    assert ft.block_path([1, 2], offs) == (ft.STAGED, 1_000, 1_029)
    assert ft.block_path([0, 1], offs) == (ft.STAGED, 0, 1_024)
    assert ft.block_path([0, 2], offs) == (ft.CACHED, 0, 1_029)
    assert ft.block_path([0, 1, -1, 3, 7], offs) == (ft.STAGED, 0, 1_024)


def test_over_1024_columns_the_offsets_are_not_staged():
    offs = _offsets([1] * 1_100)
    assert ft.block_path([5, 6], offs) == (ft.CACHED, 5, 7)


@pytest.mark.parametrize("widths,layout,paths", [
    ([17] * 20, "random", {"staged"}),                     # 361 words: staged whole, whatever the ids
    ([int(w) for w in np.random.default_rng(1).integers(8, 64, 100)], "contiguous", {"staged"}),
    ([int(w) for w in np.random.default_rng(1).integers(8, 64, 100)], "random", {"cached"}),
    ([600, 900, 5, 3_000], "contiguous", {"staged", "cached"}),  # the 3,000-wide column's tiles do not fit
])
def test_the_paths_of_a_launch(widths, layout, paths):
    n = 20_000
    ids = np.repeat(np.arange(len(widths)), -(-n // len(widths)))[:n]
    if layout == "random":
        ids = np.random.default_rng(0).permutation(ids)
    assert ft.launch_paths(ids, _offsets(widths), SMS) == paths


@pytest.mark.parametrize("ids,lo,hi", [
    ([-1], 0, 0),     # offsets[C] to offsets[0]: an empty range
    ([-2], 12, 15),   # column C - 1
    ([-5], 0, 5),     # -(C+1) counts from the end once: column 0
    ([-9], 0, 0), ([4], 0, 0), ([7], 0, 0),  # below, or >= C: empty
    ([1], 0, 0),      # a width-0 column
    ([0, 2, -1], 0, 12),
])
def test_out_of_range_ids_read_what_jnp_reads(ids, lo, hi):
    offs = [0, 5, 5, 12, 15]  # C = 4
    assert ft.block_path(ids, offs) == (ft.STAGED, lo, hi)


def _search(bounds: list[float], v: float, steps: int) -> int:
    """The kernel's halving (the TPU kernel's) over one column, ``steps``
    times, the index clamped into the column."""
    lo, hi = 0, len(bounds)
    for _ in range(steps):
        mid = (lo + hi) // 2
        right = mid < hi and v >= bounds[min(mid, len(bounds) - 1)]
        lo, hi = (mid + 1, hi) if right else (lo, min(mid, hi))
    return lo


@pytest.mark.parametrize("width,steps", [(0, 0), (1, 1), (2, 2), (3, 2), (4, 3), (7, 3), (8, 4), (17, 5),
                                         (31, 5), (32, 6), (63, 6), (64, 7), (1_000, 10), (3_000, 12)])
def test_the_trip_count_of_each_width(width, steps):
    """ceil(log2(w + 1)) halvings find every answer 0..w of a column of
    width w, and one fewer misses one (the warp takes the count of its
    widest column, so narrower ones are found too)."""
    assert ft.trip_count(width) == steps
    bounds = [float(i) for i in range(width)]
    answers = range(width + 1)  # v = a - 0.5 has a boundaries below it
    assert all(_search(bounds, a - 0.5, steps) == a for a in answers)
    assert all(_search(bounds, a - 0.5, steps + 3) == a for a in answers)
    if width:
        assert any(_search(bounds, a - 0.5, steps - 1) != a for a in answers)
