"""Launcher of the CUDA fused-bucketize kernel (``csrc/fused_transform.cu``),
the port of ``repro/kernels/fused_transform/fused_transform.py::
fused_bucketize_padded``, and its launch plan (pure, tested on the CPU)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels.fused_transform import ref

THREADS = 256          # a block's threads
V = 4                  # consecutive values a thread takes from a tile
TILE = THREADS * V     # a tile's values
BLOCKS_PER_SM = 8      # resident blocks an SM holds of the whole-table kernel (its launch bounds)
STAGE_WORDS = 1024     # a block's staging room (4-byte words): the whole table, or offsets and boundaries
STAGED, CACHED = 0, 1  # the kernel's two paths
PATHS = ("staged", "cached")


class Plan(NamedTuple):
    blocks: int  # blocks of THREADS threads
    whole: bool  # every block stages the whole table and strides over the tiles


def launch_plan(n: int, n_bounds: int, n_cols: int, sms: int, stage: bool = True) -> Plan:
    """The grid for N values over a table of B boundaries and C columns on
    a card of ``sms`` SMs. A table whose C + 1 offsets and B boundaries fit
    STAGE_WORDS is staged whole by every block, BLOCKS_PER_SM blocks an SM
    striding over the tiles; else each tile of TILE values has a block,
    which stages the boundaries it reads where they fit (``block_path``).
    ``stage=False`` gives every tile a block that stages nothing."""
    tiles = -(-n // TILE)
    whole = stage and n_bounds + n_cols + 1 <= STAGE_WORDS
    return Plan(min(tiles, sms * BLOCKS_PER_SM) if whole else tiles, whole)


def block_path(column_ids, offsets) -> tuple[int, int, int]:
    """How the block of one tile searches its values, given their column
    ids: the path and the boundaries [lo, hi) its values read (0, 0 where
    every value's range is empty). STAGED where the whole table fits
    STAGE_WORDS (staged whole, whatever the ids), or the C + 1 offsets do
    and those boundaries do (the offsets staged, then the boundaries), else
    CACHED: the boundaries read through the read-only cache."""
    offsets = torch.as_tensor(offsets, dtype=torch.int64)
    ids, n_cols = torch.as_tensor(column_ids, dtype=torch.int64), offsets.shape[0] - 1
    lo, hi = offsets[ref.offset_index(ids, n_cols)], offsets[ref.offset_index(ids + 1, n_cols)]
    read = hi > lo
    lo, hi = (int(lo[read].min()), int(hi[read].max())) if bool(read.any()) else (0, 0)
    staged = n_cols + 1 + int(offsets[-1]) <= STAGE_WORDS or (n_cols + 1 <= STAGE_WORDS and hi - lo <= STAGE_WORDS)
    return (STAGED if staged else CACHED), lo, hi


def launch_paths(column_ids, offsets, sms: int) -> set[str]:
    """The paths a launch's blocks take for these column ids on a card of
    ``sms`` SMs: STAGED alone where the plan stages the whole table, else
    each tile's ``block_path``."""
    ids, offsets = torch.as_tensor(column_ids), torch.as_tensor(offsets)
    if launch_plan(ids.shape[0], int(offsets[-1]), offsets.shape[0] - 1, sms).whole:
        return {PATHS[STAGED]}
    return {PATHS[block_path(ids[i:i + TILE], offsets)[0]] for i in range(0, ids.shape[0], TILE)}


def trip_count(width: int) -> int:
    """The halvings a warp runs for its widest column: ceil(log2(w + 1)),
    the bit length of w (0 for an empty column)."""
    return max(width, 0).bit_length()


def path_launches() -> tuple[int, int]:
    """Launches that ran the staged and the cached path since the library
    was loaded: the card records them, the C side counts them
    (synchronises the card)."""
    lib = kernels.load_library()
    return lib.repro_bucketize_path_launches(STAGED), lib.repro_bucketize_path_launches(CACHED)


def fused_bucketize(values: torch.Tensor, column_ids: torch.Tensor, boundaries: torch.Tensor,
                    boundary_offsets: torch.Tensor, out: torch.Tensor, stage: bool = True) -> None:
    """Launch on the current stream: out[i] = bucket of values[i] within
    column column_ids[i]. ``stage=False`` reads every tile's offsets and
    boundaries through the read-only cache (for measurements). Arguments
    are checked by ``ops``."""
    lib = kernels.load_library()
    n, b, c = values.shape[0], boundaries.shape[0], boundary_offsets.shape[0] - 1
    blocks, _ = launch_plan(n, b, c, kernels.sm_count(values), stage)
    err = lib.repro_fused_bucketize(
        values.data_ptr(), column_ids.data_ptr(), boundaries.data_ptr(), boundary_offsets.data_ptr(),
        out.data_ptr(), n, b, c, blocks, stage, kernels.current_stream(values))
    kernels.check(lib, err, "fused_transform.fused_bucketize")
