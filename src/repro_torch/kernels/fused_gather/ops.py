"""Public gather op: a CUDA tensor goes through a kernel, a CPU tensor
through the plain version. There is no fallback: a kernel that fails to
build or launch raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gather import fused_gather, ref

LAUNCHES = 0       # row-kernel launches since the last reset (read by chip_smoke.py)
SLAB_LAUNCHES = 0  # slab-kernel launches since the last reset


def gather_rows(table: torch.Tensor, ids: torch.Tensor, mode: str = "row",
                rows_blk: int = 128, slab: int = 512) -> torch.Tensor:
    """Fetch K rows of a (R, D) fp32 table, the reference's
    ``repro.kernels.fused_gather.ops.gather_rows``.

    ``row``  — out[i] = table[ids[i]], PAD (-1) and out-of-range ids reading
               row 0 (the overflow row); any id order.
    ``slab`` — the windowed gather of sorted ids (``ref.gather_rows_slab``):
               each run of ``rows_blk`` ids reads from one slab-aligned
               window of ``slab`` rows, and rows outside it read zeros.
    """
    global LAUNCHES, SLAB_LAUNCHES
    if mode not in ("row", "slab"):
        raise ValueError(f"gather_rows: mode must be 'row' or 'slab', got {mode!r}")
    if mode == "slab" and (rows_blk < 1 or slab < 1):
        raise ValueError(f"gather_rows: rows_blk {rows_blk} and slab {slab} must be positive")
    # each tensor attribute is read once, and the cheapest way: on the serve
    # path this wrapper's host time, not its kernel, is the gather's time
    if table.is_cpu and ids.is_cpu:
        if mode == "slab":
            return ref.gather_rows_slab(table, ids, rows_blk, slab)
        return ref.gather_rows(table, ids)
    dev = table.device
    if not table.is_cuda or ids.device != dev:
        raise ValueError(f"gather_rows: table on {dev}, ids on {ids.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"gather_rows: table must be contiguous (R, D) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"gather_rows: ids must be contiguous (K,) int32/int64, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    (r, d), k = table.shape, ids.shape[0]
    out = torch.empty((k, d), dtype=torch.float32, device=dev)
    if k == 0 or d == 0:
        return out
    if r == 0:
        raise ValueError("gather_rows: empty table")
    if mode == "slab":
        fused_gather.gather_rows_slab(table, ids, out, rows_blk, min(slab, ref._round_up(r, 8)))
        SLAB_LAUNCHES += 1
    else:
        fused_gather.gather_rows(table, ids, out)
        LAUNCHES += 1
    return out
