"""Public row scatter-update ops: a CUDA tensor goes through the kernel, a
CPU tensor through the plain version. There is no fallback: a kernel that
fails to build or launch raises.

Both ops update ``table`` in place and return it. Ids must be unique among
the live slots (in range and valid), as the exchange's dedupe guarantees;
the other slots write nothing. The table may be a view (one device's
``x[0]`` of the stacked state) as long as it is contiguous: the wrapper
never copies it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_scatter import fused_scatter, ref

LAUNCHES_ADD = 0  # kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES_SET = 0


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """table[ids] += rows, in place: (R, D) fp32 table, (K,) unique int32 or
    int64 ids, (K, D) fp32 rows, optional (K,) bool ``valid``."""
    global LAUNCHES_ADD
    if _on_cpu(table, ids, rows, valid):
        return ref.scatter_add_rows(table, ids, rows, valid)
    if _launch(table, ids, rows, valid, add=True):
        LAUNCHES_ADD += 1
    return table


def scatter_set_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """table[ids] = rows, in place, with the arguments of ``scatter_add_rows``."""
    global LAUNCHES_SET
    if _on_cpu(table, ids, rows, valid):
        return ref.scatter_set_rows(table, ids, rows, valid)
    if _launch(table, ids, rows, valid, add=False):
        LAUNCHES_SET += 1
    return table


def _on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _launch(table, ids, rows, valid, add: bool) -> bool:
    """Check the arguments and launch; False when there is nothing to do."""
    dev = table.device
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in (ids, rows, valid)):
        raise ValueError(f"scatter_rows: table on {dev}, ids on {ids.device}, rows on "
                         f"{rows.device}, valid on {None if valid is None else valid.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"scatter_rows: table must be contiguous (R, D) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"scatter_rows: ids must be contiguous (K,) int32/int64, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    k, d = ids.shape[0], table.shape[1]
    if rows.dtype != torch.float32 or rows.shape != (k, d) or not rows.is_contiguous():
        raise ValueError(f"scatter_rows: rows must be contiguous ({k}, {d}) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != (k,)
                              or not valid.is_contiguous()):
        raise ValueError(f"scatter_rows: valid must be contiguous ({k},) bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if k == 0 or table.numel() == 0:
        return False
    fused_scatter.scatter_rows(table, ids, rows, valid, add)
    return True
