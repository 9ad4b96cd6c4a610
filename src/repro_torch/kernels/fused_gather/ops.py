"""Public row-gather op: a CUDA tensor goes through the kernel, a CPU tensor
through the plain version. There is no fallback: a kernel that fails to
build or launch raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gather import fused_gather, ref

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Fetch K rows of a (R, D) fp32 table: out[i] = table[ids[i]], with PAD
    (-1) and out-of-range ids reading row 0 (the overflow row)."""
    global LAUNCHES
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return ref.gather_rows(table, ids)
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device}, ids on {ids.device}")
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"gather_rows: table must be contiguous (R, D) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"gather_rows: ids must be contiguous (K,) int32/int64, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if table.shape[0] == 0:
        raise ValueError("gather_rows: empty table")
    fused_gather.gather_rows(table, ids, out)
    LAUNCHES += 1
    return out
