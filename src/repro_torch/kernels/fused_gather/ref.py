"""Plain PyTorch versions of the gathers (the CPU path and the oracle)."""
from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _clamp(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(R, D) × (K,) ids → (K, D); PAD (-1) and out-of-range ids read row 0."""
    return table[_clamp(table, ids)]


def gather_rows_slab(table: torch.Tensor, ids: torch.Tensor, rows_blk: int = 128,
                     slab: int = 512) -> torch.Tensor:
    """The reference's slab gather (``repro/kernels/fused_gather/ops.py``
    mode="slab"): ids outside [0, R) read as id 0; the ids, padded with id 0
    to a multiple of ``rows_blk``, form runs; a run's window is the
    slab-aligned block at base = clip(min(run), 0, max(round_up(R, slab) -
    slab, 0)) // slab * slab, with slab = min(slab, round_up(R, 8)); a row
    inside its run's window reads table[id], any other row zeros."""
    r, k = table.shape[0], ids.shape[0]
    idx = _clamp(table, ids).to(torch.int64)
    slab = min(slab, _round_up(r, 8))
    kp = _round_up(max(k, rows_blk), rows_blk)
    runs = torch.nn.functional.pad(idx, (0, kp - k)).view(-1, rows_blk)
    max_base = max(_round_up(r, slab) - slab, 0)
    base = runs.amin(dim=1).clamp(0, max_base) // slab * slab
    local = (runs - base[:, None]).reshape(-1)[:k]
    inside = (local >= 0) & (local < slab)
    return torch.where(inside[:, None], table[idx], torch.zeros((), dtype=table.dtype))
