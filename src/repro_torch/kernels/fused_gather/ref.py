"""Plain PyTorch version of the row gather (the CPU path and the oracle)."""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(R, D) × (K,) ids → (K, D); PAD (-1) and out-of-range ids read row 0."""
    idx = torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)
    return table[idx]
