"""Plain PyTorch version of the row scatter-update (the CPU path and the
oracle). Updates ``table`` in place, as the kernel does."""
from __future__ import annotations

import torch


def _live(table: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    ok = (ids >= 0) & (ids < table.shape[0])
    return ok if valid is None else ok & valid


def scatter_add_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """table[ids] += rows where valid and in range; other slots are dropped."""
    ok = _live(table, ids, valid)
    return table.index_add_(0, ids[ok].long(), rows[ok].to(table.dtype))


def scatter_set_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """table[ids] = rows where valid and in range; other slots are dropped."""
    ok = _live(table, ids, valid)
    table[ids[ok].long()] = rows[ok].to(table.dtype)
    return table
