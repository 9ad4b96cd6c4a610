"""Ragged — the CSR layout RecIS uses for sparse features (port of
``repro/io/ragged.py``).

``values`` is a fixed-size buffer of ``nnz_budget`` entries whose live prefix
length is ``row_splits[-1]``; the padding tail holds ``PAD_ID`` (ids) or 0.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

PAD_ID = -1


@dataclasses.dataclass
class Ragged:
    """A ragged column in CSR form with a static value budget.

    values:     (nnz_budget,) int64 ids or float32 numerics; tail padded.
    row_splits: (n_rows + 1,) int32 CSR offsets; row_splits[-1] == live nnz.
    """

    values: torch.Tensor
    row_splits: torch.Tensor

    @property
    def n_rows(self) -> int:
        return self.row_splits.shape[0] - 1

    @property
    def nnz_budget(self) -> int:
        return self.values.shape[0]

    def row_lengths(self) -> torch.Tensor:
        return self.row_splits[1:] - self.row_splits[:-1]

    def _positions(self) -> torch.Tensor:
        return torch.arange(self.nnz_budget, dtype=self.row_splits.dtype,
                            device=self.row_splits.device)

    def segment_ids(self) -> torch.Tensor:
        """Per-value row index, sorted; the padding tail gets ``n_rows`` (an
        out-of-range segment), so segment reductions over ``n_rows`` drop it."""
        pos = self._positions()
        seg = torch.searchsorted(self.row_splits, pos, right=True).to(pos.dtype) - 1
        live = pos < self.row_splits[-1]
        return torch.where(live, seg, self.n_rows)

    def valid_mask(self) -> torch.Tensor:
        return self._positions() < self.row_splits[-1]

    @classmethod
    def from_lists(cls, rows: Sequence[Sequence], nnz_budget: int | None = None,
                   dtype: torch.dtype = torch.int64) -> "Ragged":
        """Host-side constructor (numpy), the reference's: rows that overflow
        the budget are cut from the batch tail, whole rows first, then a
        partial last row. The padding follows the dtype of the rows' values,
        not ``dtype``: -1 after integer values, 0 after float ones (and after
        no values at all)."""
        lens = np.array([len(r) for r in rows], dtype=np.int32)
        flat = (np.concatenate([np.asarray(r) for r in rows]) if len(rows) and lens.sum()
                else np.zeros((0,)))
        total = int(lens.sum())
        budget = nnz_budget if nnz_budget is not None else max(total, 1)
        if total > budget:  # drop whole tail rows first, then keep a partial row
            keep = np.cumsum(lens) <= budget
            lens = np.where(keep, lens, 0)
            spill = budget - int(lens.sum())
            if spill > 0 and not keep.all():
                lens[int(np.argmin(keep))] = spill
            flat = flat[:budget]
        splits = np.zeros(len(rows) + 1, dtype=np.int32)
        np.cumsum(lens, out=splits[1:])
        vals = np.full((budget,), -1 if np.issubdtype(flat.dtype, np.integer) else 0.0)
        vals = vals.astype(torch.empty(0, dtype=dtype).numpy().dtype)
        vals[: splits[-1]] = flat[: splits[-1]]
        return cls(torch.from_numpy(vals), torch.from_numpy(splits))

    @classmethod
    def dense(cls, x: torch.Tensor) -> "Ragged":
        """Wrap a dense (rows, k) tensor as a fixed-length ragged column."""
        rows, k = x.shape
        splits = torch.arange(rows + 1, dtype=torch.int32, device=x.device) * k
        return cls(x.reshape(-1), splits)

    def truncate(self, max_len: int) -> "Ragged":
        """Per-row head truncation to ``max_len``: the first ``max_len`` values
        of each row, recompacted into the same budget; the tail holds PAD_ID
        (integer values) or 0."""
        lens = torch.clamp(self.row_lengths(), max=max_len)
        new_splits = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)]).to(self.row_splits.dtype)
        # position p of the new layout reads old row_splits[row] + offset
        pos = torch.arange(self.nnz_budget, dtype=new_splits.dtype, device=new_splits.device)
        row = torch.searchsorted(new_splits, pos, right=True) - 1
        row = row.clamp(0, self.n_rows - 1).long()
        src = self.row_splits[row] + (pos - new_splits[row])
        live = pos < new_splits[-1]
        pad = PAD_ID if not self.values.dtype.is_floating_point else 0
        vals = torch.where(live, self.values[src.clamp(0, self.nnz_budget - 1).long()],
                           torch.tensor(pad, dtype=self.values.dtype, device=self.values.device))
        return Ragged(vals, new_splits)

    def to_padded(self, max_len: int, pad_value=0) -> tuple[torch.Tensor, torch.Tensor]:
        """Densify to (n_rows, max_len) plus its validity mask."""
        cols = torch.arange(max_len, device=self.row_splits.device)
        idx = self.row_splits[:-1, None] + cols[None, :]
        mask = cols[None, :] < self.row_lengths()[:, None]
        idx = idx.clamp(0, self.nnz_budget - 1)
        pad = torch.tensor(pad_value, dtype=self.values.dtype, device=self.values.device)
        return torch.where(mask, self.values[idx], pad), mask


def concat_ragged(columns: Iterable[Ragged]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Several columns' value buffers as one, for a fused op: (flat values,
    per-value column ids int32, valid mask)."""
    cols = list(columns)
    vals = torch.cat([c.values for c in cols])
    cids = torch.cat([torch.full((c.nnz_budget,), i, dtype=torch.int32, device=c.values.device)
                      for i, c in enumerate(cols)])
    mask = torch.cat([c.valid_mask() for c in cols])
    return vals, cids, mask
