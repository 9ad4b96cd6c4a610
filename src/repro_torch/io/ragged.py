"""Ragged — the CSR layout RecIS uses for sparse features (port of
``repro/io/ragged.py``).

``values`` is a fixed-size buffer of ``nnz_budget`` entries whose live prefix
length is ``row_splits[-1]``; the padding tail holds ``PAD_ID`` (ids) or 0.
"""
from __future__ import annotations

import dataclasses

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
    def dense(cls, x: torch.Tensor) -> "Ragged":
        """Wrap a dense (rows, k) tensor as a fixed-length ragged column."""
        rows, k = x.shape
        splits = torch.arange(rows + 1, dtype=torch.int32, device=x.device) * k
        return cls(x.reshape(-1), splits)

    def to_padded(self, max_len: int, pad_value=0) -> tuple[torch.Tensor, torch.Tensor]:
        """Densify to (n_rows, max_len) plus its validity mask."""
        cols = torch.arange(max_len, device=self.row_splits.device)
        idx = self.row_splits[:-1, None] + cols[None, :]
        mask = cols[None, :] < self.row_lengths()[:, None]
        idx = idx.clamp(0, self.nnz_budget - 1)
        pad = torch.tensor(pad_value, dtype=self.values.dtype, device=self.values.device)
        return torch.where(mask, self.values[idx], pad), mask
