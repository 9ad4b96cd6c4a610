"""Plain PyTorch version of the sequence tile and its gradient (the CPU
path and the oracle)."""
from __future__ import annotations

import torch


def sequence_tile(values: torch.Tensor, row_splits: torch.Tensor, k: int) -> torch.Tensor:
    """Concat pooling, as ``repro/kernels/sequence_tile/ref.py`` writes it:
    (N, D) values, (S+1,) splits → (S, k·D), row i = values[splits[i] :
    splits[i] + k] left-justified, the source index clamped to [0, N-1],
    zero past the row's length (+0.0, as the kernels write it)."""
    n_rows, nnz, d = row_splits.shape[0] - 1, values.shape[0], values.shape[1]
    if nnz == 0:
        return values.new_zeros((n_rows, k * d))
    j = torch.arange(k, dtype=row_splits.dtype, device=row_splits.device)
    idx = row_splits[:-1, None] + j[None, :]
    mask = idx < row_splits[1:, None]
    tiles = values[idx.clamp(0, nnz - 1).long()]
    return torch.where(mask[..., None], tiles, values.new_zeros(())).reshape(n_rows, k * d)


def sequence_untile(g: torch.Tensor, row_splits: torch.Tensor, nnz: int) -> torch.Tensor:
    """The gradient of ``sequence_tile`` in ``values``: g (S, k, D) → (nnz,
    D); position p of row r (splits[r] <= p < splits[r+1]) gets g[r, p -
    splits[r]] when that offset is below k, every other position (the rest
    of a row longer than k, the padding tail) zero. The transpose of the
    forward when splits[-1] <= nnz, as a Ragged column's are."""
    n_rows, k, d = g.shape
    pos = torch.arange(nnz, dtype=row_splits.dtype, device=row_splits.device)
    row = (torch.searchsorted(row_splits, pos, right=True) - 1).clamp(0, max(n_rows - 1, 0))
    off = pos - row_splits[row]
    ok = (pos >= row_splits[0]) & (pos < row_splits[-1]) & (off < k)
    if n_rows == 0:
        return g.new_zeros((nnz, d))
    rows = g[row.long(), off.clamp(0, k - 1).long()]
    return torch.where(ok[:, None], rows, g.new_zeros(()))
