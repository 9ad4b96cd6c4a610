"""Plain PyTorch version of segment reduce (the CPU path and the oracle)."""
from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """values (N, D) × segment_ids (N,) → (num_segments, D); ids outside
    [0, num_segments) are dropped (sent to a spare row that is cut off)."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    idx = torch.where(ok, segment_ids, num_segments).long()
    out = values.new_zeros((num_segments + 1,) + values.shape[1:])
    return out.index_add_(0, idx, values)[:num_segments]


def segment_sum_csr(values: torch.Tensor, row_splits: torch.Tensor) -> torch.Tensor:
    """values (N, D) × row_splits (n_rows + 1,) → (n_rows, D); row s sums
    values[row_splits[s]:row_splits[s+1]], rows past row_splits[-1] are dropped."""
    n_rows = row_splits.shape[0] - 1
    pos = torch.arange(values.shape[0], dtype=row_splits.dtype, device=row_splits.device)
    seg = torch.searchsorted(row_splits, pos, right=True) - 1
    seg = torch.where(pos < row_splits[-1], seg, n_rows)
    return segment_sum(values, seg, n_rows)


def segment_sum_bwd(g: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """VJP of ``segment_sum`` in ``values``: row j = g[segment_ids[j]], zero
    where the id is outside [0, num_segments)."""
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    return g[segment_ids.clamp(0, num_segments - 1).long()] * ok[:, None].to(g.dtype)


def segment_expand_csr(g: torch.Tensor, row_splits: torch.Tensor, n: int) -> torch.Tensor:
    """VJP of ``segment_sum_csr`` for n value rows: row j = g[s] for j in
    [row_splits[s], row_splits[s+1]), zero outside [row_splits[0], row_splits[-1])."""
    n_rows = row_splits.shape[0] - 1
    pos = torch.arange(n, dtype=row_splits.dtype, device=row_splits.device)
    seg = torch.searchsorted(row_splits, pos, right=True) - 1
    seg = torch.where((pos >= row_splits[0]) & (pos < row_splits[-1]), seg, n_rows)
    if n_rows == 0:
        return g.new_zeros((n, g.shape[1]))
    return segment_sum_bwd(g, seg, n_rows)


def segment_sum_csr_group(values: torch.Tensor, row_splits, offsets, sizes) -> tuple[torch.Tensor, ...]:
    """Per feature f, ``segment_sum_csr`` of its slice values[offsets[f] :
    offsets[f] + sizes[f]] by row_splits[f]."""
    return tuple(segment_sum_csr(values[o:o + n], sp) for sp, o, n in zip(row_splits, offsets, sizes))


def segment_expand_csr_group(grads, row_splits, offsets, sizes, n: int, d: int) -> torch.Tensor:
    """VJP of ``segment_sum_csr_group`` for n value rows of width d: each
    feature's slice holds ``segment_expand_csr`` of its gradient, every
    other row is zero (as is a feature's slice whose gradient is None)."""
    out = torch.zeros((n, d), dtype=torch.float32, device=row_splits[0].device if row_splits else "cpu")
    for g, sp, o, size in zip(grads, row_splits, offsets, sizes):
        if g is not None:
            out[o:o + size] = segment_expand_csr(g, sp, size)
    return out


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(values, segment_ids, num_segments)
    cnt = segment_sum(values.new_ones((values.shape[0], 1)), segment_ids, num_segments)
    return s / cnt.clamp(min=1.0)
