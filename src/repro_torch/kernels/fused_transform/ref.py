"""Plain PyTorch version of the fused bucketize (the CPU path and the
oracle), as ``repro/kernels/fused_transform/ref.py`` writes it."""
from __future__ import annotations

import torch


def fused_bucketize(values: torch.Tensor, column_ids: torch.Tensor, boundaries: torch.Tensor,
                    boundary_offsets: torch.Tensor) -> torch.Tensor:
    """Per value, the number of its own column's boundaries that are <= the
    value (right-open bins): ``searchsorted(column's boundaries, v,
    side="right")``. Values are compared in fp32 with subnormal values and
    boundaries read as zero, as XLA and the TPU compare them. The column's
    boundaries are ``boundaries[lo:hi]`` with ``lo = offsets[norm(c)]`` and
    ``hi = offsets[norm(c + 1)]``, the offsets indexed as the reference's
    ``jnp`` indexing reads them (``offset_index``), so a column id outside
    [0, C) gives the reference's answer: an id of -2 or C - 1 reads column
    C - 1, one of -1 or >= C an empty range (0). Returns (N,) int64."""
    v = flush_subnormal(values.to(torch.float32))
    b = flush_subnormal(boundaries.to(torch.float32))
    n_cols = boundary_offsets.shape[0] - 1
    # in int64 c + 1 does not wrap at 2^31 - 1 as jnp's int32 does; both
    # read an empty range there (hi <= lo = offsets[C])
    c = column_ids.to(torch.int32).long()
    lo = boundary_offsets[offset_index(c, n_cols)].long()
    hi = boundary_offsets[offset_index(c + 1, n_cols)].long()
    pos = torch.arange(boundaries.shape[0], device=boundaries.device)
    in_col = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    return (in_col & (b[None, :] <= v[:, None])).sum(1).to(torch.int64)


def offset_index(i: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The entry of the (C+1,) offsets that ``offsets[i]`` reads in jnp: a
    negative index counts from the end once, then the index is clamped into
    [0, C]."""
    return torch.where(i < 0, i + (n_cols + 1), i).clamp(0, n_cols)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """fp32 subnormals → 0 (NaN and the infinities pass)."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, torch.zeros((), dtype=x.dtype), x)
