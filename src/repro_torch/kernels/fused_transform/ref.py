"""Plain PyTorch version of the fused bucketize (the CPU path and the
oracle), as ``repro/kernels/fused_transform/ref.py`` writes it."""
from __future__ import annotations

import torch


def fused_bucketize(values: torch.Tensor, column_ids: torch.Tensor, boundaries: torch.Tensor,
                    boundary_offsets: torch.Tensor) -> torch.Tensor:
    """Per value, the number of its own column's boundaries that are <= the
    value (right-open bins): ``searchsorted(column's boundaries, v,
    side="right")``. Values are compared in fp32 with subnormal values and
    boundaries read as zero, as XLA and the TPU compare them; column ids
    outside [0, C) are clamped into it, as the kernel does. Returns (N,)
    int64."""
    v = flush_subnormal(values.to(torch.float32))
    b = flush_subnormal(boundaries.to(torch.float32))
    n_cols = boundary_offsets.shape[0] - 1
    c = column_ids.long().clamp(0, n_cols - 1)
    lo, hi = boundary_offsets[c].long(), boundary_offsets[c + 1].long()
    pos = torch.arange(boundaries.shape[0], device=boundaries.device)
    in_col = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    return (in_col & (b[None, :] <= v[:, None])).sum(1).to(torch.int64)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """fp32 subnormals → 0 (NaN and the infinities pass)."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, torch.zeros((), dtype=x.dtype), x)
