"""Public fused-bucketize op: a CUDA tensor goes through the kernel, a CPU
tensor through the plain version. There is no fallback: a kernel that
fails to build or launch raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_transform import fused_transform, ref

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)


def fused_bucketize(values: torch.Tensor, column_ids: torch.Tensor, boundaries: torch.Tensor,
                    boundary_offsets: torch.Tensor) -> torch.Tensor:
    """One kernel for every bucketize column: (N,) values (cast to fp32, as
    the reference's wrapper does), (N,) column ids, the concatenated sorted
    boundary lists (B,) and their offsets (C+1,) → (N,) int64 bucket index
    within the column, right-open bins. A column id outside [0, C) reads
    the offsets as jnp does (``ref.offset_index``)."""
    global LAUNCHES
    # each tensor attribute is read once, and the cheapest way: at the MSE
    # step's batch of 128 this wrapper's host time is the op's whole cost
    if values.is_cpu and column_ids.is_cpu and boundaries.is_cpu and boundary_offsets.is_cpu:
        return ref.fused_bucketize(values, column_ids, boundaries, boundary_offsets)
    d = values.get_device()  # the card's index; -1 off the card
    if not values.is_cuda or column_ids.get_device() != d or boundaries.get_device() != d \
            or boundary_offsets.get_device() != d:
        raise ValueError(f"fused_bucketize: inputs on {values.device}, {column_ids.device}, {boundaries.device}, "
                         f"{boundary_offsets.device}")
    n = values.shape[0]
    if values.dim() != 1 or column_ids.dtype != torch.int32 or column_ids.shape != (n,):
        raise ValueError(f"fused_bucketize: values (N,) and column_ids (N,) int32, got "
                         f"{tuple(values.shape)}, {tuple(column_ids.shape)} {column_ids.dtype}")
    if boundary_offsets.dtype != torch.int32 or boundary_offsets.dim() != 1 or boundary_offsets.shape[0] < 2 \
            or boundaries.dim() != 1:
        raise ValueError(f"fused_bucketize: boundary_offsets (C+1,) int32 with C >= 1 and "
                         f"boundaries (B,), got {tuple(boundary_offsets.shape)} "
                         f"{boundary_offsets.dtype}, {tuple(boundaries.shape)}")
    out = torch.empty((n,), dtype=torch.int64, device=values.device)
    if n == 0:
        return out
    if values.dtype is not torch.float32:
        values = values.to(torch.float32)
    if boundaries.dtype is not torch.float32:
        boundaries = boundaries.to(torch.float32)
    fused_transform.fused_bucketize(
        values if values.is_contiguous() else values.contiguous(),
        column_ids if column_ids.is_contiguous() else column_ids.contiguous(),
        boundaries if boundaries.is_contiguous() else boundaries.contiguous(),
        boundary_offsets if boundary_offsets.is_contiguous() else boundary_offsets.contiguous(), out)
    LAUNCHES += 1
    return out
