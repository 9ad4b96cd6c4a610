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
    within the column, right-open bins."""
    global LAUNCHES
    tensors = (values, column_ids, boundaries, boundary_offsets)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.fused_bucketize(values, column_ids, boundaries, boundary_offsets)
    dev = values.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_bucketize: inputs on {[str(t.device) for t in tensors]}")
    n = values.shape[0]
    if values.dim() != 1 or column_ids.shape != (n,) or column_ids.dtype != torch.int32:
        raise ValueError(f"fused_bucketize: values (N,) and column_ids (N,) int32, got "
                         f"{tuple(values.shape)}, {tuple(column_ids.shape)} {column_ids.dtype}")
    if boundary_offsets.dim() != 1 or boundary_offsets.shape[0] < 2 \
            or boundary_offsets.dtype != torch.int32 or boundaries.dim() != 1:
        raise ValueError(f"fused_bucketize: boundary_offsets (C+1,) int32 with C >= 1 and "
                         f"boundaries (B,), got {tuple(boundary_offsets.shape)} "
                         f"{boundary_offsets.dtype}, {tuple(boundaries.shape)}")
    v = values.to(torch.float32).contiguous()
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    fused_transform.fused_bucketize(v, column_ids.contiguous(), boundaries.to(torch.float32).contiguous(),
                                    boundary_offsets.contiguous(), out)
    LAUNCHES += 1
    return out
