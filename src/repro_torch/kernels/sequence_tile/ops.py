"""Public sequence-tile op: a CUDA tensor goes through the kernels, a CPU
tensor through the plain version. There is no fallback: a kernel that
fails to build or launch raises.

``sequence_tile`` is differentiable in ``values``. The reference takes its
gradient by autodiff of ``rows[idx] * mask`` (``repro/core/
embedding_engine.py::_pool``); here it is ``sequence_untile``, a kernel of
its own, so no plain version runs on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sequence_tile import ref, sequence_tile as st_kernel

LAUNCHES = 0      # forward kernel launches since the last reset (read by chip_smoke.py)
BWD_LAUNCHES = 0  # sequence_untile launches since the last reset


def sequence_tile(values: torch.Tensor, row_splits: torch.Tensor, k: int) -> torch.Tensor:
    """Concat pooling (the paper's "sequence tile"): (N, D) value rows of a
    CSR column with (n_rows + 1,) int32 or int64 ``row_splits`` → (n_rows,
    k·D), row i the first k value rows of CSR row i, zero past its length."""
    return _SequenceTile.apply(values, row_splits, k)


class _SequenceTile(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, row_splits, k):
        ctx.save_for_backward(row_splits)
        ctx.nnz, ctx.k = values.shape[0], k
        return _tile(values, row_splits, k)

    @staticmethod
    def backward(ctx, g):
        (row_splits,) = ctx.saved_tensors
        g3 = g.reshape(g.shape[0], ctx.k, g.shape[1] // ctx.k)
        return sequence_untile(g3, row_splits, ctx.nnz), None, None


def _tile(values: torch.Tensor, row_splits: torch.Tensor, k: int) -> torch.Tensor:
    global LAUNCHES
    if k < 1:
        raise ValueError(f"sequence_tile: k must be >= 1, got {k}")
    if values.device.type == "cpu" and row_splits.device.type == "cpu":
        return ref.sequence_tile(values, row_splits, k)
    _check(values, row_splits, "values", "sequence_tile")
    n_rows, (nnz, d) = row_splits.shape[0] - 1, values.shape
    out = torch.empty((n_rows, k, d), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out.view(n_rows, k * d)
    if nnz == 0:
        return out.zero_().view(n_rows, k * d)
    st_kernel.sequence_tile(values.contiguous(), row_splits, out)
    LAUNCHES += 1
    return out.view(n_rows, k * d)


def sequence_untile(g: torch.Tensor, row_splits: torch.Tensor, nnz: int) -> torch.Tensor:
    """Gradient of ``sequence_tile`` in its values: g (n_rows, k, D) →
    (nnz, D); value position p of row r gets g[r, p - splits[r]] when that
    offset is below k and the row's length, every other position zero."""
    global BWD_LAUNCHES
    if g.dim() != 3 or g.shape[0] != row_splits.shape[0] - 1:
        raise ValueError(f"sequence_untile: g must be (n_rows, k, D), got {tuple(g.shape)} "
                         f"for {row_splits.shape[0] - 1} rows")
    if g.device.type == "cpu" and row_splits.device.type == "cpu":
        return ref.sequence_untile(g, row_splits, nnz)
    _check(g, row_splits, "g", "sequence_untile")
    out = torch.empty((nnz, g.shape[2]), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    st_kernel.sequence_untile(g.contiguous(), row_splits, out)
    BWD_LAUNCHES += 1
    return out


def _check(x: torch.Tensor, row_splits: torch.Tensor, name: str, what: str) -> None:
    dev = x.device
    if dev.type != "cuda" or row_splits.device != dev:
        raise ValueError(f"{what}: {name} on {dev}, row_splits on {row_splits.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: {name} must be float32, got {x.dtype}")
    if row_splits.dtype not in (torch.int32, torch.int64) or row_splits.dim() != 1 \
            or row_splits.shape[0] < 1 or not row_splits.is_contiguous():
        raise ValueError(f"{what}: row_splits must be contiguous (n_rows + 1,) int32 or int64, "
                         f"got {tuple(row_splits.shape)} {row_splits.dtype}")
