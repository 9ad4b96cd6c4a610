"""Public segment-reduce ops: a CUDA tensor goes through the kernels, a CPU
tensor through the plain version. There is no fallback: a kernel that fails
to build or launch raises.

``segment_sum`` and ``segment_sum_csr`` are differentiable in ``values``.
Their gradient is the reference's VJP (``repro/kernels/segment_reduce/
ops.py::_bwd``), a row broadcast ``dv[j] = g[seg(j)]`` that is zero where
``seg(j)`` is out of range: on the card the CSR form runs the
``segment_expand_csr`` kernel, the id form the row-gather kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_gather import ops as fg_ops
from repro_torch.kernels.segment_reduce import ref, segment_reduce

LAUNCHES = 0      # forward kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES_BWD = 0  # segment_expand_csr launches since the last reset


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                sorted_ids: bool = False) -> torch.Tensor:
    """Segment sum by id: (N, D) fp32 → (num_segments, D).

    Ids outside [0, num_segments) contribute nothing. ``sorted_ids=True``
    promises ascending ids; otherwise the values are first permuted by a
    stable sort of the ids, which keeps each segment's summation order.
    """
    return _SegmentSum.apply(values, segment_ids, num_segments, sorted_ids)


def segment_sum_csr(values: torch.Tensor, row_splits: torch.Tensor) -> torch.Tensor:
    """Pooled embedding reduce of a CSR column: out[s] =
    values[row_splits[s]:row_splits[s+1]].sum(0), (N, D) fp32 →
    (n_rows, D). ``row_splits`` (n_rows + 1,) int32 or int64, ascending, as
    ``Ragged.row_splits`` holds them; rows past ``row_splits[-1]`` (the
    padding tail) contribute nothing. The splits are the kernel's bounds as
    they are: no segment ids are built.
    """
    return _SegmentSumCSR.apply(values, row_splits)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, segment_ids, num_segments, sorted_ids):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        return _segment_sum(values, segment_ids, num_segments, sorted_ids)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        if ctx.num_segments == 0:
            return g.new_zeros((seg.shape[0], g.shape[1])), None, None, None
        if g.device.type == "cpu":
            return ref.segment_sum_bwd(g, seg, ctx.num_segments), None, None, None
        ok = (seg >= 0) & (seg < ctx.num_segments)
        return fg_ops.gather_rows(g.contiguous(), seg).mul_(ok[:, None]), None, None, None


class _SegmentSumCSR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, row_splits):
        ctx.save_for_backward(row_splits)
        ctx.n = values.shape[0]
        return _segment_sum_csr(values, row_splits)

    @staticmethod
    def backward(ctx, g):
        (row_splits,) = ctx.saved_tensors
        return segment_expand_csr(g, row_splits, ctx.n), None


def segment_expand_csr(g: torch.Tensor, row_splits: torch.Tensor, n: int) -> torch.Tensor:
    """Gradient of ``segment_sum_csr``: (n_rows, D) fp32 → (n, D), row j =
    g[s] for j in [row_splits[s], row_splits[s+1]), zero outside
    [row_splits[0], row_splits[-1]). ``g``'s rows must be dense; its row
    stride may be larger than D (a column of a stacked gradient)."""
    global LAUNCHES_BWD
    if g.device.type == "cpu" and row_splits.device.type == "cpu":
        return ref.segment_expand_csr(g, row_splits, n)
    dev = g.device
    if dev.type != "cuda" or row_splits.device != dev:
        raise ValueError(f"segment_expand_csr: g on {dev}, row_splits on {row_splits.device}")
    s = row_splits.shape[0] - 1
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != s or g.stride(1) != 1:
        raise ValueError(f"segment_expand_csr: g must be ({s}, D) float32 with dense rows, got "
                         f"{tuple(g.shape)} {g.dtype} strides {g.stride()}")
    _check_splits(row_splits, "segment_expand_csr")
    out = torch.empty((n, g.shape[1]), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    g_stride = g.stride(0) if s > 0 else g.shape[1]
    segment_reduce.segment_expand_csr(g, g_stride, row_splits, out)
    LAUNCHES_BWD += 1
    return out


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 sorted_ids: bool) -> torch.Tensor:
    if values.device.type == "cpu" and segment_ids.device.type == "cpu":
        return ref.segment_sum(values, segment_ids, num_segments)
    _check_values(values, segment_ids, "segment_ids")
    if segment_ids.dtype != torch.int32 or segment_ids.shape != values.shape[:1]:
        raise ValueError(f"segment_sum: segment_ids must be contiguous (N,) int32, got "
                         f"{tuple(segment_ids.shape)} {segment_ids.dtype}")
    if num_segments < 0:
        raise ValueError(f"segment_sum: num_segments={num_segments}")
    if not sorted_ids:
        segment_ids, perm = torch.sort(segment_ids, stable=True)
        values = values[perm]
    bounds = torch.searchsorted(
        segment_ids, torch.arange(num_segments + 1, dtype=torch.int32, device=values.device))
    return _launch(values, bounds)


def _segment_sum_csr(values: torch.Tensor, row_splits: torch.Tensor) -> torch.Tensor:
    if values.device.type == "cpu" and row_splits.device.type == "cpu":
        return ref.segment_sum_csr(values, row_splits)
    _check_values(values, row_splits, "row_splits")
    _check_splits(row_splits, "segment_sum_csr")
    return _launch(values, row_splits)


def _check_splits(row_splits: torch.Tensor, what: str) -> None:
    if row_splits.dtype not in (torch.int32, torch.int64) or row_splits.dim() != 1 \
            or row_splits.shape[0] < 1 or not row_splits.is_contiguous():
        raise ValueError(f"{what}: row_splits must be contiguous (n_rows + 1,) int32 "
                         f"or int64, got {tuple(row_splits.shape)} {row_splits.dtype}")


def _check_values(values: torch.Tensor, index: torch.Tensor, what: str) -> None:
    dev = values.device
    if dev.type != "cuda" or index.device != dev:
        raise ValueError(f"segment_sum: values on {dev}, {what} on {index.device}")
    if values.dtype != torch.float32 or values.dim() != 2 or not values.is_contiguous():
        raise ValueError(f"segment_sum: values must be contiguous (N, D) float32, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if not index.is_contiguous():
        raise ValueError(f"segment_sum: {what} must be contiguous")


def _launch(values: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """out[s] = values[bounds[s]:bounds[s+1]].sum(0) on the card."""
    global LAUNCHES
    out = torch.empty((bounds.shape[0] - 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    if out.numel() == 0:
        return out
    segment_reduce.segment_sum_sorted(values, bounds, out)
    LAUNCHES += 1
    return out


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 sorted_ids: bool = False) -> torch.Tensor:
    """Segment mean: sums over counts clamped to at least 1."""
    s = segment_sum(values, segment_ids, num_segments, sorted_ids)
    ones = values.new_ones((values.shape[0], 1))
    cnt = segment_sum(ones, segment_ids, num_segments, sorted_ids)
    return s / cnt.clamp(min=1.0)
