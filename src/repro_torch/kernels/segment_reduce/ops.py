"""Public segment-reduce ops: a CUDA tensor goes through the kernels, a CPU
tensor through the plain version. There is no fallback: a kernel that fails
to build or launch raises.

``segment_sum`` and ``segment_sum_csr`` are differentiable in ``values``.
Their gradient is the reference's VJP (``repro/kernels/segment_reduce/
ops.py::_bwd``), a row broadcast ``dv[j] = g[seg(j)]`` that is zero where
``seg(j)`` is out of range: on the card the CSR form runs the
``segment_expand_csr`` kernel, the id form the row-gather kernel.

``segment_sum_csr_group`` pools every sum-pooled feature of one embedding
dim group from the group's rows in one launch, and its gradient is the
gradient of the whole of ``values``, written in one launch: autograd sees
one use of ``values`` per group, not one slice per feature.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.fused_gather import ops as fg_ops
from repro_torch.kernels.segment_reduce import ref, segment_reduce

LAUNCHES = 0      # forward kernel launches since the last reset (read by chip_smoke.py)
LAUNCHES_BWD = 0  # segment_expand_csr launches since the last reset
GROUP_LAUNCHES = 0      # grouped forward launches: one per dim group (per chunk of 64 features)
GROUP_LAUNCHES_BWD = 0  # grouped backward launches, likewise


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


def segment_sum_csr_group(values: torch.Tensor, row_splits: Sequence[torch.Tensor],
                          offsets: Sequence[int], sizes: Sequence[int]) -> tuple[torch.Tensor, ...]:
    """``segment_sum_csr`` of several features' slices of one (N, D) fp32
    ``values`` at once: output f is the sum pooling of values[offsets[f] :
    offsets[f] + sizes[f]] by row_splits[f], (n_rows_f, D), bit-equal to
    ``segment_sum_csr`` of that slice. The slices lie in order and do not
    overlap (other rows, such as other poolings' features, may lie between
    them). The outputs are row blocks of one buffer. Differentiable in
    ``values`` as a whole: one launch writes the gradient of every row.
    """
    n = values.shape[0]
    offsets = tuple(int(o) for o in offsets)
    sizes = tuple(int(x) for x in sizes)
    ends = [o + x for o, x in zip(offsets, sizes)]
    if not (len(row_splits) == len(offsets) == len(sizes)) or any(x < 0 for x in sizes) \
            or any(o < e for o, e in zip(offsets, [0] + ends[:-1])) or (ends and ends[-1] > n):
        raise ValueError(f"segment_sum_csr_group: slices {list(zip(offsets, sizes))} of {n} rows must "
                         f"be in order, inside the values and not overlap, one per row_splits")
    if not row_splits:
        return ()
    return _SegmentSumCSRGroup.apply(values, offsets, sizes, *row_splits)


def segment_expand_csr_group(grads: Sequence[torch.Tensor | None], row_splits: Sequence[torch.Tensor],
                             offsets: Sequence[int], sizes: Sequence[int], n: int, d: int) -> torch.Tensor:
    """Gradient of ``segment_sum_csr_group``: (n, d) fp32 whose slice of
    feature f is ``segment_expand_csr(grads[f], row_splits[f], sizes[f])``
    and whose other rows are zero; a ``None`` gradient is zero. Each
    gradient's rows must be dense; their row stride may be larger than d."""
    global GROUP_LAUNCHES_BWD
    if not row_splits or all(t.device.type == "cpu" for t in (*row_splits, *(g for g in grads if g is not None))):
        return ref.segment_expand_csr_group(grads, row_splits, offsets, sizes, n, d)
    dev = row_splits[0].device
    for g, sp in zip(grads, row_splits):
        _check_splits(sp, "segment_expand_csr_group")
        s = sp.shape[0] - 1
        if sp.device != dev or (g is not None and (
                g.device != dev or g.dtype != torch.float32 or g.shape != (s, d) or g.stride(1) != 1)):
            got = None if g is None else (tuple(g.shape), g.dtype, g.stride(), g.device)
            raise ValueError(f"segment_expand_csr_group: each gradient must be ({s}, {d}) float32 "
                             f"with dense rows on {dev}, got {got}")
    if dev.type != "cuda":
        raise ValueError(f"segment_expand_csr_group: row_splits on {dev}")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    m = segment_reduce.MAX_GROUP_FEATURES
    for i in range(0, len(grads), m):  # each launch owns the rows up to the next chunk's first slice
        j = i + m
        segment_reduce.segment_expand_csr_group(grads[i:j], row_splits[i:j], offsets[i:j], sizes[i:j], out,
                                                offsets[i] if i else 0, offsets[j] if j < len(grads) else n)
        GROUP_LAUNCHES_BWD += 1
    return out


class _SegmentSumCSRGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, offsets, sizes, *row_splits):
        ctx.set_materialize_grads(False)  # an unused output's gradient is None: its rows read zero
        ctx.save_for_backward(*row_splits)
        ctx.layout = (offsets, sizes, values.shape[0], values.shape[1])
        return _segment_sum_csr_group(values, row_splits, offsets, sizes)

    @staticmethod
    def backward(ctx, *grads):
        offsets, sizes, n, d = ctx.layout
        grads = [g if g is None or g.stride(-1) == 1 else g.contiguous() for g in grads]
        dv = segment_expand_csr_group(grads, ctx.saved_tensors, offsets, sizes, n, d)
        return (dv, None, None, *[None] * len(grads))


def _segment_sum_csr_group(values, row_splits, offsets, sizes) -> tuple[torch.Tensor, ...]:
    global GROUP_LAUNCHES
    if all(t.device.type == "cpu" for t in (values, *row_splits)):
        return ref.segment_sum_csr_group(values, row_splits, offsets, sizes)
    _check_values(values, row_splits[0], "row_splits")
    for sp in row_splits:
        if sp.device != values.device:
            raise ValueError(f"segment_sum_csr_group: values on {values.device}, row_splits on {sp.device}")
        _check_splits(sp, "segment_sum_csr_group")
    n_rows = [sp.shape[0] - 1 for sp in row_splits]  # the outputs: row blocks of one buffer
    outs = torch.empty((sum(n_rows), values.shape[1]), dtype=torch.float32, device=values.device).split(n_rows)
    if values.shape[1] == 0 or not any(n_rows):
        return outs
    m = segment_reduce.MAX_GROUP_FEATURES
    for i in range(0, len(outs), m):
        segment_reduce.segment_sum_csr_group(values, row_splits[i:i + m], offsets[i:i + m], sizes[i:i + m],
                                             outs[i:i + m])
        GROUP_LAUNCHES += 1
    return outs


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
