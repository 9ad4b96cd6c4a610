"""Launchers of the CUDA segment-sum kernels (``csrc/segment_reduce.cu``),
the port of ``repro/kernels/segment_reduce/segment_reduce.py::
segment_sum_padded`` (forward) and of its VJP (``ops.py::_bwd``), per
feature and per dim group."""
from __future__ import annotations

import array
from typing import Sequence

import torch

from repro_torch import kernels


def segment_sum_sorted(values: torch.Tensor, bounds: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out[s] = values[bounds[s]:bounds[s+1]].sum(0),
    bounds int32 or int64, clamped to [0, N] on the card. Arguments are
    checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(values)
    err = lib.repro_segment_sum_sorted(
        values.data_ptr(), bounds.data_ptr(), int(bounds.dtype == torch.int64), out.data_ptr(),
        values.shape[0], out.shape[0], out.shape[1], stream)
    kernels.check(lib, err, "segment_reduce.segment_sum")


def segment_expand_csr(g: torch.Tensor, g_stride: int, bounds: torch.Tensor,
                       out: torch.Tensor) -> None:
    """Launch on the current stream: out[j] = g[s] for j in [bounds[s],
    bounds[s+1]), zero outside [bounds[0], bounds[S]). Arguments are
    checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(out)
    err = lib.repro_segment_expand_csr(
        g.data_ptr(), g_stride, bounds.data_ptr(), int(bounds.dtype == torch.int64),
        out.data_ptr(), out.shape[0], bounds.shape[0] - 1, out.shape[1], stream)
    kernels.check(lib, err, "segment_reduce.segment_expand_csr")


MAX_GROUP_FEATURES = 64  # the kernels' parameter table (csrc: kMaxGroupFeatures)


def _table(row_splits: Sequence[torch.Tensor], ptrs: Sequence[int], offsets: Sequence[int],
           sizes: Sequence[int], strides: Sequence[int]) -> array.array:
    """The features' descriptors in host memory, 7 int64 each: splits,
    splits are int64, data pointer, ofs, n_vals, n_rows, row stride."""
    flat = []
    for sp, ptr, o, n, st in zip(row_splits, ptrs, offsets, sizes, strides):
        flat += (sp.data_ptr(), sp.dtype == torch.int64, ptr, o, n, sp.shape[0] - 1, st)
    return array.array("q", flat)


def segment_sum_csr_group(values: torch.Tensor, row_splits: Sequence[torch.Tensor],
                          offsets: Sequence[int], sizes: Sequence[int],
                          outs: Sequence[torch.Tensor]) -> None:
    """Launch once on the current stream, for at most MAX_GROUP_FEATURES
    features: outs[f][s] = values[offsets[f] + b_s : offsets[f] + b_{s+1}].sum(0)
    with b = row_splits[f] clamped to [0, sizes[f]]. Arguments are checked
    by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(values)
    d = values.shape[1]
    table = _table(row_splits, [o.data_ptr() for o in outs], offsets, sizes, [d] * len(outs))
    err = lib.repro_segment_sum_csr_group(values.data_ptr(), values.shape[0], d, table.buffer_info()[0],
                                          len(outs), stream)
    kernels.check(lib, err, "segment_reduce.segment_sum_csr_group")


def segment_expand_csr_group(grads: Sequence[torch.Tensor | None], row_splits: Sequence[torch.Tensor],
                             offsets: Sequence[int], sizes: Sequence[int], out: torch.Tensor,
                             row_lo: int, row_hi: int) -> None:
    """Launch once on the current stream: out[offsets[f] + j] = grads[f][s]
    for every row j of segment s of feature f, every other row of [row_lo,
    row_hi) zero (a ``None`` gradient covers nothing). Each gradient's rows
    are dense. Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(out)
    d = out.shape[1]
    table = _table(row_splits, [0 if g is None else g.data_ptr() for g in grads], offsets, sizes,
                   [0 if g is None else g.stride(0) if g.shape[0] > 1 else d for g in grads])
    err = lib.repro_segment_expand_csr_group(out.data_ptr(), out.shape[0], d, row_lo, row_hi,
                                             table.buffer_info()[0], len(grads), stream)
    kernels.check(lib, err, "segment_reduce.segment_expand_csr_group")
