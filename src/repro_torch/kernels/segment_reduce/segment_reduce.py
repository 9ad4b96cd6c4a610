"""Launchers of the CUDA segment-sum kernels (``csrc/segment_reduce.cu``),
the port of ``repro/kernels/segment_reduce/segment_reduce.py::
segment_sum_padded`` (forward) and of its VJP (``ops.py::_bwd``)."""
from __future__ import annotations

import torch

from repro_torch import kernels


def segment_sum_sorted(values: torch.Tensor, bounds: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out[s] = values[bounds[s]:bounds[s+1]].sum(0),
    bounds int32 or int64, clamped to [0, N] on the card. Arguments are
    checked by ``ops``."""
    lib = kernels.load_library()
    stream = torch.cuda.current_stream(values.device).cuda_stream
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
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.repro_segment_expand_csr(
        g.data_ptr(), g_stride, bounds.data_ptr(), int(bounds.dtype == torch.int64),
        out.data_ptr(), out.shape[0], bounds.shape[0] - 1, out.shape[1], stream)
    kernels.check(lib, err, "segment_reduce.segment_expand_csr")
