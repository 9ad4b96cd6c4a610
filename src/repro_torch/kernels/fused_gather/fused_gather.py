"""Launchers of the CUDA gather kernels (``csrc/fused_gather.cu``): the row
gather, the port of ``repro/kernels/fused_gather/fused_gather.py::
gather_rows_padded``, and the slab gather, the port of ``gather_rows_slab``."""
from __future__ import annotations

import torch

from repro_torch import kernels


def gather_rows(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out[i] = table[ids[i]] (PAD and
    out-of-range ids read row 0). Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    (r, d), k = table.shape, ids.shape[0]
    err = lib.repro_gather_rows(table.data_ptr(), ids.data_ptr(), ids.dtype is torch.int64, out.data_ptr(),
                                r, d, k, kernels.current_stream(table))
    kernels.check(lib, err, "fused_gather.gather_rows")


def gather_rows_slab(table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
                     rows_blk: int, slab: int) -> None:
    """Launch on the current stream: the windowed gather of ``ref.
    gather_rows_slab`` with ``slab`` already cut to round_up(R, 8).
    Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(table)
    err = lib.repro_gather_rows_slab(
        table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
        table.shape[0], table.shape[1], ids.shape[0], rows_blk, slab, stream)
    kernels.check(lib, err, "fused_gather.gather_rows_slab")
