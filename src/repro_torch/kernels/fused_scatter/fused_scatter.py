"""Launcher of the CUDA row-scatter kernel (``csrc/fused_scatter.cu``), the
port of ``repro/kernels/fused_scatter/fused_scatter.py::scatter_rows_padded``."""
from __future__ import annotations

import torch

from repro_torch import kernels


def scatter_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                 valid: torch.Tensor | None, add: bool) -> None:
    """Launch on the current stream: table[ids[i]] += rows[i] (``add``) or
    = rows[i], in place, for slots with an id in range and ``valid`` set.
    Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(table)
    err = lib.repro_scatter_rows(
        table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
        None if valid is None else valid.data_ptr(), rows.data_ptr(),
        table.shape[0], table.shape[1], ids.shape[0], int(add), stream)
    kernels.check(lib, err, "fused_scatter.scatter_rows")
