"""Launchers of the CUDA sequence-tile kernels (``csrc/sequence_tile.cu``),
the port of ``repro/kernels/sequence_tile/sequence_tile.py::
sequence_tile_padded`` and of its gradient."""
from __future__ import annotations

import torch

from repro_torch import kernels


def _launch(fn_name: str, src: torch.Tensor, splits: torch.Tensor, out: torch.Tensor,
            n: int, k: int, d: int) -> None:
    lib = kernels.load_library()
    dev = out.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = getattr(lib, fn_name)(src.data_ptr(), splits.data_ptr(), int(splits.dtype == torch.int64),
                                out.data_ptr(), n, splits.shape[0] - 1, k, d, sms, stream)
    kernels.check(lib, err, f"sequence_tile.{fn_name}")


def sequence_tile(values: torch.Tensor, row_splits: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out (S, k, D) = the first k value rows
    of each CSR row, zero past its length. Arguments are checked by ``ops``."""
    _launch("repro_sequence_tile", values, row_splits, out, values.shape[0], out.shape[1], out.shape[2])


def sequence_untile(g: torch.Tensor, row_splits: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out (N, D) = the gradient of
    ``sequence_tile`` for g (S, k, D). Arguments are checked by ``ops``."""
    _launch("repro_sequence_untile", g, row_splits, out, out.shape[0], g.shape[1], g.shape[2])
