"""Launcher of the CUDA fused-bucketize kernel (``csrc/fused_transform.cu``),
the port of ``repro/kernels/fused_transform/fused_transform.py::
fused_bucketize_padded``."""
from __future__ import annotations

import torch

from repro_torch import kernels


def fused_bucketize(values: torch.Tensor, column_ids: torch.Tensor, boundaries: torch.Tensor,
                    boundary_offsets: torch.Tensor, out: torch.Tensor) -> None:
    """Launch on the current stream: out[i] = bucket of values[i] within
    column column_ids[i]. Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    dev = values.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = lib.repro_fused_bucketize(
        values.data_ptr(), column_ids.data_ptr(), boundaries.data_ptr(), boundary_offsets.data_ptr(),
        out.data_ptr(), values.shape[0], boundaries.shape[0], boundary_offsets.shape[0] - 1, sms, stream)
    kernels.check(lib, err, "fused_transform.fused_bucketize")
