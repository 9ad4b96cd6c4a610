"""Launchers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``),
the ports of ``repro/kernels/flash_attention/flash_attention.py::flash_fwd``
and ``::flash_bwd``."""
from __future__ import annotations

import torch

from repro_torch import kernels


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, scale: float, causal: bool) -> None:
    """Launch on the current stream: O and LSE of causal (or full) attention
    of q (B, T, H, hd) over k, v (B, T, Hk, hd), read through their strides.
    Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    B, T, H, hd = q.shape
    err = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, T, H, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(causal), stream)
    kernels.check(lib, err, "flash_attention.flash_fwd")


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
              delta: torch.Tensor, dk_part: torch.Tensor, dv_part: torch.Tensor,
              scale: float, causal: bool) -> None:
    """Launch on the current stream: dQ, dK and dV from q, k, v, O and dO
    (read through their strides) and the forward's LSE; ``delta``,
    ``dk_part`` and ``dv_part`` are fp32 scratch. Arguments are checked by
    ``ops``."""
    lib = kernels.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    B, T, H, hd = q.shape
    err = lib.repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), int(q.dtype == torch.bfloat16), B, T, H, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        scale, int(causal), stream)
    kernels.check(lib, err, "flash_attention.flash_bwd")
