"""Launchers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``),
the ports of ``repro/kernels/flash_attention/flash_attention.py::flash_fwd``
and ``::flash_bwd``. bf16 inputs go to the tensor-core kernels, which read
their operands by TMA through the maps that ``tma_plan`` lays out; fp32
inputs go to the FMA kernels."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

TMA_BOX = 64  # a TMA box: 64 rows x 64 columns of bf16 (one 128-byte swizzle row each)


def tma_plan(shape: tuple[int, ...], strides: tuple[int, ...], element_size: int = 2) -> list[int]:
    """The 4-D TMA map of a (B, T, H, hd) view with a contiguous last dim:
    dims innermost first (hd, then T, H and B ordered by stride, smallest
    first), the byte strides of dims 1..3, the box (64 columns x 64 rows
    along T, one head, one batch row) and the positions of T, H and B among
    dims 1..3. The C side takes these 14 numbers as one ``tc::Plan``. A dim
    of extent 1 is never stepped, so its stride is set past the others'
    span (TMA takes no zero stride)."""
    B, T, H, hd = shape
    sb, st, sh, sd = strides
    if sd != 1:
        raise ValueError(f"tma_plan: the last dim must be contiguous, strides {tuple(strides)}")
    outer = [(st, "t", T), (sh, "h", H), (sb, "b", B)]
    span = max([hd] + [s * n for s, _, n in outer if n > 1])
    outer = sorted([(s if n > 1 else span, name, n) for s, name, n in outer], key=lambda x: x[0])
    pos = {name: i + 1 for i, (_, name, _) in enumerate(outer)}
    dims = [hd] + [n for _, _, n in outer]
    byte_strides = [s * element_size for s, _, _ in outer]
    box = [TMA_BOX] + [TMA_BOX if name == "t" else 1 for _, name, _ in outer]
    return dims + byte_strides + box + [pos["t"], pos["h"], pos["b"]]


def _plans(*xs: torch.Tensor):
    """The TMA plans of bf16 operands as one C array, or None for fp32."""
    if xs[0].dtype != torch.bfloat16:
        return None
    flat = [n for x in xs for n in tma_plan(tuple(x.shape), x.stride(), x.element_size())]
    return (ctypes.c_int64 * len(flat))(*flat)


def tensor_core_launches() -> tuple[int, int]:
    """Launches of the tensor-core forward and backward since the library
    was loaded (counted on the C side where the bf16 path launches)."""
    lib = kernels.load_library()
    return lib.repro_flash_tc_launches(0), lib.repro_flash_tc_launches(1)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, scale: float, causal: bool) -> None:
    """Launch on the current stream: O and LSE of causal (or full) attention
    of q (B, T, H, hd) over k, v (B, T, Hk, hd), read through their strides.
    Arguments are checked by ``ops``."""
    lib = kernels.load_library()
    stream = kernels.current_stream(q)
    B, T, H, hd = q.shape
    err = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), B, T, H, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(causal), _plans(q, k, v), stream)
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
    stream = kernels.current_stream(q)
    B, T, H, hd = q.shape
    err = lib.repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), dk_part.data_ptr(),
        dv_part.data_ptr(), int(q.dtype == torch.bfloat16), B, T, H, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        scale, int(causal), _plans(q, k, v, do), stream)
    kernels.check(lib, err, "flash_attention.flash_bwd")
