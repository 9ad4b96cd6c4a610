"""Public flash-attention op: a CUDA tensor goes through the kernel, a CPU
tensor through the plain version. There is no fallback: a kernel that fails
to build or launch raises. Forward only: the backward kernel is ROADMAP B7,
so the op refuses, on the card, inputs that need a gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as fa, ref

LAUNCHES = 0  # kernel launches since the last reset (read by chip_smoke.py)
HEAD_DIMS = (16, 32, 64, 128)


def _check_layout(name: str, x: torch.Tensor) -> None:
    """The kernel's 16-byte loads read ``x`` in place: last dim contiguous,
    the other strides and the address on 16-byte boundaries."""
    e = 16 // x.element_size()
    if x.stride(-1) != 1 or any(s % e for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} (strides {x.stride()}) must have a contiguous last dim "
                         "and its address and other strides on 16-byte boundaries")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of q (B, T, H, hd) over k, v (B, T, Hk, hd), H a multiple of
    Hk (query head h reads kv head h // (H // Hk)), scaled by 1/sqrt(hd).
    Returns O (B, T, H, hd) in q's type and LSE = m + log l (B, H, T) fp32."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be (B, T, H, hd) and (B, T, Hk, hd) with H a multiple of Hk")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return ref.flash_fwd(q, k, v, causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device}, v on {v.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError("flash_attention: the backward kernel is not ported yet "
                                  "(ROADMAP B7); call it under torch.no_grad()")
    if q.dtype not in (torch.float32, torch.bfloat16) or q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: takes float32 or bfloat16 with head dim in "
                         f"{HEAD_DIMS}, got {q.dtype}, head dim {q.shape[3]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, x)
    B, T, H, hd = q.shape
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    fa.flash_fwd(q, k, v, o, lse, float(1.0 / hd ** 0.5), causal)
    LAUNCHES += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """O of ``flash_fwd``: (B, T, H, hd) in q's type."""
    return flash_fwd(q, k, v, causal)[0]
