"""Public flash-attention op: a CUDA tensor goes through the kernels, a CPU
tensor through the plain versions. There is no fallback: a kernel that fails
to build or launch raises. The op is a ``torch.autograd.Function``: its
forward is ``flash_fwd`` and its backward ``flash_bwd``, each a CUDA kernel
on the card: the tensor-core kernels (wgmma fed by TMA) for bf16, the FMA
kernels for fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention as fa, ref

LAUNCHES = 0      # forward kernel launches since the last reset (read by chip_smoke.py)
BWD_LAUNCHES = 0  # backward kernel launches, likewise
HEAD_DIMS = (16, 32, 64, 128)  # the fp32 kernels' head dims; a smaller one is padded up
TC_HEAD_DIMS = (64, 128)       # the bf16 (tensor-core) kernels' head dims: one swizzle mode serves both


def padded_head_dim(hd: int, dtype: torch.dtype) -> int:
    """The head dim the kernels run ``hd`` at: the next of ``TC_HEAD_DIMS``
    for bf16, of ``HEAD_DIMS`` for fp32."""
    dims = TC_HEAD_DIMS if dtype == torch.bfloat16 else HEAD_DIMS
    return next(n for n in dims if n >= hd)


def pad_head_dim(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The tensors with their last (head) dim zero-padded to
    ``padded_head_dim`` of q's head dim and type."""
    hd = named["q"].shape[3]
    hd_k = padded_head_dim(hd, named["q"].dtype)
    if hd_k == hd:
        return named
    return {n: F.pad(x, (0, hd_k - hd)) for n, x in named.items()}


tensor_core_launches = fa.tensor_core_launches  # (forward, backward) bf16 launches, counted by the C side


def _aligned(x: torch.Tensor) -> bool:
    """The kernels' 16-byte loads can read ``x`` in place: last dim
    contiguous, the other strides and the address on 16-byte boundaries;
    for bf16 (read by TMA) no zero stride on a dim longer than 1."""
    e = 16 // x.element_size()
    broadcast = x.dtype == torch.bfloat16 and any(s == 0 and n > 1 for s, n in zip(x.stride()[:3], x.shape[:3]))
    return x.stride(-1) == 1 and not any(s % e for s in x.stride()[:3]) and x.data_ptr() % 16 == 0 \
        and not broadcast


def _check_layout(name: str, x: torch.Tensor) -> None:
    if not _aligned(x):
        raise ValueError(f"flash_attention: {name} (strides {x.stride()}) must have a contiguous last dim, "
                         "its address and other strides on 16-byte boundaries, and in bf16 no broadcast dim")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "must be (B, T, H, hd) and (B, T, Hk, hd) with H a multiple of Hk")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")


def _check_card(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """What the kernels take: one CUDA device, fp32 or bf16, a head dim of
    at most 128, and layouts they can read in place. Returns the inputs with
    the head dim zero-padded to ``padded_head_dim``, as the
    reference pads it to a multiple of 128 (``repro/kernels/
    flash_attention/ops.py:55``): zero columns of q and k add nothing to a
    score, and those of v, O and dO give zero columns of O, dQ, dK and dV,
    which the caller slices off. The scale stays 1/sqrt(the original hd)."""
    q = named["q"]
    if q.device.type != "cuda" or any(x.device != q.device for x in named.values()):
        raise ValueError("flash_attention: " + ", ".join(f"{n} on {x.device}" for n, x in named.items()))
    hd = q.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16) or not 0 < hd <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: takes float32 or bfloat16 with head dim at most "
                         f"{HEAD_DIMS[-1]}, got {q.dtype}, head dim {hd}")
    named = pad_head_dim(named)
    for name, x in named.items():
        _check_layout(name, x)
    return named


def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return ref.flash_fwd(q, k, v, causal)
    B, T, H, hd = q.shape
    x = _check_card({"q": q, "k": k, "v": v})
    o = torch.empty((B, T, H, x["q"].shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o[..., :hd], lse
    fa.flash_fwd(x["q"], x["k"], x["v"], o, lse, float(1.0 / hd ** 0.5), causal)
    LAUNCHES += 1
    return (o if o.shape[3] == hd else o[..., :hd].contiguous()), lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, causal: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ (q's shape), dK and dV (k's shape) in q's type, from dO (q's
    shape and type), the forward's O and its LSE (B, H, T) fp32."""
    global BWD_LAUNCHES
    _check_shapes(q, k, v)
    B, T, H, hd = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, T) \
            or o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention: o {tuple(o.shape)} {o.dtype}, do {tuple(do.shape)} {do.dtype}, "
                         f"lse {tuple(lse.shape)} {lse.dtype} do not fit q {tuple(q.shape)} {q.dtype}")
    if all(x.device.type == "cpu" for x in (q, k, v, o, lse, do)):
        return ref.flash_bwd(q, k, v, o, lse, do, causal)
    x = _check_card({"q": q, "k": k, "v": v, "o": o, "do": do})
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention: lse on {lse.device}, strides {lse.stride()}: must be contiguous "
                         f"on {q.device}")
    hd_k = x["q"].shape[3]
    dq = torch.empty((B, T, H, hd_k), dtype=q.dtype, device=q.device)
    dk = torch.empty((*k.shape[:3], hd_k), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    # dK and dV of each query head, summed over each kv head's group afterwards
    dk_part = torch.empty((B, T, H, hd_k), dtype=torch.float32, device=q.device)
    dv_part = torch.empty_like(dk_part)
    fa.flash_bwd(x["q"], x["k"], x["v"], x["o"], x["do"], lse, dq, dk, dv, delta, dk_part, dv_part,
                 float(1.0 / hd ** 0.5), causal)
    BWD_LAUNCHES += 1
    if hd_k == hd:
        return dq, dk, dv
    return tuple(g[..., :hd].contiguous() for g in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not _aligned(do):
            # autograd hands dO over in the layout it chose: an expanded
            # zero-stride tensor after a .sum(), for one. The kernels read
            # it in place, so it is laid out afresh here (a copy of dO, not
            # a path around the kernel).
            do = do.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention of q (B, T, H, hd) over k, v (B, T, Hk, hd), H a multiple of
    Hk (query head h reads kv head h // (H // Hk)), scaled by 1/sqrt(hd);
    on the card hd is at most 128.
    Returns O (B, T, H, hd) in q's type, differentiable in q, k and v, and
    LSE = m + log l (B, H, T) fp32, not differentiable."""
    _check_shapes(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """O of ``flash_fwd``: (B, T, H, hd) in q's type."""
    return flash_fwd(q, k, v, causal)[0]
