"""Plain PyTorch version of causal attention with its log-sum-exp, and its
backward (the CPU path and the oracle): the formulas of
``repro/kernels/flash_attention/ref.py`` and of the backward kernels of
``flash_attention.py`` in fp32, with grouped-query heads expanded first."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hk, hd) → (B, S, Hk·G, hd), each kv head repeated G times
    (``repro/models/attention.py::_expand_kv``)."""
    return k.repeat_interleave(groups, dim=2)


def _scale(hd: int) -> np.float32:
    return np.float32(1.0 / np.sqrt(hd))


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """S = Q Kᵀ · scale (B, H, Tq, Tk), masked with NEG_INF above the
    bottom-right diagonal under ``causal``; k has q's heads."""
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q, k) * _scale(q.shape[3])
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        s = torch.where(mask, s, NEG_INF)
    return s


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Tq, H, hd), k and v (B, Tk, Hk, hd), Tq ≤ Tk → O (B, Tq, H, hd)
    in q's type and LSE (B, H, Tq) fp32. Under ``causal`` the queries are the
    last Tq positions of the sequence: row i sees keys ≤ i + Tk - Tq."""
    g = q.shape[2] // k.shape[2]
    k, v = expand_kv(k, g), expand_kv(v, g)
    s = _scores(q.float(), k.float(), causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float())
    return o.to(q.dtype), lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of O = ``flash_fwd(q, k, v)[0]`` from dO (q's shape), the
    saved O and LSE (B, H, Tq): dQ (q's shape), dK and dV (k's shape), each
    in its input's type. Step by step, in fp32:
    P = exp(S − LSE), delta = rowsum(dO·O), dV = Pᵀ dO, dP = dO Vᵀ,
    dS = P·(dP − delta)·scale, dQ = dS K, dK = dSᵀ Q. Over grouped heads dK
    and dV sum over the G query heads that read each kv head: the transpose
    of ``expand_kv``."""
    b, tk, hk, hd = k.shape
    g = q.shape[2] // hk
    qf, dof = q.float(), do.float()
    kf, vf = expand_kv(k, g).float(), expand_kv(v, g).float()
    p = torch.exp(_scores(qf, kf, causal) - lse[..., None])          # (B, H, Tq, Tk)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)                # (B, H, Tq)
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None]) * _scale(hd)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf)
    dk, dv = (x.reshape(b, tk, hk, g, hd).sum(3) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    return flash_fwd(q, k, v, causal)[0]
