"""Plain PyTorch version of causal attention with its log-sum-exp (the CPU
path and the oracle): the formula of ``repro/kernels/flash_attention/ref.py``
in fp32, with grouped-query heads expanded first."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hk, hd) → (B, S, Hk·G, hd), each kv head repeated G times
    (``repro/models/attention.py::_expand_kv``)."""
    return k.repeat_interleave(groups, dim=2)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Tq, H, hd), k and v (B, Tk, Hk, hd), Tq ≤ Tk → O (B, Tq, H, hd)
    in q's type and LSE (B, H, Tq) fp32. Under ``causal`` the queries are the
    last Tq positions of the sequence: row i sees keys ≤ i + Tk - Tq."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    g = h // k.shape[2]
    k, v = expand_kv(k, g), expand_kv(v, g)
    scale = np.float32(1.0 / np.sqrt(hd))
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    return flash_fwd(q, k, v, causal)[0]
