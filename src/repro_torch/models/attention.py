"""GQA attention with RoPE for train, prefill and KV-cache decode (port of
``repro/models/attention.py``).

Supports the LM family's head layouts (MHA kv = H, GQA kv < H, MQA kv = 1)
and the optional QKV bias (Qwen-style). The train and prefill core is the
flash kernel: a CUDA tensor goes through ``csrc/flash_attention.cu`` for
any sequence length, a CPU tensor through its plain version. The kernel
reads the grouped kv heads by stride, so the reference's ``_expand_kv``
lives beside the plain version (``kernels/flash_attention/ref.py::expand_kv``).

Decode attends one new token to the whole cache, masked, as the reference
does (the reference has no decode kernel: plain products and softmax). The
cache is read in place: one batched product per kv head over its strided
(B, S, hd) slice, with q viewed as (B, Hk, G, hd), so the cache is never
expanded or copied; the new token's K and V are written into it in place.
Over a ``torch.distributed`` group the cache holds this rank's slice of
the sequence and the ranks combine the softmax statistics with three
all-reduces a layer (the max, then the sums of p and of p·V): the
reference's distributed flash-decode (DESIGN.md §5 "SP").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.core import comm
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import MIXED, Precision, dense, dense_apply

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., T, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, hd), k and v (B, T, Hk, hd) → (B, T, H·hd), in q's type."""
    b, t, h, hd = q.shape
    return fa_ops.flash_attention(q, k, v, causal=True).reshape(b, t, h * hd)


class Attention(nn.Module):
    """Projections ``wq``, ``wk``, ``wv`` (bias when ``qkv_bias``) and ``wo``."""

    def __init__(self, cfg: AttnConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = dense(cfg.d_model, cfg.n_heads * hd, gen, bias=cfg.qkv_bias, device=device)
        self.wk = dense(cfg.d_model, cfg.n_kv_heads * hd, gen, bias=cfg.qkv_bias, device=device)
        self.wv = dense(cfg.d_model, cfg.n_kv_heads * hd, gen, bias=cfg.qkv_bias, device=device)
        self.wo = dense(cfg.n_heads * hd, cfg.d_model, gen, bias=False, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, prec: Precision = MIXED
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, T, d), positions (B, T) → (out (B, T, d), k after RoPE and v,
        both (B, T, Hk, hd): what the prefill cache keeps)."""
        b, t, _ = x.shape
        cfg, hd = self.cfg, self.cfg.head_dim
        q = dense_apply(self.wq, x, prec).view(b, t, cfg.n_heads, hd)
        k = dense_apply(self.wk, x, prec).view(b, t, cfg.n_kv_heads, hd)
        v = dense_apply(self.wv, x, prec).view(b, t, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = causal_attention(q, k, v)
        return dense_apply(self.wo, o, prec), k, v


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                     group=None, prec: Precision = MIXED) -> torch.Tensor:
    """One token against a (possibly sequence-sharded) KV cache: q (B, 1, H,
    hd), caches (B, S_local, Hk, hd), ``pos`` the new token's global
    position (a 0-d tensor on the device) → (B, 1, H·hd) in q's type.

    Positions ``rank · S_local + arange(S_local)`` at or before ``pos`` are
    attended to; the statistics are fp32. Rounding as the reference's: the
    scores' product output and p are in the compute type, and so is each
    rank's o before the sum over ranks."""
    b, _, h, hd = q.shape
    s_local, hk = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    offset = comm.rank(group) * s_local
    valid = torch.arange(offset, offset + s_local, dtype=torch.int64, device=q.device) <= pos
    qg = prec.cast(q).view(b, hk, g, hd)
    scores = torch.empty((b, hk, g, s_local), dtype=torch.float32, device=q.device)
    for j in range(hk):  # one strided batch a kv head: the cache is read where it lies
        scores[:, j].copy_(torch.bmm(qg[:, j], prec.cast(k_cache[:, :, j]).transpose(1, 2)))
    scores.mul_(float(np.float32(1.0 / np.sqrt(hd))))  # the reference's fp32 scale
    scores.masked_fill_(~valid, NEG_INF)
    m = scores.amax(-1, keepdim=True)                      # (B, Hk, G, 1): this rank's max
    comm.all_reduce(m, group, dist.ReduceOp.MAX)
    p = scores.sub_(m).exp_()
    del scores
    l = p.sum(-1, keepdim=True)
    o = torch.empty((b, hk, g, hd), dtype=torch.float32, device=q.device)
    for j in range(hk):
        o[:, j].copy_(torch.bmm(prec.cast(p[:, j]), prec.cast(v_cache[:, :, j])))
    del p
    comm.all_reduce(l, group)
    comm.all_reduce(o, group)
    return (o / l.clamp_min(1e-30)).reshape(b, 1, h * hd).to(q.dtype)


def _write_token(cache: torch.Tensor, x: torch.Tensor, pos: torch.Tensor, group) -> None:
    """Write x (B, 1, Hk, hd) into ``cache`` (B, S_local, Hk, hd) at ``pos``,
    in place and without a host sync. Over a group only the rank whose
    slice holds ``pos`` changes its cache: the others write back what they
    hold. One device clamps ``pos`` into the cache as the reference's
    ``dynamic_update_slice`` does."""
    s_local = cache.shape[1]
    local = pos - comm.rank(group) * s_local
    idx = local.clamp(0, s_local - 1).reshape(1).long()
    x = x.to(cache.dtype)
    if group is not None:
        x = torch.where((local >= 0) & (local < s_local), x, cache.index_select(1, idx))
    cache.index_copy_(1, idx, x)


def attn_decode_apply(attn: Attention, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: torch.Tensor, group=None, prec: Precision = MIXED) -> torch.Tensor:
    """x (B, 1, d) of the token at ``pos`` → (B, 1, d): q, k, v with RoPE at
    ``pos``, k and v written into the caches in place, ``decode_attention``,
    then ``wo``."""
    b = x.shape[0]
    cfg, hd = attn.cfg, attn.cfg.head_dim
    q = dense_apply(attn.wq, x, prec).view(b, 1, cfg.n_heads, hd)
    k = dense_apply(attn.wk, x, prec).view(b, 1, cfg.n_kv_heads, hd)
    v = dense_apply(attn.wv, x, prec).view(b, 1, cfg.n_kv_heads, hd)
    ppos = pos.expand(b, 1)
    q = apply_rope(q, ppos, cfg.rope_theta)
    _write_token(cache_k, apply_rope(k, ppos, cfg.rope_theta), pos, group)
    _write_token(cache_v, v, pos, group)
    o = decode_attention(q, cache_k, cache_v, pos, group, prec)
    return dense_apply(attn.wo, o, prec)
