"""GQA attention with RoPE for train and prefill (port of
``repro/models/attention.py``), one device.

Supports the LM family's head layouts (MHA kv = H, GQA kv < H, MQA kv = 1)
and the optional QKV bias (Qwen-style). The attention core is the flash
kernel: a CUDA tensor goes through ``csrc/flash_attention.cu`` for any
sequence length, a CPU tensor through its plain version. The kernel reads
the grouped kv heads by stride, so the reference's ``_expand_kv`` lives
beside the plain version (``kernels/flash_attention/ref.py::expand_kv``).
Decode (``decode_attention``, ``attn_decode_apply``) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import MIXED, Precision, dense, dense_apply


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

