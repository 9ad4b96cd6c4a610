"""Transformer LM stack (port of ``repro/models/transformer.py``), one device,
train/prefill forward.

Llama-family: RMSNorm → GQA attention → RMSNorm → SwiGLU with residuals,
RoPE positions, vocab head. Token embeddings come from the Embedding Engine
(sparse side) and enter here as dense activations. The reference scans
stacked layer params over a mesh; here the layers are a Python loop over an
``nn.ModuleList`` on one device, so its ``MeshCtx`` sharding constraints are
the identity and are left out. MoE layers (ROADMAP A17) and decode are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import MIXED, Precision, RMSNorm, SwiGLU, dense


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: Any = None   # the reference's MoEConfig; not ported (ROADMAP A17)

    @property
    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, device)
        self.attn = attn.Attention(cfg.attn_cfg, gen, device)
        self.ffn_norm = RMSNorm(cfg.d_model, device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, gen, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, prec: Precision
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (x', k after RoPE, v)."""
        a, k, v = self.attn(self.attn_norm(x), positions, prec)
        x = x + a
        return x + self.ffn(self.ffn_norm(x), prec), k, v


class Transformer(nn.Module):
    """``layers.{i}``, ``final_norm`` and ``head`` (d_model → vocab, no bias);
    weights U(±1/√d_in), biases 0 and norm scales 1, as the reference draws
    them (from a seeded ``torch.Generator``, not from its keys)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet (ROADMAP A17)")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList(Layer(cfg, gen, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.head = dense(cfg.d_model, cfg.vocab_size, gen, bias=False, device=device)


def init(cfg: TransformerConfig, seed: int = 0, device=None) -> Transformer:
    return Transformer(cfg, seed, device).eval()


def apply(model: Transformer, x_emb: torch.Tensor, prec: Precision = MIXED,
          collect_cache: bool = False):
    """x_emb (B, T, d) token embeddings → (hidden (B, T, d) after the final
    norm, cache). With ``collect_cache`` the cache is (k, v), each
    (L, B, T, Hk, hd) in the compute type: every layer's K after RoPE and
    V, the values its attention used; else None."""
    cfg = model.cfg
    b, t, _ = x_emb.shape
    positions = torch.arange(t, dtype=torch.int32, device=x_emb.device).expand(b, t)
    x = prec.cast(x_emb)
    cache = None
    for i, layer in enumerate(model.layers):
        x, k, v = layer(x, positions, prec)
        if collect_cache:
            if cache is None:
                cache = tuple(torch.empty((cfg.n_layers, *c.shape), dtype=c.dtype, device=c.device)
                              for c in (k, v))
            cache[0][i].copy_(k)
            cache[1][i].copy_(v)
    return model.final_norm(x), cache
