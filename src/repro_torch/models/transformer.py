"""Transformer LM stack (port of ``repro/models/transformer.py``), one device:
the train and prefill forward, and the next-token loss.

Llama-family: RMSNorm → GQA attention → RMSNorm → SwiGLU with residuals,
RoPE positions, vocab head. Token embeddings come from the Embedding Engine
(sparse side) and enter here as dense activations. The reference scans
stacked layer params over a mesh; here the layers are a Python loop over an
``nn.ModuleList`` on one device, so its ``MeshCtx`` sharding constraints are
the identity and are left out. With ``remat`` each layer is recomputed in the
backward (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
MoE layers, ``remat_policy="dots"``, the chunked loss (ROADMAP A17) and
decode are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.layers import MIXED, Precision, RMSNorm, SwiGLU, dense, dense_apply


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
    remat: bool = True  # recompute each layer in the backward

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


def _layer_x(layer: Layer, x: torch.Tensor, positions: torch.Tensor, prec: Precision) -> torch.Tensor:
    return layer(x, positions, prec)[0]


def apply(model: Transformer, x_emb: torch.Tensor, prec: Precision = MIXED,
          collect_cache: bool = False):
    """x_emb (B, T, d) token embeddings → (hidden (B, T, d) after the final
    norm, cache). With ``collect_cache`` the cache is (k, v), each
    (L, B, T, Hk, hd) in the compute type: every layer's K after RoPE and
    V, the values its attention used; else None. With ``cfg.remat``, grad
    enabled and no cache, each layer keeps only its input for the backward
    and runs again there."""
    cfg = model.cfg
    b, t, _ = x_emb.shape
    positions = torch.arange(t, dtype=torch.int32, device=x_emb.device).expand(b, t)
    x = prec.cast(x_emb)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    cache = None
    for i, layer in enumerate(model.layers):
        if remat:
            x = checkpoint(_layer_x, layer, x, positions, prec, use_reentrant=False)
            continue
        x, k, v = layer(x, positions, prec)
        if collect_cache:
            if cache is None:
                cache = tuple(torch.empty((cfg.n_layers, *c.shape), dtype=c.dtype, device=c.device)
                              for c in (k, v))
            cache[0][i].copy_(k)
            cache[1][i].copy_(v)
    return model.final_norm(x), cache


def lm_loss(model: Transformer, x_emb: torch.Tensor, labels: torch.Tensor,
            prec: Precision = MIXED) -> torch.Tensor:
    """Next-token cross entropy, the mean over the B·T positions of
    logsumexp(logits) − logits[label], with the head's logits (B, T, V) in
    the compute type cast to fp32 (the reference's plain path, ``fused_ce``
    off). The reference also returns an aux loss, which is 0 without MoE."""
    h, _ = apply(model, x_emb, prec)
    logits = dense_apply(model.head, h, prec).to(torch.float32)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)
