"""Transformer LM stack (port of ``repro/models/transformer.py``): the train
and prefill forward, the next-token loss, and one decode step over a KV
cache.

Llama-family: RMSNorm → GQA attention → RMSNorm → SwiGLU (or MoE,
``models/moe.py``) with residuals, RoPE positions, vocab head. Token
embeddings come from the Embedding Engine (sparse side) and enter here as
dense activations. The reference scans stacked layer params over a mesh;
here the layers are a Python loop over an ``nn.ModuleList`` on one device,
so its ``MeshCtx`` sharding constraints are the identity and are left out.
With ``remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``); with
``remat_policy="dots"`` the outputs of the plain 2-D products are kept and
only the rest is recomputed (the reference's
``dots_with_no_batch_dims_saveable``). ``lm_loss`` with ``fused_ce`` never
holds the (B, T, V) logits: the reference's chunked loss.
A decode step over a ``torch.distributed`` group takes this rank's slice of
the cache's sequence (the reference's ``cache_pspec`` with ``seq_shards``);
everything but the attention's all-reduces runs on every rank alone. A MoE
layer runs on one device, its experts unpadded.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import MIXED, Precision, RMSNorm, SwiGLU, dense, dense_apply


REMAT_POLICIES = ("full", "dots")


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
    moe: moe_lib.MoEConfig | None = None
    remat: bool = True  # recompute each layer in the backward
    remat_policy: str = "full"  # full | dots: what a recomputed layer keeps

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of {REMAT_POLICIES}")

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
        if cfg.moe is None:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, gen, device)
        else:
            self.moe = moe_lib.MoE(cfg.moe, gen, device)

    def ffn_out(self, h: torch.Tensor, prec: Precision,
                with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
        """h (B, T, d) → (the FFN's output, the MoE's aux loss, or None
        without MoE or ``with_aux``)."""
        if not hasattr(self, "moe"):
            return self.ffn(h, prec), None
        b, t, d = h.shape
        y, aux = moe_lib.moe_apply(self.moe, h.reshape(b * t, d), prec, with_aux)
        return y.view(b, t, d), aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor, prec: Precision
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """Returns (x', k after RoPE, v, the MoE's aux loss or None)."""
        a, k, v = self.attn(self.attn_norm(x), positions, prec)
        x = x + a
        f, aux = self.ffn_out(self.ffn_norm(x), prec)
        return x + f, k, v, aux


class Transformer(nn.Module):
    """``layers.{i}``, ``final_norm`` and ``head`` (d_model → vocab, no bias);
    weights U(±1/√d_in), biases 0 and norm scales 1, as the reference draws
    them (from a seeded ``torch.Generator``, not from its keys). ``gen``,
    when given, takes the place of a CPU generator seeded ``seed`` and
    draws on its own device: a card's generator draws a model on that card
    where it lies (seconds for 56 GB, where the host takes minutes)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed) if gen is None else gen
        self.layers = nn.ModuleList(Layer(cfg, gen, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.head = dense(cfg.d_model, cfg.vocab_size, gen, bias=False, device=device)


def init(cfg: TransformerConfig, seed: int = 0, device=None,
         gen: torch.Generator | None = None) -> Transformer:
    return Transformer(cfg, seed, device, gen).eval()


def _layer_x(layer: Layer, x: torch.Tensor, positions: torch.Tensor, prec: Precision):
    x, _, _, aux = layer(x, positions, prec)
    return x, aux


# The plain 2-D products: the projections, the dense and shared SwiGLU and
# the router (``nn.Linear`` and ``@`` reach these). The grouped experts
# write with ``out=`` (``aten.mm.out``) and flash is no product, so both are
# recomputed, as the reference recomputes its batched expert einsums.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kw(cfg: TransformerConfig) -> dict:
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)}
    return {}


def apply(model: Transformer, x_emb: torch.Tensor, prec: Precision = MIXED,
          collect_cache: bool = False):
    """x_emb (B, T, d) token embeddings → (hidden (B, T, d) after the final
    norm, aux, cache): aux the sum of the MoE layers' aux losses (fp32 0-d;
    0 without MoE). With ``collect_cache`` the cache is (k, v), each
    (L, B, T, Hk, hd) in the compute type: every layer's K after RoPE and
    V, the values its attention used; else None. With ``cfg.remat``, grad
    enabled and no cache, each layer keeps only its input for the backward
    and runs again there (all of it, or with ``remat_policy="dots"`` all but
    its plain products)."""
    cfg = model.cfg
    b, t, _ = x_emb.shape
    positions = torch.arange(t, dtype=torch.int32, device=x_emb.device).expand(b, t)
    x = prec.cast(x_emb)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    cache, aux = None, torch.zeros((), dtype=torch.float32, device=x.device)
    kw = _remat_kw(cfg) if remat else {}
    for i, layer in enumerate(model.layers):
        if remat:
            x, a = checkpoint(_layer_x, layer, x, positions, prec, use_reentrant=False, **kw)
        else:
            x, k, v, a = layer(x, positions, prec)
        if a is not None:
            aux = aux + a
        if collect_cache:
            if cache is None:
                cache = tuple(torch.empty((cfg.n_layers, *c.shape), dtype=c.dtype, device=c.device)
                              for c in (k, v))
            cache[0][i].copy_(k)
            cache[1][i].copy_(v)
    return model.final_norm(x), aux, cache


def lm_loss(model: Transformer, x_emb: torch.Tensor, labels: torch.Tensor,
            prec: Precision = MIXED, fused_ce: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(next-token cross entropy, aux): the loss the mean over the B·T
    positions of logsumexp(logits) − logits[label], with the head's logits
    in the compute type cast to fp32; aux ``apply``'s sum of the MoE
    layers' aux losses (0 without MoE), which the train cell adds to the
    loss it differentiates. Without ``fused_ce`` the (B, T, V) logits are
    made whole (the reference's plain path), with it ``_chunked_ce``."""
    h, aux, _ = apply(model, x_emb, prec)
    if fused_ce:
        return _chunked_ce(model.head, h, labels, prec), aux
    return torch.mean(_ce_terms(model.head, h, labels, prec)), aux


def _ce_terms(head: nn.Linear, h: torch.Tensor, labels: torch.Tensor, prec: Precision) -> torch.Tensor:
    """logsumexp(logits) − logits[label] at each of h's positions (fp32)."""
    logits = dense_apply(head, h, prec).to(torch.float32)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _ce_sum(head: nn.Linear, h: torch.Tensor, labels: torch.Tensor, prec: Precision) -> torch.Tensor:
    return torch.sum(_ce_terms(head, h, labels, prec))


def _chunked_ce(head: nn.Linear, h: torch.Tensor, labels: torch.Tensor, prec: Precision,
                t_chunk: int = 256) -> torch.Tensor:
    """The reference's ``_chunked_ce``: the positions in chunks of
    ``t_chunk`` (the tail, t % t_chunk, as one more), each chunk's logits
    made and dropped under ``torch.utils.checkpoint`` and made again in the
    backward; the chunks' sums added in order in fp32, over B·T."""
    b, t, _ = h.shape
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, t, t_chunk):
        total = total + checkpoint(_ce_sum, head, h[:, lo:lo + t_chunk], labels[:, lo:lo + t_chunk], prec,
                                   use_reentrant=False)
    return total / (b * t)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, device=None,
               dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Zero K and V caches, each (L, batch, seq_len, Hk, hd). Over a group
    ``batch`` and ``seq_len`` are this rank's slice (the reference's
    ``cache_pspec``)."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(model: Transformer, x_emb: torch.Tensor, cache: dict[str, torch.Tensor], pos: torch.Tensor,
                group=None, prec: Precision = MIXED) -> torch.Tensor:
    """One token through the whole stack: x_emb (B, 1, d), the embedding of
    the token at global position ``pos`` (a 0-d tensor on the device) →
    fp32 logits (B, V). Every layer's K and V of the token are written into
    ``cache`` in place; with a ``group`` the cache is sequence-sharded over
    its ranks."""
    x = prec.cast(x_emb)
    for i, layer in enumerate(model.layers):
        h = layer.attn_norm(x)
        x = x + attn.attn_decode_apply(layer.attn, h, cache["k"][i], cache["v"][i], pos, group, prec)
        x = x + layer.ffn_out(layer.ffn_norm(x), prec, with_aux=False)[0]  # the reference drops a MoE's aux
    x = model.final_norm(x)
    return dense_apply(model.head, x, prec)[:, 0, :].to(torch.float32)
