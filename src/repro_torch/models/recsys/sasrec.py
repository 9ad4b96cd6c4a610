"""SASRec (arXiv:1808.09781): self-attentive sequential recommendation (port
of ``repro/models/recsys/sasrec.py``).

embed_dim 50, 2 blocks, 1 head, seq_len 50. The history, positive and
negative item columns share one engine table (``shared_table="items"``).
Training takes the paper's per-position BCE over (positive, negative)
pairs; serving scores the last valid hidden state against the target or
the candidate rows. The attention is the reference's plain product (no
flash kernel: the reference uses none here), masked with -1e30, so a query
whose allowed keys are all masked reads a uniform row, not NaN.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.models.layers import MIXED, LayerNorm, Precision, dense, dense_apply


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_neg: int = 1
    vocab: int = 10_000_000


def feature_specs(cfg: SASRecConfig) -> list[FeatureSpec]:
    d = cfg.embed_dim
    return [
        FeatureSpec("hist_items", transform="hash", emb_dim=d, pooling="none",
                    max_len=cfg.seq_len, shared_table="items"),
        FeatureSpec("pos_items", transform="hash", emb_dim=d, pooling="none",
                    max_len=cfg.seq_len, shared_table="items"),
        FeatureSpec("neg_items", transform="hash", emb_dim=d, pooling="none",
                    max_len=cfg.seq_len * cfg.n_neg, shared_table="items"),
    ]


class Block(nn.Module):
    """Pre-norm self-attention (one head) and a ReLU feed-forward, d → d."""

    def __init__(self, d: int, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d, device)
        self.wq = dense(d, d, gen, device=device)
        self.wk = dense(d, d, gen, device=device)
        self.wv = dense(d, d, gen, device=device)
        self.ln2 = LayerNorm(d, device)
        self.ff1 = dense(d, d, gen, device=device)
        self.ff2 = dense(d, d, gen, device=device)


class SASRec(nn.Module):
    def __init__(self, cfg: SASRecConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d = cfg.embed_dim
        pos = torch.randn((cfg.seq_len, d), generator=gen, dtype=torch.float32) * 0.02
        self.pos_emb = nn.Parameter(pos.to(device))
        for b in range(cfg.n_blocks):
            self.add_module(f"block{b}", Block(d, gen, device))
        self.final_ln = LayerNorm(d, device)

    def encode(self, hist: torch.Tensor, mask: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
        """hist: (B, T, d) item rows; mask: (B, T) bool. Returns (B, T, d)."""
        t, d = hist.shape[1], hist.shape[2]
        x = prec.cast(hist) + prec.cast(self.pos_emb)[None, :t]
        keep = mask[..., None].to(x.dtype)
        x = x * keep
        allowed = torch.tril(torch.ones((t, t), dtype=torch.bool, device=hist.device))[None] & mask[:, None, :]
        for b in range(self.cfg.n_blocks):
            bp = getattr(self, f"block{b}")
            h = bp.ln1(x)
            q, k, v = (dense_apply(w, h, prec) for w in (bp.wq, bp.wk, bp.wv))
            s = torch.matmul(q, k.transpose(1, 2)).to(torch.float32) / np.float32(np.sqrt(d))
            s = torch.where(allowed, s, -1e30)
            x = x + torch.matmul(prec.cast(torch.softmax(s, dim=-1)), v)
            h = bp.ln2(x)
            x = x + dense_apply(bp.ff2, F.relu(dense_apply(bp.ff1, h, prec)), prec)
            x = x * keep
        return self.final_ln(x)

    def user_repr(self, acts: dict, prec: Precision = MIXED) -> torch.Tensor:
        """(B, d): the hidden state at the last valid position, position 0
        for an empty history. The reference reads position count(mask) - 1,
        which is masked when an id before the last has no row (ROADMAP C6);
        where the mask is a prefix the two are the same position."""
        hist = acts["hist_items"]
        mask = torch.any(hist != 0.0, dim=-1)
        h = self.encode(hist, mask, prec)
        pos = torch.arange(mask.shape[1], device=mask.device)
        last = torch.argmax(pos * mask, dim=-1)
        return h[torch.arange(h.shape[0], device=h.device), last]

    def forward(self, acts: dict, dense: dict, prec: Precision = MIXED) -> torch.Tensor:
        """Serving: the rank score (B,) of the target item, the first
        ``pos_items`` entry."""
        u = self.user_repr(acts, prec).to(torch.float32)
        tgt = acts["pos_items"][:, 0, :].to(torch.float32)
        return (u * tgt).sum(-1)

    def loss(self, acts: dict, prec: Precision = MIXED, denom: torch.Tensor | None = None) -> torch.Tensor:
        hist = acts["hist_items"]                               # (B, T, d)
        mask = torch.any(hist != 0.0, dim=-1)
        h = self.encode(hist, mask, prec)                       # (B, T, d)
        b, t, d = h.shape
        pos = prec.cast(acts["pos_items"])                      # (B, T, d)
        neg = prec.cast(acts["neg_items"]).reshape(b, t, self.cfg.n_neg, d)
        pos_logit = torch.matmul(h[:, :, None, :], pos[..., None])[..., 0, 0].to(torch.float32)
        neg_logit = torch.matmul(neg, h[..., None])[..., 0].to(torch.float32)
        m = mask.to(torch.float32)
        lp = F.logsigmoid(pos_logit) * m
        ln = F.logsigmoid(-neg_logit) * m[..., None]
        if denom is None:
            denom = torch.clamp(m.sum(), min=1.0)
        return -(lp.sum() + ln.sum() / self.cfg.n_neg) / denom


def init(cfg: SASRecConfig, seed: int = 0, device=None) -> SASRec:
    return SASRec(cfg, seed, device).eval()


def _check(model: SASRec, cfg: SASRecConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("model was built for another SASRecConfig")


def apply(model: SASRec, cfg: SASRecConfig, acts: dict, dense: dict,
          prec: Precision = MIXED) -> torch.Tensor:
    """fp32 scores (B,), with the reference's ``apply(params, cfg, ...)`` signature."""
    _check(model, cfg)
    return model(acts, dense, prec)


def loss(model: SASRec, cfg: SASRecConfig, acts: dict, dense: dict,
         prec: Precision = MIXED, denom: torch.Tensor | None = None) -> torch.Tensor:
    """Per-position BCE over (positive, negative), over the valid positions:
    divided by their count, or by ``denom`` where the caller gives it (the
    count over a whole batch split between ranks, clamped to at least 1)."""
    _check(model, cfg)
    return model.loss(acts, prec, denom)


def loss_count(acts: dict) -> torch.Tensor:
    """The valid positions that ``loss`` divides by (fp32, no gradient)."""
    return torch.any(acts["hist_items"].detach() != 0.0, dim=-1).sum(dtype=torch.float32)


def score_candidates(model: SASRec, cfg: SASRecConfig, acts: dict, dense: dict,
                     cand_rows: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
    """fp32 scores (Nc,) of one user's last hidden state against each row."""
    _check(model, cfg)
    u = model.user_repr(acts, prec)
    return (prec.cast(cand_rows) @ u[0]).to(torch.float32)
