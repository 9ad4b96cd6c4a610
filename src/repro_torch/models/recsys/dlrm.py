"""DLRM (arXiv:1906.00091), MLPerf config (port of
``repro/models/recsys/dlrm.py``): 13 dense + 26 categorical features,
embed_dim 128, bottom MLP 13-512-256-128, dot interaction, top MLP
1024-1024-512-256-1. The 26 tables are one merged dim-128 group of the
Embedding Engine.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.models.layers import MIXED, MLP, Precision
from repro_torch.models.recsys.common import bce_with_logits


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    vocab_per_feature: int = 4_000_000  # Criteo-1TB scale (hashed)

    def bot_dims(self) -> tuple[int, ...]:
        return (self.n_dense,) + self.bot_mlp

    def top_dims(self) -> tuple[int, ...]:
        n_pairs = (self.n_sparse + 1) * self.n_sparse // 2
        return (self.bot_mlp[-1] + n_pairs,) + self.top_mlp


def feature_specs(cfg: DLRMConfig) -> list[FeatureSpec]:
    specs = [
        FeatureSpec(f"cat_{i}", transform="hash", emb_dim=cfg.embed_dim, pooling="sum")
        for i in range(cfg.n_sparse)
    ]
    specs.append(FeatureSpec("dense", transform="raw", max_len=cfg.n_dense))
    specs.append(FeatureSpec("label", transform="raw", max_len=1))
    return specs


def _interact(vecs: torch.Tensor) -> torch.Tensor:
    """vecs: (B, F, d) → lower-triangle pairwise dots (B, F(F-1)/2), pairs in
    the row-major order of ``tril_indices(F, F, offset=-1)``."""
    f = vecs.shape[1]
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    iu, ju = torch.tril_indices(f, f, offset=-1, device=vecs.device)
    return z[:, iu, ju]


class DLRM(nn.Module):
    def __init__(self, cfg: DLRMConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.bot = MLP(cfg.bot_dims(), gen, device)
        self.top = MLP(cfg.top_dims(), gen, device)

    def forward(self, acts: dict, dense: dict, prec: Precision = MIXED) -> torch.Tensor:
        """Returns fp32 logits (B,)."""
        bot = self.bot(prec.cast(dense["dense"]), prec, final_act=True)            # (B, d)
        emb = torch.stack([acts[f"cat_{i}"] for i in range(self.cfg.n_sparse)], dim=1)
        vecs = torch.cat([prec.cast(emb), bot[:, None, :]], dim=1)               # (B, 27, d)
        top_in = torch.cat([bot, _interact(vecs)], dim=-1)
        return self.top(top_in, prec)[:, 0].to(torch.float32)


def init(cfg: DLRMConfig, seed: int = 0, device=None) -> DLRM:
    return DLRM(cfg, seed, device).eval()


def apply(model: DLRM, cfg: DLRMConfig, acts: dict, dense: dict,
          prec: Precision = MIXED) -> torch.Tensor:
    """Logits (B,), with the reference's ``apply(params, cfg, ...)`` signature."""
    if model.cfg != cfg:
        raise ValueError("model was built for another DLRMConfig")
    return model(acts, dense, prec)


def loss(model: DLRM, cfg: DLRMConfig, acts: dict, dense: dict,
         prec: Precision = MIXED) -> torch.Tensor:
    """Mean sigmoid cross-entropy of the logits against ``dense["label"]``."""
    return bce_with_logits(apply(model, cfg, acts, dense, prec), dense["label"][:, 0])


def score_candidates(model: DLRM, cfg: DLRMConfig, acts: dict, dense: dict,
                     cand_rows: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
    """Retrieval: one user (batch-1 features) × Nc candidate rows, fp32
    scores (Nc,). The candidate row takes the place of feature cat_0; the
    bottom MLP and the user-user dots are computed once and broadcast, and
    the candidate-user dots come first in the interaction."""
    if model.cfg != cfg:
        raise ValueError("model was built for another DLRMConfig")
    nc = cand_rows.shape[0]
    bot = model.bot(prec.cast(dense["dense"]), prec, final_act=True)                 # (1, d)
    user = torch.stack([acts[f"cat_{i}"] for i in range(1, cfg.n_sparse)], dim=1)
    user = torch.cat([prec.cast(user), bot[:, None, :]], dim=1)[0]                   # (F_u, d)
    f_u = user.shape[0]
    iu, ju = torch.tril_indices(f_u, f_u, offset=-1, device=user.device)
    uu = (user @ user.T)[iu, ju]
    inter = torch.cat([prec.cast(cand_rows) @ user.T, uu[None].expand(nc, uu.shape[0])], dim=-1)
    top_in = torch.cat([bot.expand(nc, bot.shape[-1]), inter], dim=-1)
    return model.top(top_in, prec)[:, 0].to(torch.float32)
