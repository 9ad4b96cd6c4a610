"""Wide & Deep (arXiv:1606.07792), 40 categorical features (port of
``repro/models/recsys/wide_deep.py``).

Wide side: each feature's dim-8 row from its own table (a second engine dim
group), summed over the features and projected to a scalar. Deep side: 40 ×
dim-32 embeddings → MLP 1024-512-256 → logit. A scalar ``bias`` joins them.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.models.layers import MIXED, MLP, Precision, dense, dense_apply
from repro_torch.models.recsys.common import bce_with_logits


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    n_sparse: int = 40
    embed_dim: int = 32
    wide_dim: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    vocab_per_feature: int = 1_000_000


def feature_specs(cfg: WideDeepConfig) -> list[FeatureSpec]:
    specs = []
    for i in range(cfg.n_sparse):
        specs.append(FeatureSpec(f"cat_{i}", transform="hash", emb_dim=cfg.embed_dim, pooling="sum"))
        specs.append(FeatureSpec(
            f"wide_{i}", transform="hash", emb_dim=cfg.wide_dim, pooling="sum",
            shared_table=f"wide_tbl_{i}",
        ))
    specs.append(FeatureSpec("label", transform="raw", max_len=1))
    return specs


def _wide_sum(acts: dict, features: range, prec: Precision) -> torch.Tensor:
    """The wide rows in the compute type, added one after another from
    feature ``features[0]``, as the reference's ``sum(...)`` adds them."""
    return sum(prec.cast(acts[f"wide_{i}"]) for i in features)


class WideDeep(nn.Module):
    def __init__(self, cfg: WideDeepConfig, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.deep = MLP((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp, gen, device)
        self.deep_out = dense(cfg.mlp[-1], 1, gen, device=device)
        self.wide_proj = dense(cfg.wide_dim, 1, gen, device=device)
        self.bias = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))

    def _logits(self, deep_in: torch.Tensor, wide: torch.Tensor, prec: Precision) -> torch.Tensor:
        deep = self.deep(deep_in, prec, final_act=True)
        deep_logit = dense_apply(self.deep_out, deep, prec)[:, 0]
        wide_logit = dense_apply(self.wide_proj, wide, prec)[:, 0]
        return (deep_logit + wide_logit).to(torch.float32) + self.bias

    def forward(self, acts: dict, dense: dict, prec: Precision = MIXED) -> torch.Tensor:
        """fp32 logits (B,)."""
        n = self.cfg.n_sparse
        deep_in = torch.cat([prec.cast(acts[f"cat_{i}"]) for i in range(n)], dim=-1)
        return self._logits(deep_in, _wide_sum(acts, range(n), prec), prec)

    def score_candidates(self, acts: dict, cand_rows: torch.Tensor, cand_wide: torch.Tensor,
                         prec: Precision = MIXED) -> torch.Tensor:
        """One user × Nc candidates: the candidate takes the place of
        cat_0 / wide_0; the user's other features are broadcast."""
        n, d = self.cfg.n_sparse, self.cfg.embed_dim
        nc = cand_rows.shape[0]
        fixed = torch.cat([prec.cast(acts[f"cat_{i}"]) for i in range(1, n)], dim=-1)
        deep_in = torch.cat([prec.cast(cand_rows), fixed.expand(nc, (n - 1) * d)], dim=-1)
        wide = prec.cast(cand_wide) + _wide_sum(acts, range(1, n), prec).expand(cand_wide.shape)
        return self._logits(deep_in, wide, prec)


def init(cfg: WideDeepConfig, seed: int = 0, device=None) -> WideDeep:
    return WideDeep(cfg, seed, device).eval()


def _check(model: WideDeep, cfg: WideDeepConfig) -> None:
    if model.cfg != cfg:
        raise ValueError("model was built for another WideDeepConfig")


def apply(model: WideDeep, cfg: WideDeepConfig, acts: dict, dense: dict,
          prec: Precision = MIXED) -> torch.Tensor:
    """Logits (B,), with the reference's ``apply(params, cfg, ...)`` signature."""
    _check(model, cfg)
    return model(acts, dense, prec)


def loss(model: WideDeep, cfg: WideDeepConfig, acts: dict, dense: dict,
         prec: Precision = MIXED) -> torch.Tensor:
    """Mean sigmoid cross-entropy of the logits against ``dense["label"]``."""
    return bce_with_logits(apply(model, cfg, acts, dense, prec), dense["label"][:, 0])


def score_candidates(model: WideDeep, cfg: WideDeepConfig, acts: dict, dense: dict,
                     cand_rows: torch.Tensor, cand_wide: torch.Tensor,
                     prec: Precision = MIXED) -> torch.Tensor:
    """fp32 scores (Nc,) of one user's features against each candidate's
    deep row ``cand_rows`` and wide row ``cand_wide``."""
    _check(model, cfg)
    return model.score_candidates(acts, cand_rows, cand_wide, prec)
