"""Shared recsys losses (port of ``repro/models/recsys/common.py``): CTR
models read a "label" raw column; sequential models (SASRec, MIND) build
their targets from positive and negative item columns that share the item
table (``FeatureSpec.shared_table``)."""
from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, mean over the batch."""
    z, y = logits.to(torch.float32), labels.to(torch.float32)
    per = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    return per.mean()


def sampled_softmax_loss(pos_logit: torch.Tensor, neg_logits: torch.Tensor) -> torch.Tensor:
    """(B,), (B, n_neg) → mean cross-entropy of the positive among the
    1 + n_neg candidates."""
    all_l = torch.cat([pos_logit[:, None], neg_logits], dim=1).to(torch.float32)
    return (torch.logsumexp(all_l, dim=1) - all_l[:, 0]).mean()
