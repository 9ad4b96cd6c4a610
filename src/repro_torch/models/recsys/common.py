"""Shared recsys losses (port of ``repro/models/recsys/common.py``)."""
from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, mean over the batch."""
    z, y = logits.to(torch.float32), labels.to(torch.float32)
    per = torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    return per.mean()
