"""sasrec — Self-Attentive Sequential Recommendation.

[arXiv:1808.09781; paper] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq.
"""
import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys.sasrec import SASRecConfig

ARCH = ArchConfig(
    arch_id="sasrec",
    family="recsys",
    model=SASRecConfig(embed_dim=50, n_blocks=2, n_heads=1, seq_len=50),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1808.09781; paper]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH, model=SASRecConfig(embed_dim=16, n_blocks=1, seq_len=8, vocab=1000))
