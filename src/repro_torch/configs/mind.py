"""mind — Multi-Interest Network with Dynamic routing.

[arXiv:1904.08030; unverified] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest.
"""
import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys.mind import MINDConfig

ARCH = ArchConfig(
    arch_id="mind",
    family="recsys",
    model=MINDConfig(embed_dim=64, n_interests=4, capsule_iters=3, seq_len=50),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1904.08030; unverified]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH, model=MINDConfig(embed_dim=16, n_interests=2, capsule_iters=2,
                               seq_len=8, n_neg=2, vocab=1000))
