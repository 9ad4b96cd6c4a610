"""wide-deep — Wide & Deep Learning for Recommender Systems.

[arXiv:1606.07792; paper] n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat.
"""
import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys.wide_deep import WideDeepConfig

ARCH = ArchConfig(
    arch_id="wide-deep",
    family="recsys",
    model=WideDeepConfig(n_sparse=40, embed_dim=32, mlp=(1024, 512, 256)),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1606.07792; paper]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=WideDeepConfig(n_sparse=8, embed_dim=8, wide_dim=8,
                             mlp=(32, 16), vocab_per_feature=1000))
