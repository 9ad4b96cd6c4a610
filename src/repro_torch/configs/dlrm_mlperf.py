"""dlrm-mlperf — MLPerf DLRM benchmark config (Criteo 1TB).

[arXiv:1906.00091; paper] n_dense=13 n_sparse=26 embed_dim=128
bot_mlp=13-512-256-128 top_mlp=1024-1024-512-256-1 interaction=dot.
"""
import dataclasses

from repro_torch.configs.base import RECSYS_SHAPES, ArchConfig
from repro_torch.models.recsys.dlrm import DLRMConfig

ARCH = ArchConfig(
    arch_id="dlrm-mlperf",
    family="recsys",
    model=DLRMConfig(
        n_dense=13, n_sparse=26, embed_dim=128,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
    ),
    shapes=RECSYS_SHAPES,
    source="[arXiv:1906.00091; paper]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        ARCH,
        model=DLRMConfig(n_dense=13, n_sparse=26, embed_dim=16,
                         bot_mlp=(32, 16), top_mlp=(64, 32, 1),
                         vocab_per_feature=1000))
