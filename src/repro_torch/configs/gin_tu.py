"""gin-tu — Graph Isomorphism Network (TU datasets config).

[arXiv:1810.00826; paper] n_layers=5 d_hidden=64 aggregator=sum eps=learnable.
The per-shape d_feat/n_classes come from the shape cells (Cora / Reddit /
ogbn-products / molecule); the model config carries the GIN backbone.
"""
import dataclasses

from repro_torch.configs.base import GNN_SHAPES, ArchConfig
from repro_torch.models.gnn import GINConfig

ARCH = ArchConfig(
    arch_id="gin-tu",
    family="gnn",
    model=GINConfig(n_layers=5, d_hidden=64, eps_learnable=True),
    shapes=GNN_SHAPES,
    source="[arXiv:1810.00826; paper]",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(ARCH, model=GINConfig(n_layers=2, d_hidden=16))
