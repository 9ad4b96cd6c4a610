"""Config framework: architectures × input-shape cells (port of
``repro/configs/base.py``: the recsys, LM and GNN shapes)."""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                      # train | serve | retrieval | prefill | decode
                                   # | full_graph | minibatch | graph_batch
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, k):
        return self.params[k]

    def get(self, k, default=None):
        return self.params.get(k, default)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # recsys | lm | gnn
    model: Any                     # family-specific model config
    shapes: tuple[ShapeCell, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}; have {[s.name for s in self.shapes]}")


RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65_536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262_144}),
    ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1, "long_context": True}),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7}),
    ShapeCell("minibatch_lg", "minibatch",
              {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
               "fanout": (15, 10), "d_feat": 602, "n_classes": 41}),
    ShapeCell("ogb_products", "full_graph",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47}),
    ShapeCell("molecule", "graph_batch",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "n_classes": 2}),
)
