"""Config framework: architectures × input-shape cells (port of
``repro/configs/base.py``, recsys shapes only)."""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                      # train | serve | retrieval
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __getitem__(self, k):
        return self.params[k]

    def get(self, k, default=None):
        return self.params.get(k, default)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                    # recsys
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
