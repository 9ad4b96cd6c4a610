"""Blocks — tier 2 of the Embedding Engine (port of ``repro/core/blocks.py``).

Contiguous storage for one merged dim-group's embedding rows and their
optimizer slot rows on one device. Row 0 is the reserved overflow bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.fused_gather import ops as fg_ops


@dataclasses.dataclass
class Blocks:
    emb: torch.Tensor                # (n_rows, dim) fp32
    slots: dict[str, torch.Tensor]   # optimizer slot rows, each (n_rows, dim) fp32

    @property
    def n_rows(self) -> int:
        return self.emb.shape[-2]

    @property
    def dim(self) -> int:
        return self.emb.shape[-1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Blocks":
        """Apply ``fn`` to every tensor (e.g. take one device's shard)."""
        return Blocks(emb=fn(self.emb), slots={k: fn(v) for k, v in self.slots.items()})


def create(n_rows: int, dim: int, device, slot_names: tuple[str, ...] = ("m", "v")) -> Blocks:
    def zeros():
        return torch.zeros((n_rows, dim), dtype=torch.float32, device=device)

    return Blocks(emb=zeros(), slots={k: zeros() for k in slot_names})


def gather(b: Blocks, offsets: torch.Tensor) -> torch.Tensor:
    """Fetch embedding rows at ``offsets`` through the fused_gather kernel."""
    return fg_ops.gather_rows(b.emb, offsets)
