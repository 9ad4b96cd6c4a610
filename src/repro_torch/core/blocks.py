"""Blocks — tier 2 of the Embedding Engine (port of ``repro/core/blocks.py``).

Contiguous storage for one merged dim-group's embedding rows and their
optimizer slot rows on one device. Row 0 is the reserved overflow bucket.
New rows are initialised from their feature id by a stateless hash, bit for
bit as the reference does. Row reads go through the gather kernel; row
writes go through the scatter kernel and update the tensors in place (the
reference returns new arrays). The tiered store's tier moves read a row
with its slot rows (``gather_with_slots``: three gathers), write whole rows
(``write_rows``) and zero them (``clear_rows``): three scatter sets each,
where the reference's ``.at[].set(mode="drop")`` computes the same.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core import write_log
from repro_torch.core.feature_engine import _SPLITMIX_C1, _srl, splitmix64
from repro_torch.kernels.fused_gather import ops as fg_ops
from repro_torch.kernels.fused_scatter import ops as fs_ops


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


def _hash_uniform(ids: torch.Tensor, dim: int) -> torch.Tensor:
    """Deterministic per-(id, column) uniform in [-1, 1), from splitmix64 of
    ``id * 0x9E3779B97F4A7C15 + column`` (wrapping int64 = uint64 bits)."""
    cols = torch.arange(dim, dtype=torch.int64, device=ids.device)[None, :]
    bits = splitmix64(ids.to(torch.int64)[:, None] * _SPLITMIX_C1 + cols)
    u01 = _srl(bits, 40).to(torch.float32) * np.float32(2.0**-24)
    return u01 * 2.0 - 1.0


def init_rows(b: Blocks, offsets: torch.Tensor, ids: torch.Tensor, is_new: torch.Tensor) -> Blocks:
    """Initialise newly allocated rows in place: emb ← uniform(±1/sqrt(dim))
    of the id, slots ← 0. Only the new rows are hashed (their count costs one
    host sync); the reference hashes every slot and drops the others."""
    s = float(np.float32(1.0 / np.sqrt(b.dim)))
    sel = torch.nonzero(is_new).squeeze(1)
    dst = offsets[sel]
    init = _hash_uniform(ids[sel], b.dim) * s
    fs_ops.scatter_set_rows(b.emb, dst, init)
    zeros = torch.zeros_like(init)
    for v in b.slots.values():
        fs_ops.scatter_set_rows(v, dst, zeros)
    return b


def gather_with_slots(b: Blocks, offsets: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Embedding rows with their optimizer slot rows at ``offsets``: the
    demotion read (a spill carries the Adam moments, so a later promotion
    resumes training bit for bit)."""
    return gather(b, offsets), {k: fg_ops.gather_rows(v, offsets) for k, v in b.slots.items()}


def write_rows(b: Blocks, offsets: torch.Tensor, emb: torch.Tensor, slots: Mapping[str, torch.Tensor],
               mask: torch.Tensor) -> Blocks:
    """Write whole rows (embedding and slots) at ``offsets`` where ``mask``,
    in place: the promotion write. Masked-off slots write nothing."""
    fs_ops.scatter_set_rows(b.emb, offsets, emb, mask)
    for k, v in b.slots.items():
        fs_ops.scatter_set_rows(v, offsets, slots[k], mask)
    write_log.note_rows_written(mask)
    return b


def clear_rows(b: Blocks, offsets: torch.Tensor, mask: torch.Tensor) -> Blocks:
    """Zero the rows at ``offsets`` where ``mask``, in place, so a demoted
    row's state cannot leak into the row's next owner."""
    zeros = torch.zeros((offsets.shape[0], b.dim), dtype=torch.float32, device=b.emb.device)
    fs_ops.scatter_set_rows(b.emb, offsets, zeros, mask)
    for v in b.slots.values():
        fs_ops.scatter_set_rows(v, offsets, zeros, mask)
    return b
