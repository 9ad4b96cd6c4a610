"""Cell assembly plumbing (port of ``repro/launch/common.py``).

A cell = (architecture × input shape × device) with a ready step function,
a state initialiser and a batch maker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class CellOptions:
    capacity_slack: float = 4.0   # exchange per-dest slack over U/D
    recv_slack: float = 2.0       # owner recv-unique budget over U
    sparse_opt_lr: float = 1e-3   # SparseAdam on the embedding rows
    dense_opt_lr: float = 1e-3    # AdamW on the dense params


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeCell
    device: torch.device
    step_fn: Callable                   # serve: (state, batch) -> {"logits", metrics}
                                        # train: (state, batch) -> (state, {"loss", metrics})
    init_state: Callable[[], Any]
    make_batch: Callable[..., Any]      # (seed, vocab=...) -> batch on device
    ids_fn: Callable[[Any], Any]        # batch -> {feature: Ragged} engine input
    engine: Any = None


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def local_view(sparse: dict) -> dict:
    """The one device's view of the stacked [D, ...] sparse state."""
    return {k: {"idmap": v["idmap"].map(lambda x: x[0]),
                "blocks": v["blocks"].map(lambda x: x[0])} for k, v in sparse.items()}


def stacked(local: dict, sparse: dict) -> dict:
    """The stacked [1, ...] sparse state after a train step: the new IDMap
    gains its device axis; the Blocks were written through ``local_view``'s
    views, so the stacked tensors already hold the update."""
    return {k: {"idmap": v["idmap"].map(lambda x: x.unsqueeze(0)),
                "blocks": sparse[k]["blocks"]} for k, v in local.items()}
