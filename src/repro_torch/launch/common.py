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
    train_insert: bool = True     # lookup_or_insert vs lookup in train
    sparse_opt_lr: float = 1e-3   # SparseAdam on the embedding rows
    dense_opt_lr: float = 1e-3    # AdamW on the dense params
    # the LM train cell: each layer recomputed in the backward, all of it
    # ("full") or all but its plain products ("dots"); the chunked loss
    remat: bool = True
    remat_policy: str = "full"
    fused_ce: bool = False
    # tiered embedding storage (storage.StorageConfig): non-None turns the
    # device tier into a row cache over a host-DRAM tier, and the train cell
    # gives the Trainer its step-edge hooks (``cell.storage_hooks``)
    storage: Any | None = None
    # the device tier's rows per shard when storage is on (the cache size);
    # None keeps the arch-derived all-device sizing
    storage_device_rows: int | None = None
    # the GNN data-parallel cells' gradient sum as int8 with error feedback
    # (optim/adamw.compressed_psum, one residual a rank); also on one device
    compress_grads: bool = False


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
    returns_state: bool = True          # False: a serve step, outputs only (the Trainer's contract)
    # the state in the reference cell's pytree layout, and back, for checkpoints
    state_tree: Callable[[Any], Any] | None = None
    load_state_tree: Callable[[Any, Any], Any] | None = None
    storage_hooks: Any = None           # a tiered train cell's StorageTrainerHooks
    engine_user: Any = None             # a retrieval cell's engines: the user's columns,
    engine_cand: Any = None             # and the candidates'
    group: Any = None                   # the torch.distributed group of a multi-rank cell


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
