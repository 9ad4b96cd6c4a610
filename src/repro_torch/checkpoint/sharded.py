"""Checkpoints of an engine sharded over a process group.

The rows go in the checkpoint-portable form, ``EmbeddingEngine.export_rows``:
every rank exports its shard, rank 0 gathers the union and writes it
through the saver's extra-tensor file (its shapes are self-describing, as
the union's size changes from save to save). On restore every rank reads
the union and imports the rows it owns, so a checkpoint written at N ranks
restores at any M (DESIGN.md §8 elasticity), one device included. A
one-device checkpoint holds its rows in its state tree instead (the
reference's layout); ``rows_of_tree`` exports them from there, so ranks
resume it too.

``ShardedRowsHooks`` puts this on the Trainer's step-edge hook protocol
(``pipelines/trainer.py``): ``ckpt_extra`` gathers (a collective: every
rank's Trainer calls it at every save, the writing rank and the others),
``on_restore`` imports.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint import saver
from repro_torch.core import comm

PREFIX = "rows"


def layout(ckpt_dir) -> str | None:
    """Where the newest checkpoint in ``ckpt_dir`` holds its engine rows:
    ``"tree"``, in its state tree (as one device writes it), or ``"rows"``,
    in its extra file (as ranks write it); None when there is none."""
    step = saver.latest_step(ckpt_dir) if ckpt_dir is not None else None
    if step is None:
        return None
    return "tree" if any(n.startswith("state/sparse/") for n in saver.leaf_names(ckpt_dir, step)) else "rows"


def rows_of_tree(cell, ckpt_dir) -> dict:
    """The engine rows of the newest one-device checkpoint in ``ckpt_dir``:
    its state tree restored into ``cell`` (a one-device train cell of the
    shapes that wrote it), then exported. This process holds the whole
    table once, for the time of the call."""
    init = cell.init_state()
    tree = saver.restore(ckpt_dir, {"state": cell.state_tree(init)})["state"]
    return cell.engine.export_rows(cell.load_state_tree(init, tree)["sparse"])


def union(parts: list[Mapping]) -> dict:
    """Several ``export_rows`` results (the ranks', in rank order) as one."""
    out = {}
    for key in parts[0]:
        ps = [p[key] for p in parts]
        out[key] = {"ids": np.concatenate([p["ids"] for p in ps]),
                    "emb": np.concatenate([p["emb"] for p in ps]),
                    "slots": {k: np.concatenate([p["slots"][k] for p in ps]) for k in ps[0]["slots"]},
                    "last_use": np.concatenate([p["last_use"] for p in ps])}
    return out


def gather_rows(engine, sparse: Mapping, group) -> dict | None:
    """The union of every rank's export on rank 0; None on the others."""
    rows = engine.export_rows(sparse)
    if group is None:
        return rows
    parts = [None] * comm.size(group) if comm.rank(group) == 0 else None
    dist.gather_object(rows, parts, dst=dist.get_global_rank(group, 0), group=group)
    return union(parts) if parts is not None else None


def to_flat(rows: Mapping) -> dict[str, np.ndarray]:
    out = {}
    for key, r in rows.items():
        out[f"{PREFIX}/{key}/ids"] = r["ids"]
        out[f"{PREFIX}/{key}/emb"] = r["emb"]
        out[f"{PREFIX}/{key}/last_use"] = r["last_use"]
        for k, v in r["slots"].items():
            out[f"{PREFIX}/{key}/slots/{k}"] = v
    return out


def from_flat(flat: Mapping[str, np.ndarray]) -> dict:
    rows: dict = {}
    for name, v in flat.items():
        parts = name.split("/")
        if parts[0] != PREFIX:
            continue
        r = rows.setdefault(parts[1], {"slots": {}})
        if parts[2] == "slots":
            r["slots"][parts[3]] = v
        else:
            r[parts[2]] = v
    return rows


class ShardedRowsHooks:
    """Trainer hooks of a multi-rank cell: the engine rows in every
    checkpoint, gathered to rank 0, and imported by every rank on restore.
    The engine state is the trainer state's ``sparse``. ``tree_rows`` gives
    the rows of a checkpoint that holds none in its extra file (one written
    on one device)."""

    def __init__(self, engine, group, tree_rows: Callable[[], dict] | None = None):
        self.engine = engine
        self.group = group
        self.tree_rows = tree_rows
        self._state = None

    def track(self, state):
        """The state the next ``ckpt_extra`` saves."""
        self._state = state
        return state

    def pre_step(self, state, batch, step: int):
        return self.track(state), {}

    def post_step(self, state, step: int):
        return self.track(state), {}

    def ckpt_extra(self) -> dict[str, np.ndarray]:
        if self._state is None:
            raise RuntimeError("ShardedRowsHooks: no state to save (call track(state) first)")
        rows = gather_rows(self.engine, self._state["sparse"], self.group)
        return to_flat(rows) if rows is not None else {}

    def on_restore(self, state, extra: Mapping[str, np.ndarray] | None):
        rows = from_flat(extra or {})
        if not rows and self.tree_rows is not None:
            rows = self.tree_rows()
        if not rows:
            raise ValueError("the checkpoint holds no engine rows")
        return self.track({**state, "sparse": self.engine.import_rows(rows)})
