"""Trainer hooks for delta checkpointing on a PLAIN (non-tiered) engine
(port of ``repro/ft/hooks.py``).

A tiered engine already has a step-edge hook object
(``storage.StorageTrainerHooks``) whose prefetch pass sees every batch id
eagerly, so attaching the tracker there is enough. A plain engine inserts
its rows inside the step, outside any ``write_log`` shard scope, so this
adapter computes the batch's engine ids in ``pre_step`` and marks them
dirty: the step will insert or update exactly those rows.

The unique runs where the ids are (on the card for a card batch), and only
the unique ids are copied to the host; they equal the reference's
``np.unique`` bit for bit.

Duck-type compatible with the Trainer hook protocol and with
``StorageTrainerHooks`` (``engine`` / ``ids_fn`` / ``state_key`` /
``attach_tracker``), so ``pipelines.Trainer`` wires delta mode the same
way for both engine kinds.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from repro_torch.ft.dirty import DirtyTracker

PAD = -1


class FTTrainerHooks:
    def __init__(self, engine, ids_fn: Callable[[Any], Mapping],
                 state_key: str | None = "sparse"):
        self.engine = engine
        self.ids_fn = ids_fn
        self.state_key = state_key
        self.tracker: DirtyTracker | None = None

    def attach_tracker(self, tracker: DirtyTracker) -> None:
        self.tracker = tracker

    def pre_step(self, state, batch, step: int):
        if self.tracker is not None:
            with torch.no_grad():
                eng = self.engine.engine_ids(self.ids_fn(batch))
            for g, raw in eng.items():
                ids = torch.unique(raw.to(torch.int64))
                self.tracker.mark(g, ids[ids != PAD].cpu().numpy())
        return state, {}

    def post_step(self, state, step: int):
        return state, {}
