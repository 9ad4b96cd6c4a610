"""Trainer-side glue for the tiered embedding store (port of
``repro/storage/integration.py``).

``StorageTrainerHooks`` adapts one engine's ``TieredEmbeddingStore`` to the
Trainer's step-edge hook protocol (pipelines/trainer.py):

  pre_step   → engine.storage_prefetch   (fill: host → device before the step)
  post_step  → engine.storage_admit      (spill: admission enforcement)
  ckpt_extra / on_restore → host tier and counts through the saver's
                            extra-tensor file, then a residency resync
  evict_fn   → engine.evict_to_host      (the staleness pass spills, not drops)

Every hook metric key is ``storage/<metric>``. Keys ending in ``_rows`` or
``_rate`` are gauges; the others are counts, which the Trainer sums over a
log interval. ``ids_fn(batch)`` maps a batch to the {feature: Ragged} ids
the engine's ``fetch_local`` will see, and ``state_key`` locates the
engine's state inside the trainer state (None: the state is the engine's).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np

from repro_torch.obs import check_name


def _get(state, state_key):
    return state if state_key is None else state[state_key]


def _put(state, state_key, sub):
    if state_key is None:
        return sub
    out = dict(state)
    out[state_key] = sub
    return out


class StorageTrainerHooks:
    def __init__(self, engine, ids_fn: Callable[[Any], Mapping], state_key: str | None = "sparse"):
        if engine.storage is None:
            raise ValueError("engine has no storage configured")
        self.engine = engine
        self.ids_fn = ids_fn
        self.state_key = state_key

    def attach_tracker(self, tracker) -> None:
        """Delta-checkpoint wiring: the store's prefetch marks every batch
        id dirty, tier moves mark through ``core.write_log``."""
        self.engine.storage.dirty = tracker

    def pre_step(self, state, batch, step: int):
        sub, met = self.engine.storage_prefetch(_get(state, self.state_key), self.ids_fn(batch), step)
        return _put(state, self.state_key, sub), _prefix(met)

    def post_step(self, state, step: int):
        sub, met = self.engine.storage_admit(_get(state, self.state_key), step)
        return _put(state, self.state_key, sub), _prefix(met)

    def evict_fn(self, state, older_than: int):
        sub, _met = self.engine.evict_to_host(_get(state, self.state_key), older_than)
        return _put(state, self.state_key, sub)

    def ckpt_extra(self) -> dict[str, np.ndarray]:
        return self.engine.storage.checkpoint_payload()

    def on_restore(self, state, extra: Mapping[str, np.ndarray] | None):
        self.engine.storage.restore_payload(extra)
        self.engine.storage.sync_from_state(_get(state, self.state_key))
        return state


def _prefix(met: dict) -> dict:
    return {check_name(f"storage/{k}"): v for k, v in met.items()}
