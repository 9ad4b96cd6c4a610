"""Dirty-row tracking, the "what changed this interval" half of delta
checkpoints (port of ``repro/ft/dirty.py``, DESIGN.md §13).

A :class:`DirtyTracker` is the process-wide ``core.write_log`` observer
plus the tiered store's ``dirty`` hook. Between two checkpoints it
accumulates, per embedding group:

  * **dirty** ids: rows whose bytes may differ from the last frame
    (batch ids the step updates, fresh inserts, tier moves); and
  * **dead** ids: rows discarded with no surviving copy (a plain
    engine's staleness evict). These become tombstones in the next delta
    so recovery does not resurrect them from an older frame.

An id is in at most one of the two sets: a write after a discard makes
the row live again (re-insert), a discard after a write makes it dead.
``drain()`` hands the interval to the checkpointer and resets; if the
save fails the checkpointer merges the interval back (nothing is lost:
the rows stay dirty for the next attempt).

The reference keeps Python sets and loops over every id; here each set is
a sorted np.int64 vector of unique ids and every operation is a whole-
vector merge (a dlrm-mlperf step at batch 8,192 marks about 60,000 ids).
The counters and gauge take the reference's values.

Thread-safe: marks arrive from the trainer thread, drains from whichever
thread runs the checkpoint phase.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch import obs

_EMPTY = np.zeros((0,), np.int64)


@dataclasses.dataclass
class DirtyInterval:
    """One drained checkpoint interval: sorted np.int64 id vectors."""

    dirty: dict[str, np.ndarray]
    dead: dict[str, np.ndarray]

    def n_dirty(self) -> int:
        return sum(v.size for v in self.dirty.values())

    def n_dead(self) -> int:
        return sum(v.size for v in self.dead.values())


def _ids(ids) -> np.ndarray:
    """Sorted unique int64 ids of any array-like."""
    return np.unique(np.asarray(ids, np.int64).ravel())


def _union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted unique vectors."""
    return b if a.size == 0 else a if b.size == 0 else np.union1d(a, b)


def _minus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a`` without the ids of ``b`` (both sorted unique)."""
    return a if a.size == 0 or b.size == 0 else np.setdiff1d(a, b, assume_unique=True)


class DirtyTracker:
    def __init__(self, registry: obs.MetricsRegistry | None = None):
        self._lock = threading.Lock()
        self._dirty: dict[str, np.ndarray] = {}
        self._dead: dict[str, np.ndarray] = {}
        reg = registry if registry is not None else obs.get_registry()
        self._c_marked = reg.counter("ckpt/rows_marked_dirty")
        self._c_written = reg.counter("ckpt/rows_written")
        self._g_pending = reg.gauge("ckpt/dirty_pending")

    # ----------------------------------------------- write_log observer API
    def mark(self, group: str, ids: np.ndarray):
        ids = _ids(ids)
        if not ids.size:
            return
        with self._lock:
            d = self._dirty.get(group, _EMPTY)
            merged = _union(d, ids)
            self._dirty[group] = merged
            self._c_marked.inc(merged.size - d.size)
            if group in self._dead:
                self._dead[group] = _minus(self._dead[group], ids)
            self._g_pending.set(self._pending_locked())

    def mark_dead(self, group: str, ids: np.ndarray):
        ids = _ids(ids)
        if not ids.size:
            return
        with self._lock:
            self._dead[group] = _union(self._dead.get(group, _EMPTY), ids)
            if group in self._dirty:
                self._dirty[group] = _minus(self._dirty[group], ids)
            self._g_pending.set(self._pending_locked())

    def count_written(self, group: str, n: int):
        self._c_written.inc(int(n))

    # --------------------------------------------------- checkpointer side
    def _pending_locked(self) -> int:
        return sum(v.size for v in self._dirty.values())

    def pending(self) -> int:
        with self._lock:
            return self._pending_locked()

    def drain(self) -> DirtyInterval:
        """Take the accumulated interval and reset the tracker."""
        with self._lock:
            out = DirtyInterval(dirty={g: v for g, v in self._dirty.items() if v.size},
                                dead={g: v for g, v in self._dead.items() if v.size})
            self._dirty = {}
            self._dead = {}
            self._g_pending.set(0)
        return out

    def merge_back(self, interval: DirtyInterval):
        """Undo a drain after a failed save: the interval's rows are still
        unpersisted, so they must survive into the next attempt. Marks
        recorded since the drain are NEWER than the interval and win."""
        with self._lock:
            for g, ids in interval.dead.items():
                self._dead[g] = _union(self._dead.get(g, _EMPTY),
                                       _minus(ids, self._dirty.get(g, _EMPTY)))
            for g, ids in interval.dirty.items():
                self._dirty[g] = _union(self._dirty.get(g, _EMPTY),
                                        _minus(ids, self._dead.get(g, _EMPTY)))
            self._g_pending.set(self._pending_locked())
