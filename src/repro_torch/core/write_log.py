"""Write-observation seam for the embedding state (port of
``repro/core/write_log.py``).

The fault-tolerance layer needs to know which rows changed in each
checkpoint interval without the core modules depending on it. The core
write paths that run at step edges (`idmap.lookup_or_insert`,
`idmap.remove`, `idmap.evict`, `blocks.write_rows`) call the ``note_*``
functions below, and a process-wide observer, installed by whoever owns
checkpointing, receives (group, ids) marks.

Two guards keep the seam free when unused:

  * no observer installed → every ``note_*`` returns at once, before it
    touches a tensor (no copy to the host, no synchronise);
  * no active :func:`shard_scope` → the write has no group attribution
    (e.g. a test poking the idmap directly) and is skipped.

The reference also skips notes from inside ``jit`` (its arguments are
tracers there). The port runs eagerly; the train step's own insert
(`exchange.fetch`) runs outside any shard scope, so the second guard
leaves it unobserved, as the reference's traced call is.

Every note keeps each id but PAD (-1). The reference keeps only ids >= 0,
which drops the negative half of the salted 64-bit engine ids as well: a
negative id a plain engine's evict discards then gets no tombstone, and a
recovery brings it back from an older frame (ROADMAP §C, C4).

The observer protocol:

    mark(group, ids)          rows whose contents changed (np.int64 array)
    mark_dead(group, ids)     rows discarded without a surviving copy
    count_written(group, n)   monotone row-write counter (telemetry)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Protocol

import numpy as np
import torch


class WriteObserver(Protocol):
    def mark(self, group: str, ids: np.ndarray) -> None: ...
    def mark_dead(self, group: str, ids: np.ndarray) -> None: ...
    def count_written(self, group: str, n: int) -> None: ...


_observer: WriteObserver | None = None
_scope = threading.local()


def set_observer(obs: WriteObserver | None) -> WriteObserver | None:
    """Install the process-wide observer; returns the previous one."""
    global _observer
    prev = _observer
    _observer = obs
    return prev


def get_observer() -> WriteObserver | None:
    return _observer


@contextlib.contextmanager
def shard_scope(group: str, device: int = 0):
    """Attribute writes inside the block to ``group`` (thread-local)."""
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append((group, device))
    try:
        yield
    finally:
        stack.pop()


def _current() -> tuple[str, int] | None:
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


PAD = -1


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def note_insert(ids, is_new) -> None:
    """After ``lookup_or_insert``: newly admitted ids are dirty."""
    obs, ctx = _observer, _current()
    if obs is None or ctx is None:
        return
    ids_np = _np(ids, np.int64)
    sel = ids_np[_np(is_new, bool) & (ids_np != PAD)]
    if sel.size:
        obs.mark(ctx[0], sel)


def note_remove(ids, moved) -> None:
    """After ``idmap.remove``: rows leaving this shard (the demote path) are
    dirty: their bytes move tiers, so the next delta must carry them."""
    obs, ctx = _observer, _current()
    if obs is None or ctx is None:
        return
    ids_np = _np(ids, np.int64)
    sel = ids_np[_np(moved, bool) & (ids_np != PAD)]
    if sel.size:
        obs.mark(ctx[0], sel)


def note_evict(keys) -> None:
    """After a discarding ``idmap.evict``: rows with no surviving copy,
    recorded as tombstones so recovery does not resurrect them."""
    obs, ctx = _observer, _current()
    if obs is None or ctx is None:
        return
    keys_np = _np(keys, np.int64)
    keys_np = keys_np[keys_np != PAD]
    if keys_np.size:
        obs.mark_dead(ctx[0], keys_np)


def note_rows_written(mask) -> None:
    """After ``blocks.write_rows``: telemetry-only write counter."""
    obs, ctx = _observer, _current()
    if obs is None or ctx is None:
        return
    n = int(_np(mask, bool).sum())
    if n:
        obs.count_written(ctx[0], n)
