"""Pluggable admission / eviction policies for the HBM hot-row cache (the
port's own copy of ``repro/storage/policies.py``, numpy only).

A ``CachePolicy`` answers two questions about device-tier residency
(DESIGN.md §4):

  * ``select_victims`` — under capacity pressure, WHICH resident rows are
    demoted to the host tier. Candidates never include rows the current
    step needs (they are protected by the coordinator).
  * ``admit`` — may a row REMAIN resident after the step that touched it?
    Admission filters keep one-off ids (the long zipf tail) from churning
    HBM: a first-time id is still trained — promoted for the step, demoted
    right after — so admission affects traffic, never model quality.

Policies see three numpy vectors aligned with the candidate ids:
``last_use`` (step of most recent access) and ``counts`` (lifetime access
frequency). Shapes of the decision space follow cached-embedding systems
like torchrec's UVM-caching kernels and its DistanceLFU eviction policy;
the implementations here are independent.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class CachePolicy(Protocol):
    name: str

    def admit(self, counts: np.ndarray) -> np.ndarray:
        """Per-id bool: may stay device-resident after the current step."""
        ...

    def select_victims(self, ids: np.ndarray, last_use: np.ndarray,
                       counts: np.ndarray, k: int) -> np.ndarray:
        """Pick ≤ k victim ids to demote, most-evictable first."""
        ...


class LRUPolicy:
    """Evict least-recently-used; admit everything."""

    name = "lru"

    def admit(self, counts: np.ndarray) -> np.ndarray:
        return np.ones(counts.shape, np.bool_)

    def select_victims(self, ids, last_use, counts, k):
        order = np.argsort(last_use, kind="stable")
        return ids[order[:k]]


class LFUPolicy:
    """Evict least-frequently-used; recency breaks ties; admit everything."""

    name = "lfu"

    def admit(self, counts: np.ndarray) -> np.ndarray:
        return np.ones(counts.shape, np.bool_)

    def select_victims(self, ids, last_use, counts, k):
        order = np.lexsort((last_use, counts))  # counts primary, LRU tiebreak
        return ids[order[:k]]


class FrequencyAdmissionPolicy:
    """Admission-filtered cache: an id must be seen ``min_count_to_admit``
    times before it may KEEP a device row; victim selection delegates to a
    base policy (default LRU)."""

    def __init__(self, min_count_to_admit: int = 2,
                 base: CachePolicy | None = None):
        assert min_count_to_admit >= 1
        self.min_count_to_admit = min_count_to_admit
        self.base = base if base is not None else LRUPolicy()
        self.name = f"freq{min_count_to_admit}+{self.base.name}"

    def admit(self, counts: np.ndarray) -> np.ndarray:
        return np.asarray(counts) >= self.min_count_to_admit

    def select_victims(self, ids, last_use, counts, k):
        return self.base.select_victims(ids, last_use, counts, k)


def make_policy(spec: str) -> CachePolicy:
    """Parse a policy spec string: ``lru`` | ``lfu`` | ``freq:<N>`` |
    ``freq:<N>:<base>`` (e.g. ``freq:2:lfu``)."""
    parts = spec.lower().split(":")
    if parts[0] == "lru":
        return LRUPolicy()
    if parts[0] == "lfu":
        return LFUPolicy()
    if parts[0] == "freq":
        n = int(parts[1]) if len(parts) > 1 else 2
        base = make_policy(parts[2]) if len(parts) > 2 else LRUPolicy()
        return FrequencyAdmissionPolicy(n, base)
    raise ValueError(f"unknown cache policy {spec!r}")
