"""HostStore — the host-DRAM backing tier of the embedding hierarchy (the
port's own copy of ``repro/storage/host_store.py``, numpy only).

A numpy append/compact row arena keyed by engine id. It holds whole row
records (embedding, every optimizer slot, last-use step) for rows that are
live in the model but not resident on the device. Host DRAM is this tier by
design, not a fallback: its capacity is bounded only by host memory.

Layout: parallel arrays ``ids / emb / slots[k] / last_use``, and an index of
id → arena row. Writes append at the arena top (amortised doubling growth);
removals leave holes that a threshold-triggered ``compact()`` squeezes out,
so the waste stays below ``compact_waste``. Values round-trip bit for bit.

The reference keeps its index as a Python dict and walks ids one at a time;
this copy keeps it as sorted key arrays and does each operation for a whole
id vector at once. Every observable result is the reference's: rows, their
arena positions and export order, ``top``, ``n_dead``, capacity and growth.
"""
from __future__ import annotations

import numpy as np


class HostStore:
    def __init__(
        self,
        dim: int,
        slot_names: tuple[str, ...] = ("m", "v"),
        init_capacity: int = 1024,
        compact_waste: float = 0.5,
    ):
        self.dim = dim
        self.slot_names = tuple(slot_names)
        self.compact_waste = compact_waste
        self._alloc(max(int(init_capacity), 16))
        self._keys = np.zeros((0,), np.int64)  # live engine ids, sorted
        self._rows = np.zeros((0,), np.int64)  # their arena rows
        self.top = 0                           # append cursor
        self.n_dead = 0                        # holes awaiting compaction

    # ------------------------------------------------------------------ arena
    def _alloc(self, cap: int):
        self.ids = np.full((cap,), -1, np.int64)
        self.emb = np.zeros((cap, self.dim), np.float32)
        self.slots = {k: np.zeros((cap, self.dim), np.float32) for k in self.slot_names}
        self.last_use = np.zeros((cap,), np.int32)

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    @property
    def n_rows(self) -> int:
        """Live rows (the metric surfaced as host-resident rows)."""
        return self._keys.size

    @property
    def nbytes(self) -> int:
        per_row = 8 + 4 + 4 * self.dim * (1 + len(self.slot_names))
        return self.capacity * per_row

    def _grow_to(self, need: int):
        old_cap = self.capacity
        cap = old_cap
        while cap < need:
            cap *= 2
        old = (self.ids, self.emb, self.slots, self.last_use)
        self._alloc(cap)
        self.ids[:old_cap] = old[0]
        self.emb[:old_cap] = old[1]
        for k in self.slot_names:
            self.slots[k][:old_cap] = old[2][k]
        self.last_use[:old_cap] = old[3]

    def _index(self, rows: np.ndarray) -> None:
        """Rebuild the index from the arena rows of the live ids."""
        keys = self.ids[rows]
        order = np.argsort(keys, kind="stable")
        self._keys, self._rows = keys[order], rows[order]

    def compact(self):
        """Squeeze out holes: live rows become contiguous [0, n_rows), in
        their append order."""
        live = np.sort(self._rows)
        n = live.size
        self.ids[:n] = self.ids[live]
        self.emb[:n] = self.emb[live]
        for k in self.slot_names:
            self.slots[k][:n] = self.slots[k][live]
        self.last_use[:n] = self.last_use[live]
        self.ids[n:] = -1
        self._index(np.arange(n, dtype=np.int64))
        self.top = n
        self.n_dead = 0

    def _rows_for_append(self, k: int) -> None:
        if self.top + k > self.capacity:
            if self.n_dead >= self.compact_waste * self.capacity:
                self.compact()
            if self.top + k > self.capacity:
                self._grow_to(self.top + k)

    def _rows_of(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Arena row of each id (-1 where absent) and the found mask."""
        n = self._keys.size
        if n == 0:
            return np.full(ids.shape, -1, np.int64), np.zeros(ids.shape, np.bool_)
        pos = np.minimum(np.searchsorted(self._keys, ids), n - 1)
        found = self._keys[pos] == ids
        return np.where(found, self._rows[pos], -1), found

    # ------------------------------------------------------------------- ops
    def contains(self, ids: np.ndarray) -> np.ndarray:
        return self._rows_of(np.asarray(ids, np.int64))[1]

    def put(self, ids, emb, slots, last_use) -> None:
        """Upsert whole rows. Existing ids are overwritten in place; new ids
        append at the arena top, in their order of first appearance."""
        ids = np.asarray(ids, np.int64)
        emb = np.asarray(emb, np.float32)
        last_use = np.broadcast_to(np.asarray(last_use, np.int32), ids.shape)
        # Make room before resolving arena rows: compaction or growth
        # relocates live rows. The room asked for counts every id not yet
        # stored, repeats included, as the reference does.
        n_fresh = int((~self._rows_of(ids)[1]).sum())
        if n_fresh:
            self._rows_for_append(n_fresh)
        rows, found = self._rows_of(ids)
        if n_fresh:
            new, first, inv = np.unique(ids[~found], return_index=True, return_inverse=True)
            rank = np.empty(new.size, np.int64)
            rank[np.argsort(first, kind="stable")] = np.arange(new.size)
            new_rows = self.top + rank
            rows[~found] = new_rows[inv.reshape(-1)]
            self.top += new.size
            at = np.searchsorted(self._keys, new)
            self._keys = np.insert(self._keys, at, new)
            self._rows = np.insert(self._rows, at, new_rows)
        self.ids[rows] = ids
        self.emb[rows] = emb
        for k in self.slot_names:
            self.slots[k][rows] = np.asarray(slots[k], np.float32)
        self.last_use[rows] = last_use

    def get(self, ids) -> tuple[np.ndarray, np.ndarray, dict, np.ndarray]:
        """→ (found_mask, emb, slots, last_use); missing rows are zeros."""
        ids = np.asarray(ids, np.int64)
        rows, found = self._rows_of(ids)
        src = np.where(found, rows, 0)
        emb = np.where(found[:, None], self.emb[src], 0.0)
        slots = {k: np.where(found[:, None], self.slots[k][src], 0.0) for k in self.slot_names}
        last = np.where(found, self.last_use[src], 0)
        return found, emb, slots, last

    def pop(self, ids) -> tuple[np.ndarray, np.ndarray, dict, np.ndarray]:
        """get + remove: promotion is a move (the hierarchy is exclusive: a
        row is resident in exactly one tier)."""
        out = self.get(ids)
        self.remove(ids)
        return out

    def remove(self, ids) -> int:
        uniq = np.unique(np.asarray(ids, np.int64))
        rows, found = self._rows_of(uniq)
        if not found.any():
            return 0
        self.ids[rows[found]] = -1
        n = int(found.sum())
        self.n_dead += n
        keep = ~np.isin(self._keys, uniq[found], assume_unique=True)
        self._keys, self._rows = self._keys[keep], self._rows[keep]
        return n

    # ----------------------------------------------------------- checkpoint
    def export(self) -> dict[str, np.ndarray]:
        """Checkpoint-portable live rows (the engine export's schema), in
        arena order."""
        live = np.sort(self._rows)
        return {
            "ids": self.ids[live].copy(),
            "emb": self.emb[live].copy(),
            "slots": {k: self.slots[k][live].copy() for k in self.slot_names},
            "last_use": self.last_use[live].copy(),
        }

    def clear(self) -> None:
        self._keys = np.zeros((0,), np.int64)
        self._rows = np.zeros((0,), np.int64)
        self.top = 0
        self.n_dead = 0
        self.ids[:] = -1

    def load(self, data) -> None:
        """Replace the contents from an ``export()`` payload."""
        self.clear()
        ids = np.asarray(data["ids"], np.int64)
        if ids.size:
            self.put(ids, data["emb"], {k: data["slots"][k] for k in self.slot_names},
                     data["last_use"])
