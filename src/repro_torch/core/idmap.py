"""IDMap — tier 1 of the Embedding Engine (port of ``repro/core/idmap.py``).

A conflict-free feature-id → row-offset map held as device tensors: open
addressing with linear probing over full 64-bit keys. Ids whose probe chain
is exhausted, or that find no free row, fall back to the reserved overflow
row 0 and are counted.

Insertion keeps the reference's two passes and its per-round scatter-min
claim (the lowest batch rank wins a contested slot), so the port hands out
exactly the reference's slots and offsets; a CAS table would not.

``remove`` (the tiered store's demote) and ``evict`` (stale-row discard
for continuous training) clear slots and push the freed rows onto the free
stack; ``_probe_find`` scans every round, so no tombstone is needed.

Input ids of one call must be unique, apart from PAD (-1) padding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import write_log
from repro_torch.core.feature_engine import splitmix64, umod

PAD = -1
OVERFLOW_ROW = 0  # Blocks row 0 is the reserved collision/overflow bucket

TENSOR_FIELDS = ("keys", "occupied", "offsets", "last_use", "free_stack", "free_size", "next_row")


@dataclasses.dataclass
class IDMap:
    keys: torch.Tensor        # (capacity,) int64
    occupied: torch.Tensor    # (capacity,) bool
    offsets: torch.Tensor     # (capacity,) int32 — row in Blocks
    last_use: torch.Tensor    # (capacity,) int32 — step of last access
    free_stack: torch.Tensor  # (capacity,) int32 — recycled row offsets
    free_size: torch.Tensor   # () int32
    next_row: torch.Tensor    # () int32 — bump allocator (row 0 reserved)
    n_rows: int               # Blocks row capacity
    max_probes: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]

    def n_live(self) -> torch.Tensor:
        return self.occupied.sum(dtype=torch.int32)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "IDMap":
        """Apply ``fn`` to every tensor field (e.g. take one device's shard)."""
        return dataclasses.replace(self, **{f: fn(getattr(self, f)) for f in TENSOR_FIELDS})


def create(capacity: int, n_rows: int, device, max_probes: int = 32) -> IDMap:
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return IDMap(
        keys=zeros((capacity,), torch.int64),
        occupied=zeros((capacity,), torch.bool),
        offsets=zeros((capacity,), torch.int32),
        last_use=zeros((capacity,), torch.int32),
        free_stack=zeros((capacity,), torch.int32),
        free_size=zeros((), torch.int32),
        next_row=torch.ones((), dtype=torch.int32, device=device),
        n_rows=n_rows,
        max_probes=max_probes,
    )


def _home(ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Home slot: splitmix64(id) % capacity, with the hash read as uint64."""
    return umod(splitmix64(ids), capacity).to(torch.int32)


def _probe_find(keys: torch.Tensor, occupied: torch.Tensor, ids: torch.Tensor,
                home: torch.Tensor, max_probes: int) -> torch.Tensor:
    """Slot of each id along its full probe chain, -1 when absent. Probes all
    ``max_probes`` rounds, so a cleared mid-chain slot cannot hide a key."""
    cap = keys.shape[0]
    active = ids != PAD
    found = torch.full(ids.shape, -1, dtype=torch.int32, device=ids.device)
    for r in range(max_probes):
        slot = (home + r) % cap
        hit = active & (found < 0) & occupied[slot] & (keys[slot] == ids)
        found = torch.where(hit, slot, found)
    return found


def lookup(m: IDMap, ids: torch.Tensor) -> torch.Tensor:
    """Probe only. Returns int32 row offsets; missing/pad ids → OVERFLOW_ROW."""
    found = _probe_find(m.keys, m.occupied, ids, _home(ids, m.capacity), m.max_probes)
    return torch.where(found >= 0, m.offsets[found.clamp(min=0)], OVERFLOW_ROW)


def _with_dump(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with one extra trailing element: masked-off writes are
    sent there (index == capacity), the reference's ``mode="drop"``."""
    return torch.cat([x, x[:1]])


def lookup_or_insert(
    m: IDMap, ids: torch.Tensor, step: torch.Tensor | int
) -> tuple[IDMap, torch.Tensor, torch.Tensor, dict]:
    """Probe and insert. Returns (new_map, offsets, is_new, metrics).

    ids: (n,) int64, unique up to PAD(-1). ``step`` is a scalar or an (n,)
    vector of per-id last-use steps. offsets: (n,) int32 rows in Blocks
    (OVERFLOW_ROW on probe or row-capacity exhaustion, and for PAD).
    """
    cap = m.capacity
    n = ids.shape[0]
    dev = ids.device
    home = _home(ids, cap)
    active = ids != PAD
    rank = torch.arange(n, dtype=torch.int32, device=dev)

    # Pass 1: find existing keys along the full probe chain.
    found = _probe_find(m.keys, m.occupied, ids, home, m.max_probes)

    # Pass 2: only genuinely missing ids claim empty slots, by a scatter-min
    # of batch rank per round.
    inserting = active & (found < 0)
    keys, occ = _with_dump(m.keys), _with_dump(m.occupied)
    for r in range(m.max_probes):
        slot = (home + r) % cap
        want = inserting & (found < 0) & ~occ[slot]
        claims = torch.full((cap,), n, dtype=torch.int32, device=dev)
        claims.scatter_reduce_(0, slot.long(), torch.where(want, rank, n), "amin")
        won = want & (claims[slot] == rank)
        wslot = torch.where(won, slot, cap).long()
        keys.index_put_((wslot,), ids)
        occ.index_put_((wslot,), won)
        found = torch.where(won, slot, found)
    keys, occ = keys[:cap], occ[:cap]
    is_new = inserting & (found >= 0)

    # Allocate rows for the winners: recycled offsets first, then bump.
    new_rank = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    n_inserted = is_new.sum(dtype=torch.int32)
    from_stack = new_rank < m.free_size
    stack_idx = (m.free_size - 1 - new_rank).clamp(0, cap - 1)
    bumped = m.next_row + (new_rank - m.free_size)
    row = torch.where(from_stack, m.free_stack[stack_idx], bumped)
    row_ok = row < m.n_rows
    row = torch.where(is_new & row_ok, row, OVERFLOW_ROW).to(torch.int32)

    taken_from_stack = torch.minimum(n_inserted, m.free_size)
    free_size = m.free_size - taken_from_stack
    next_row = torch.clamp(m.next_row + (n_inserted - taken_from_stack).clamp(min=0),
                           max=m.n_rows).to(torch.int32)

    offsets = _with_dump(m.offsets)
    offsets.index_put_((torch.where(is_new, found, cap).long(),), row)
    offsets = offsets[:cap]
    step_v = torch.as_tensor(step, device=dev).to(torch.int32).expand(n)
    last_use = _with_dump(m.last_use)
    last_use.index_put_((torch.where(found >= 0, found, cap).long(),), step_v)
    last_use = last_use[:cap]

    out_off = torch.where(found >= 0, offsets[found.clamp(min=0)], OVERFLOW_ROW)
    metrics = {
        "idmap_inserted": n_inserted,
        "idmap_probe_overflow": (active & (found < 0)).sum(dtype=torch.int32),
        "idmap_row_overflow": (is_new & ~row_ok).sum(dtype=torch.int32),
    }
    new_m = IDMap(
        keys=keys, occupied=occ, offsets=offsets, last_use=last_use,
        free_stack=m.free_stack, free_size=free_size, next_row=next_row,
        n_rows=m.n_rows, max_probes=m.max_probes,
    )
    is_new = is_new & row_ok
    write_log.note_insert(ids, is_new)
    return new_m, out_off, is_new, metrics


def _push_free(m: IDMap, freed: torch.Tensor, offs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The free stack and its size after pushing ``offs`` where ``freed``,
    in cumsum order; pushes past the capacity are dropped and the size is
    clamped to it."""
    cap = m.capacity
    dst = m.free_size + torch.cumsum(freed, 0, dtype=torch.int32) - 1
    dst = torch.where(freed & (dst < cap), dst, cap).long()
    free_stack = _with_dump(m.free_stack)
    free_stack.index_put_((dst,), offs.to(torch.int32))
    n_freed = freed.sum(dtype=torch.int32)
    return free_stack[:cap], torch.clamp(m.free_size + n_freed, max=cap).to(torch.int32)


def remove(m: IDMap, ids: torch.Tensor) -> tuple[IDMap, torch.Tensor, torch.Tensor]:
    """Remove specific ids; their rows are recycled through the free stack.

    The demotion primitive of the tiered store: the caller gathers the rows
    at the returned offsets before they are reused. Returns (new_map,
    offsets, freeable): offsets of missing, PAD and overflow-row ids are
    OVERFLOW_ROW, which never enters the free stack. ids must be unique up
    to PAD.
    """
    cap = m.capacity
    found = _probe_find(m.keys, m.occupied, ids, _home(ids, cap), m.max_probes)
    found_mask = found >= 0
    offs = m.offsets[found.clamp(min=0)]
    occupied = _with_dump(m.occupied)
    occupied.index_put_((torch.where(found_mask, found, cap).long(),), torch.zeros((), dtype=torch.bool,
                                                                                   device=ids.device))
    freeable = found_mask & (offs != OVERFLOW_ROW)
    free_stack, free_size = _push_free(m, freeable, offs)
    new_m = dataclasses.replace(m, occupied=occupied[:cap], free_stack=free_stack, free_size=free_size)
    write_log.note_remove(ids, found_mask)
    return new_m, torch.where(freeable, offs, OVERFLOW_ROW), freeable


def evict(m: IDMap, older_than: torch.Tensor | int) -> tuple[IDMap, torch.Tensor]:
    """Free every row whose last access predates ``older_than``: the slot
    is cleared and its row pushed onto the free stack, the paper's
    stale-feature eviction for continuous training. Returns (new_map,
    n_evicted).

    A slot whose insert found no row holds OVERFLOW_ROW; it is cleared and
    counted, but row 0 is not pushed (the reference pushes it: ROADMAP §C).
    """
    stale = m.occupied & (m.last_use < torch.as_tensor(older_than, device=m.last_use.device).to(torch.int32))
    if write_log.get_observer() is not None:
        # a discarding evict: no surviving copy, a tombstone for recovery
        write_log.note_evict(m.keys[stale])
    free_stack, free_size = _push_free(m, stale & (m.offsets != OVERFLOW_ROW), m.offsets)
    new_m = dataclasses.replace(m, occupied=m.occupied & ~stale, free_stack=free_stack, free_size=free_size)
    return new_m, stale.sum(dtype=torch.int32)
