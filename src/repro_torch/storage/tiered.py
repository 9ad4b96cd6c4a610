"""TieredEmbeddingStore — coordinator of the two-tier embedding hierarchy
(port of ``repro/storage/tiered.py``).

The device tier (IDMap + Blocks on the cell's device) is a cache over a
host-DRAM ``HostStore``. The hierarchy is exclusive: a row is resident in
exactly one tier, and a move carries the whole record (embedding, optimizer
slots, last-use step), so a demote and a promote round-trip bit for bit and
training matches an all-device run: capacity pressure costs cache misses,
not the overflow row.

Rows move at step edges, on the stacked ``[D, ...]`` state:

  prefetch   (before the step) — classify this step's engine ids per owner
             shard into hits, host-resident misses and fresh ids; under
             capacity pressure demote policy-chosen victims device → host;
             then promote host rows → device, so the step's insert finds
             every id resident.
  post_step  (after the step) — admission: ids that entered the device
             tier this step but fail ``CachePolicy.admit`` are demoted with
             their freshly updated rows.
  evict_stale — the staleness pass: stale rows spill device → host
             instead of being discarded.

A demote reads the rows through the gather kernel (emb, m and v: three
launches) and zeroes them through the scatter-set kernel (three); a promote
writes them through the scatter-set kernel (three). The device tier is
written in place, through views of the stacked state: a move copies the
moved rows and one shard's IDMap fields, never a whole tier.

The store keeps host-side mirrors of device residency (id → last use, per
shard) and of lifetime access counts (per group). The reference keeps them
as Python dicts; this port keeps each as sorted numpy key arrays with the
key's insertion sequence beside it (``_IdTable``), which gives the dicts'
iteration order. So the policies see their candidates in the reference's
order and break ties as it does, and every counter is the reference's.
The reference pads id vectors to a power of two to bound XLA recompiles;
the port has no compiles and passes them as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import blocks as blocks_lib
from repro_torch.core import idmap as idmap_lib
from repro_torch.core import write_log
from repro_torch.core.exchange import _owner_of
from repro_torch.storage.host_store import HostStore
from repro_torch.storage.policies import CachePolicy, make_policy

PAD = -1
_COUNTERS = ("lookups", "hits", "promoted", "demoted", "fresh",
             "admission_demoted", "spilled_stale", "unplaceable")


@dataclasses.dataclass(frozen=True)
class StorageConfig:
    """EngineConfig.storage knobs (presence turns the tiered store on)."""

    policy: str = "lru"          # "lru" | "lfu" | "freq:<N>[:<base>]"
    spill_slack: int = 0         # extra victims per pressure event (hysteresis)
    host_init_capacity: int = 1024
    compact_waste: float = 0.5   # HostStore hole fraction that triggers compact


class _IdTable:
    """A dict of int64 id → int64 value, for whole id vectors at once: the
    keys sorted, with each key's insertion sequence, so ``in_order`` gives
    the dict's iteration order (a key removed and set again goes last)."""

    def __init__(self):
        self.keys = np.zeros((0,), np.int64)
        self.vals = np.zeros((0,), np.int64)
        self.seq = np.zeros((0,), np.int64)
        self._next = 0

    def __len__(self) -> int:
        return self.keys.size

    def find(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Position of each id among the keys, and whether it is there."""
        n = self.keys.size
        if n == 0:
            return np.zeros(ids.shape, np.int64), np.zeros(ids.shape, np.bool_)
        pos = np.minimum(np.searchsorted(self.keys, ids), n - 1)
        return pos, self.keys[pos] == ids

    def get(self, ids: np.ndarray, default: int) -> np.ndarray:
        pos, hit = self.find(ids)
        return np.where(hit, self.vals[pos] if self.keys.size else default, default)

    def set(self, ids: np.ndarray, vals) -> None:
        """d[i] = v for unique ``ids`` in their order: present keys keep
        their place, new keys go last, in the order given."""
        vals = np.broadcast_to(np.asarray(vals, np.int64), ids.shape)
        pos, hit = self.find(ids)
        self.vals[pos[hit]] = vals[hit]
        new, new_vals = ids[~hit], vals[~hit]
        if new.size:
            seq = self._next + np.arange(new.size, dtype=np.int64)
            self._next += new.size
            order = np.argsort(new, kind="stable")
            at = np.searchsorted(self.keys, new[order])
            self.keys = np.insert(self.keys, at, new[order])
            self.vals = np.insert(self.vals, at, new_vals[order])
            self.seq = np.insert(self.seq, at, seq[order])

    def add(self, ids: np.ndarray, n: int = 1) -> None:
        """d[i] = d.get(i, 0) + n for unique ``ids`` in their order."""
        self.set(ids, self.get(ids, 0) + n)

    def setdefault(self, ids: np.ndarray, val: int) -> None:
        """d.setdefault(i, val) for unique ``ids`` in their order."""
        self.set(ids[~self.find(ids)[1]], val)

    def remove(self, ids: np.ndarray) -> None:
        pos, hit = self.find(ids)
        if hit.any():
            keep = np.ones(self.keys.size, np.bool_)
            keep[pos[hit]] = False
            self.keys, self.vals, self.seq = self.keys[keep], self.vals[keep], self.seq[keep]

    def in_order(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys, values) in the dict's iteration order."""
        order = np.argsort(self.seq, kind="stable")
        return self.keys[order], self.vals[order]

    @classmethod
    def of(cls, ids: np.ndarray, vals) -> "_IdTable":
        """The dict {i: v for i, v in zip(ids, vals)} of unique ``ids``."""
        t = cls()
        t.set(np.asarray(ids, np.int64), vals)
        return t


class _ShardView:
    """One shard's (idmap, blocks) view of the stacked [D, ...] state. The
    Blocks views are written in place by the row ops; ``flush`` copies the
    new IDMap fields into the shard's slice of the stacked tensors."""

    def __init__(self, state_g: dict, d: int, device: torch.device):
        on = state_g["blocks"].emb.device
        if on.type != device.type or device.index not in (None, on.index):
            raise ValueError(f"tiered store on {device}: the engine state is on {on}")
        self.state_g = state_g
        self.d = d
        self.m = None
        self.b = None
        self.dirty = False

    def get(self):
        if self.m is None:
            self.m = self.state_g["idmap"].map(lambda x: x[self.d])
            self.b = self.state_g["blocks"].map(lambda x: x[self.d])
        return self.m, self.b

    def put(self, m: idmap_lib.IDMap):
        self.m = m
        self.dirty = True

    def flush(self) -> dict:
        if self.dirty:
            stacked = self.state_g["idmap"]
            for f in idmap_lib.TENSOR_FIELDS:
                dst, src = getattr(stacked, f)[self.d], getattr(self.m, f)
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        return self.state_g


class TieredEmbeddingStore:
    def __init__(
        self,
        group_shapes: Mapping[str, tuple[int, int]],  # key -> (dim, rows_per_shard)
        n_devices: int,
        cfg: StorageConfig,
        device,
        slot_names: tuple[str, ...] = ("m", "v"),
        registry: obs.MetricsRegistry | None = None,
    ):
        self.cfg = cfg
        self.D = n_devices
        self.device = torch.device(device)
        self.slot_names = tuple(slot_names)
        self.policy: CachePolicy = make_policy(cfg.policy)
        self.rows_per_shard = {g: r for g, (_, r) in group_shapes.items()}
        self.host: dict[str, HostStore] = {
            g: HostStore(dim, self.slot_names, cfg.host_init_capacity, cfg.compact_waste)
            for g, (dim, _) in group_shapes.items()
        }
        # host-side mirrors of device residency (id → last use) and of
        # lifetime access frequency (id → count)
        self.resident: dict[str, list[_IdTable]] = {
            g: [_IdTable() for _ in range(n_devices)] for g in group_shapes}
        self.counts: dict[str, _IdTable] = {g: _IdTable() for g in group_shapes}
        self._pending: dict[str, list[list[np.ndarray]]] = {
            g: [[] for _ in range(n_devices)] for g in group_shapes}
        self.totals = {k: 0 for k in _COUNTERS}
        # counters and gauges under the ``storage/`` namespace, shared with
        # the Trainer's registry
        reg = registry if registry is not None else obs.get_registry()
        self._reg = reg
        self._obs_counters = {k: reg.counter(f"storage/{k}") for k in _COUNTERS}
        # per-shard series (storage/<k>/shard<d>), created on first increment
        self._shard_counters: dict[tuple[str, int], obs.Counter] = {}
        self._g_host = reg.gauge("storage/host_rows")
        self._g_device = reg.gauge("storage/device_rows")
        self._g_hit = reg.gauge("storage/hit_rate")
        # an optional dirty-row tracker: prefetch marks every batch id dirty
        # (the step will update those rows); tier moves mark through the
        # write_log seam inside shard_scope below
        self.dirty = None

    # --------------------------------------------------------------- helpers
    def _owner_np(self, ids: np.ndarray) -> np.ndarray:
        if self.D == 1:
            return np.zeros(ids.shape, np.int32)
        return _owner_of(torch.from_numpy(ids), self.D).numpy()

    def device_resident(self, g: str | None = None) -> int:
        keys = [g] if g else list(self.resident)
        return sum(len(r) for k in keys for r in self.resident[k])

    def host_rows(self, g: str | None = None) -> int:
        keys = [g] if g else list(self.host)
        return sum(self.host[k].n_rows for k in keys)

    def _bump(self, met: dict, key: str, d: int, n: int):
        """Count an event in the step's metrics and the shard's counter."""
        met[key] += n
        if not n:
            return
        c = self._shard_counters.get((key, d))
        if c is None:
            c = self._reg.counter(f"storage/{key}", shard=d)
            self._shard_counters[(key, d)] = c
        c.inc(n)

    def _metrics(self, step_counts: dict, keys: tuple[str, ...]) -> dict:
        """Fold counters into lifetime totals; report this pass's ``keys``
        and the occupancy gauges."""
        for k, v in step_counts.items():
            self.totals[k] += v
            if v:
                self._obs_counters[k].inc(v)
        m = {k: step_counts[k] for k in keys}
        if "lookups" in keys:
            m["hit_rate"] = (step_counts["hits"] / step_counts["lookups"]
                             if step_counts["lookups"] else 1.0)
            self._g_hit.set(m["hit_rate"])
        m["host_rows"] = self.host_rows()
        m["device_rows"] = self.device_resident()
        self._g_host.set(m["host_rows"])
        self._g_device.set(m["device_rows"])
        return m

    # ------------------------------------------------------- tier movement
    def _demote(self, g: str, sv: _ShardView, victim_ids: np.ndarray, res: _IdTable) -> int:
        """Move rows device → host (spill), with their slots."""
        m, b = sv.get()
        with write_log.shard_scope(g, sv.d):
            m2, offs, found = idmap_lib.remove(m, torch.from_numpy(victim_ids).to(self.device))
        emb, slots = blocks_lib.gather_with_slots(b, offs)
        blocks_lib.clear_rows(b, offs, found)
        sv.put(m2)
        found_np = found.cpu().numpy()
        sel = victim_ids[found_np]
        if sel.size:
            lu = res.get(sel, 0).astype(np.int32)
            keep = found.nonzero().squeeze(1)  # selected on the device: one host copy a tensor
            rows = {k: v[keep].cpu().numpy() for k, v in {"emb": emb, **slots}.items()}
            self.host[g].put(sel, rows.pop("emb"), rows, lu)
        res.remove(victim_ids)
        return int(sel.size)

    def _promote(self, g: str, sv: _ShardView, ids: np.ndarray, step: int) -> np.ndarray:
        """Move rows host → device (fill): insert the ids, write their whole
        records. Returns the ids that landed (probe exhaustion can reject an
        insert); the rest stay host-resident."""
        m, b = sv.get()
        with write_log.shard_scope(g, sv.d):
            m2, offs, _is_new, _ = idmap_lib.lookup_or_insert(
                m, torch.from_numpy(ids).to(self.device), step)
            found, emb, slots, _lu = self.host[g].get(ids)
            ok = found & (offs.cpu().numpy() != idmap_lib.OVERFLOW_ROW)

            def dev(x: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

            blocks_lib.write_rows(b, offs, dev(emb), {k: dev(v) for k, v in slots.items()}, dev(ok))
        sv.put(m2)
        landed = ids[ok]
        self.host[g].remove(landed)  # the hierarchy is exclusive: a promotion is a move
        return landed

    # ------------------------------------------------------------ step edges
    def prefetch(self, state: dict, eng_ids: Mapping[str, np.ndarray], step: int) -> tuple[dict, dict]:
        """The fill pass, just before the step.

        ``eng_ids`` is {group: salted engine-id vector}, the ids
        ``fetch_local`` will see (PAD and repeats allowed). Returns
        (state, metrics); the state's tensors are updated in place."""
        met = {k: 0 for k in _COUNTERS}
        new_state = dict(state)
        for g, raw in eng_ids.items():
            if g not in self.host:
                continue
            ids = np.unique(np.asarray(raw, np.int64))
            ids = ids[ids != PAD]
            if not ids.size:
                continue
            owner = self._owner_np(ids)
            cap = self.rows_per_shard[g] - 1  # row 0 reserved (overflow)
            state_g = new_state[g]
            for d in range(self.D):
                sids = ids[owner == d] if self.D > 1 else ids
                if not sids.size:
                    continue
                res = self.resident[g][d]
                counts = self.counts[g]
                counts.add(sids)
                in_res = res.find(sids)[1]
                miss = sids[~in_res]
                self._bump(met, "lookups", d, int(sids.size))
                self._bump(met, "hits", d, int(sids.size - miss.size))
                if self.dirty is not None:
                    self.dirty.mark(g, sids)
                sv = _ShardView(state_g, d, self.device)
                placeable = miss
                if miss.size:
                    free = cap - len(res)
                    if miss.size > free:
                        want = miss.size - free + self.cfg.spill_slack
                        keys, lus = res.in_order()
                        out = ~np.isin(keys, sids, assume_unique=True)
                        cand = keys[out]
                        k = min(want, cand.size)
                        if k > 0:
                            victims = self.policy.select_victims(
                                cand, lus[out].astype(np.int32), counts.get(cand, 0), k)
                            self._bump(met, "demoted", d, self._demote(g, sv, victims, res))
                        free = cap - len(res)
                        if miss.size > free:  # every victim was protected
                            self._bump(met, "unplaceable", d, int(miss.size - free))
                            placeable = miss[:free]
                    promo = placeable[self.host[g].contains(placeable)]
                    self._bump(met, "fresh", d, int(placeable.size - promo.size))
                    if promo.size:
                        landed = self._promote(g, sv, promo, step)
                        self._bump(met, "promoted", d, int(landed.size))
                        stranded = np.setdiff1d(promo, landed)
                        if stranded.size:  # probe exhaustion: stayed on the host
                            self._bump(met, "unplaceable", d, int(stranded.size))
                            placeable = placeable[~np.isin(placeable, stranded)]
                    self._pending[g][d].append(placeable)
                res.set(placeable, step)
                res.set(sids[in_res], step)
                state_g = sv.flush()
            new_state[g] = state_g
        return new_state, self._metrics(
            met, ("lookups", "hits", "promoted", "demoted", "fresh", "unplaceable"))

    def post_step(self, state: dict, step: int) -> tuple[dict, dict]:
        """The admission pass, just after the step: ids that entered the
        device tier this step but are not admitted by the policy spill back
        to the host with their updated rows."""
        met = {k: 0 for k in _COUNTERS}
        new_state = dict(state)
        for g in self._pending:
            state_g = new_state[g]
            for d in range(self.D):
                pend = self._pending[g][d]
                self._pending[g][d] = []
                ids = np.concatenate(pend) if pend else np.zeros((0,), np.int64)
                if not ids.size:
                    continue
                keep = self.policy.admit(self.counts[g].get(ids, 0))
                rejected = ids[~keep]
                if rejected.size:
                    sv = _ShardView(state_g, d, self.device)
                    n = self._demote(g, sv, rejected, self.resident[g][d])
                    self._bump(met, "admission_demoted", d, n)
                    state_g = sv.flush()
            new_state[g] = state_g
        return new_state, self._metrics(met, ("admission_demoted",))

    def evict_stale(self, state: dict, older_than: int) -> tuple[dict, dict]:
        """The staleness pass: rows idle since before ``older_than`` spill
        device → host (instead of the untiered discard)."""
        met = {k: 0 for k in _COUNTERS}
        new_state = dict(state)
        for g in self.resident:
            state_g = new_state[g]
            for d in range(self.D):
                res = self.resident[g][d]
                keys, lus = res.in_order()
                stale = keys[lus < older_than]
                if not stale.size:
                    continue
                sv = _ShardView(state_g, d, self.device)
                self._bump(met, "spilled_stale", d, self._demote(g, sv, stale, res))
                state_g = sv.flush()
            new_state[g] = state_g
        return new_state, self._metrics(met, ("spilled_stale",))

    # ------------------------------------------------------------ recovery
    def load_counts(self, g: str, ids: np.ndarray, counts: np.ndarray) -> None:
        """Replace group ``g``'s access counts (after an import)."""
        self.counts[g] = _IdTable.of(ids, counts)

    def sync_from_state(self, state: dict, step_hint: int | None = None):
        """Rebuild the residency mirror from the device idmaps (after a
        restore or an import). Counts of ids not seen before default to 1."""
        for g in self.resident:
            m = state[g]["idmap"].map(lambda x: x.cpu().numpy())
            for d in range(self.D):
                occ = m.occupied[d] & (m.offsets[d] != idmap_lib.OVERFLOW_ROW)
                keys = m.keys[d][occ]
                lu = m.last_use[d][occ] if step_hint is None else step_hint
                self.resident[g][d] = _IdTable.of(keys, lu)
                self.counts[g].setdefault(keys, 1)
                self._pending[g][d] = []

    # ---------------------------------------------------------- checkpoint
    def checkpoint_payload(self) -> dict[str, np.ndarray]:
        """Flat {name: array} snapshot of the host tier and the frequency
        counts (saved through the saver's extra-tensor file)."""
        out = {}
        for g, host in self.host.items():
            data = host.export()
            out[f"{g}/host/ids"] = data["ids"]
            out[f"{g}/host/emb"] = data["emb"]
            out[f"{g}/host/last_use"] = data["last_use"]
            for k, v in data["slots"].items():
                out[f"{g}/host/slots/{k}"] = v
            cid, cval = self.counts[g].in_order()
            out[f"{g}/counts/ids"] = cid
            out[f"{g}/counts/vals"] = cval
        return out

    def restore_payload(self, flat: Mapping[str, np.ndarray] | None):
        if not flat:
            return
        for g, host in self.host.items():
            if f"{g}/host/ids" not in flat:
                continue
            host.load({
                "ids": flat[f"{g}/host/ids"],
                "emb": flat[f"{g}/host/emb"],
                "last_use": flat[f"{g}/host/last_use"],
                "slots": {k: flat[f"{g}/host/slots/{k}"] for k in self.slot_names},
            })
            self.load_counts(g, flat[f"{g}/counts/ids"], flat[f"{g}/counts/vals"])
