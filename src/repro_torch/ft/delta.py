"""Incremental (base + delta) checkpoint frames (port of
``repro/ft/delta.py``, DESIGN.md §13).

A **frame** is one safetensors file of embedding rows in the engine's
``export_rows`` schema, flattened to ``<group>/ids``, ``<group>/emb``,
``<group>/slots/<k>``, ``<group>/last_use`` (+ ``<group>/counts`` for
tiered engines), sharded contiguously over ``n_shards`` files. Shard 0
additionally carries the dense (non-embedding) training state under
``__dense__/<leaf-path>`` and per-group tombstones under
``<group>/dead``; dense state is small next to the sparse tables, so it
rides every frame in full and recovery just takes the newest copy.

A **base** frame holds every live row; a **delta** frame holds only the
rows the :class:`~repro_torch.ft.dirty.DirtyTracker` marked since the
previous save. :class:`DeltaCheckpointer` decides which to write:

  * no committed chain yet                       → base
  * chain depth would exceed ``max_chain_depth`` → base (compaction)
  * interval dirty fraction ≥ threshold          → base (a delta would
    approach full-snapshot cost anyway)
  * otherwise                                    → delta

Row payloads are read through ``export_rows`` / :func:`export_rows_subset`,
which union the device and host tiers, so what lands in a frame is
tier-independent, and recovery (``ft/recovery.py``) can re-shard it onto
any device count via ``engine.import_rows``.

The dense part of a frame is the cell's ``state_tree`` of the non-sparse
state (the reference's layout and key paths), so a chain either package
writes recovers in the other, and the same rows, marks and dense state give
byte-identical frames. A delta reads its rows on the device: the dirty
slots are selected there and only their rows (read by the gather kernel)
are copied to the host, where the reference copies whole tables.
"""
from __future__ import annotations

import pathlib
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import saver as saver_lib
from repro_torch.core import blocks as blocks_lib
from repro_torch.core import idmap as idmap_lib
from repro_torch.ft import manifest as manifest_lib
from repro_torch.ft import recovery as recovery_lib
from repro_torch.ft.dirty import DirtyInterval, DirtyTracker
from repro_torch.ft.manifest import FileIO, Manifest


def flatten_tree(tree: Any) -> dict[str, np.ndarray]:
    """Path-keyed flat view of host copies (the full-snapshot saver's key
    scheme, which is the reference's)."""
    return saver_lib._flatten(tree)


def unflatten_like(like: Any, flat: Mapping[str, np.ndarray]) -> Any:
    """Rebuild ``like``'s structure from a :func:`flatten_tree` dict: numpy
    leaves of the ``like`` leaves' dtypes and shapes."""
    leaves = {}
    for key, leaf in saver_lib._leaves_with_path(like):
        val = flat.get(key)
        assert val is not None, f"checkpoint frame missing dense leaf {key}"
        shape, dtype = saver_lib._shape_dtype(leaf)
        leaves[key] = np.asarray(val).astype(dtype).reshape(shape)
    return saver_lib._unflatten(like, leaves)


def _live(m: idmap_lib.IDMap) -> torch.Tensor:
    return m.occupied & (m.offsets != idmap_lib.OVERFLOW_ROW)


def live_row_count(engine, state) -> int:
    """Live rows across both tiers (denominator of the dirty fraction)."""
    total = sum(int(_live(state[key]["idmap"]).sum()) for key in engine.groups)
    if engine.storage is not None:
        total += engine.storage.host_rows()
    return total


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def export_rows_subset(engine, state, wanted: Mapping[str, np.ndarray]) -> dict:
    """``engine.export_rows`` restricted to ``wanted`` ids per group: the
    delta-frame read. Ids found in neither tier are skipped (they died this
    interval; the tracker reports them as tombstones). Rows come in the
    reference's order: each device shard's in slot order, then the host
    tier's in ``wanted`` order."""
    out = {}
    for key in engine.groups:
        w = np.asarray(wanted.get(key, np.zeros(0, np.int64)), np.int64)
        m, b = state[key]["idmap"], state[key]["blocks"]
        w_dev = torch.from_numpy(w).to(m.keys.device)
        ids, emb, slots, last = [], [], {k: [] for k in b.slots}, []
        for d in range(m.keys.shape[0]):
            occ = _live(m.map(lambda x: x[d]))
            occ = occ & torch.isin(m.keys[d], w_dev) if w.size else torch.zeros_like(occ)
            sel = torch.nonzero(occ).squeeze(1)
            e, s = blocks_lib.gather_with_slots(b.map(lambda x: x[d]), m.offsets[d][sel])
            ids.append(_host(m.keys[d][sel]))
            emb.append(_host(e))
            for sk in b.slots:
                slots[sk].append(_host(s[sk]))
            last.append(_host(m.last_use[d][sel]))
        if engine.storage is not None and w.size:
            rest = w[~np.isin(w, np.concatenate(ids))]
            found, h_emb, h_slots, h_lu = engine.storage.host[key].get(rest)
            ids.append(rest[found])
            emb.append(h_emb[found])
            for sk in b.slots:
                slots[sk].append(h_slots[sk][found])
            last.append(h_lu[found])
        out[key] = {
            "ids": np.concatenate(ids),
            "emb": np.concatenate(emb),
            "slots": {k: np.concatenate(v) for k, v in slots.items()},
            "last_use": np.concatenate(last),
        }
        if engine.storage is not None:
            out[key]["counts"] = engine.storage.counts[key].get(out[key]["ids"], 1)
    return out


def _pack_shard(rows: Mapping[str, Mapping], dead: Mapping[str, np.ndarray],
                dense_flat: Mapping[str, np.ndarray], si: int, n_shards: int
                ) -> dict[str, np.ndarray]:
    """Frame shard ``si``: a contiguous row-range of every group, plus
    (shard 0 only) the dense state and the tombstones."""
    tensors: dict[str, np.ndarray] = {}
    for g, data in rows.items():
        n = data["ids"].shape[0]
        lo, hi = si * n // n_shards, (si + 1) * n // n_shards
        tensors[f"{g}/ids"] = data["ids"][lo:hi]
        tensors[f"{g}/emb"] = data["emb"][lo:hi]
        for sk, v in data["slots"].items():
            tensors[f"{g}/slots/{sk}"] = v[lo:hi]
        tensors[f"{g}/last_use"] = data["last_use"][lo:hi]
        if "counts" in data:
            tensors[f"{g}/counts"] = data["counts"][lo:hi]
    if si == 0:
        for g, ids in dead.items():
            if ids.size:
                tensors[f"{g}/dead"] = np.asarray(ids, np.int64)
        for k, v in dense_flat.items():
            tensors[f"__dense__/{k}"] = v
    return tensors


class DeltaCheckpointer:
    """Trainer-facing incremental checkpointer (the delta-mode counterpart
    of ``checkpoint.AsyncSaver``). Saves are synchronous: a delta frame is
    small by construction, and the manifest commit must be ordered with
    respect to the tracker drain.

    ``state_tree(rest)`` maps the non-sparse part of the train state to the
    tree a frame holds, and ``load_state_tree(rest_like, tree)`` loads such
    a tree back (a cell's pair; None: the state is that tree already)."""

    def __init__(self, directory, engine, tracker: DirtyTracker, *,
                 sparse_key: str | None = "sparse", n_shards: int = 2,
                 max_chain_depth: int = 8,
                 compact_dirty_fraction: float = 0.5,
                 keep_chains: int = 2,
                 registry: obs.MetricsRegistry | None = None,
                 io: FileIO | None = None,
                 state_tree: Callable[[Any], Any] | None = None,
                 load_state_tree: Callable[[Any, Any], Any] | None = None):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.engine = engine
        self.tracker = tracker
        self.sparse_key = sparse_key
        self.n_shards = n_shards
        self.max_chain_depth = max_chain_depth
        self.compact_dirty_fraction = compact_dirty_fraction
        self.keep_chains = keep_chains
        self.state_tree = state_tree
        self.load_state_tree = load_state_tree
        self.io = io if io is not None else FileIO()
        self._reg = registry if registry is not None else obs.get_registry()
        self._c_delta_bytes = self._reg.counter("ckpt/delta_bytes")
        self._c_base_bytes = self._reg.counter("ckpt/base_bytes")
        self._c_frames = self._reg.counter("ckpt/frames_written")
        self._c_compactions = self._reg.counter("ckpt/compactions")
        self._g_dirty_frac = self._reg.gauge("ckpt/dirty_fraction")
        self._g_depth = self._reg.gauge("ckpt/chain_depth")
        self._g_step = self._reg.gauge("ckpt/last_saved_step")
        self._h_save = self._reg.histogram("ckpt/delta_save_s")
        chain = manifest_lib.load_chain(self.directory)
        self._chain: list[Manifest] | None = chain
        self._tip_sha = (manifest_lib.sha256(
            (self.directory / chain[-1].name).read_bytes())
            if chain else None)

    def has_chain(self) -> bool:
        return self._chain is not None

    @property
    def chain(self) -> list[Manifest] | None:
        return self._chain

    def _split(self, state):
        if self.sparse_key is None:
            return state, {}
        rest = {k: v for k, v in state.items() if k != self.sparse_key}
        return state[self.sparse_key], (self.state_tree(rest) if self.state_tree else rest)

    def save(self, state, step: int, cursor: Mapping | None = None
             ) -> Manifest:
        t0 = time.perf_counter()
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)  # the step's in-place row writes
        sparse, rest = self._split(state)
        interval = self.tracker.drain()
        live = live_row_count(self.engine, sparse)
        frac = interval.n_dirty() / max(live, 1)
        chain = self._chain
        kind = "delta"
        if chain is None or chain[-1].chain_depth + 1 > self.max_chain_depth \
                or frac >= self.compact_dirty_fraction:
            kind = "base"
        try:
            man = self._write(kind, sparse, rest, interval, step, cursor)
        except BaseException:
            # the drained rows are not persisted; they stay dirty so the
            # next attempt (possibly after recovery) carries them
            self.tracker.merge_back(interval)
            raise
        if kind == "base" and chain is not None:
            self._c_compactions.inc()
        self._chain = [man] if kind == "base" else [*chain, man]
        self._g_dirty_frac.set(frac)
        self._g_depth.set(man.chain_depth)
        self._g_step.set(step)
        self._h_save.observe(time.perf_counter() - t0)
        manifest_lib.gc(self.directory, self.io, self.keep_chains)
        return man

    def _write(self, kind: str, sparse, rest, interval: DirtyInterval,
               step: int, cursor: Mapping | None) -> Manifest:
        if kind == "base":
            rows = self.engine.export_rows(sparse)
            dead: dict[str, np.ndarray] = {}
        else:
            rows = export_rows_subset(self.engine, sparse, interval.dirty)
            dead = interval.dead
        dense_flat = flatten_tree(rest)
        chain = self._chain
        seq = chain[-1].seq + 1 if chain else 1
        frames, nbytes_total = [], 0
        for si in range(self.n_shards):
            name = f"{manifest_lib.FRAME_PREFIX}{seq:08d}_{si}of{self.n_shards}.safetensors"
            tensors = _pack_shard(rows, dead, dense_flat, si, self.n_shards)
            nbytes, digest = self.io.write_frame(
                self.directory / name, tensors,
                metadata={"step": str(step), "kind": kind})
            frames.append({"file": name, "nbytes": nbytes, "sha256": digest})
            nbytes_total += nbytes
        man = Manifest(
            seq=seq, step=int(step), kind=kind, frames=frames,
            parent=chain[-1].name if chain else None,
            parent_sha256=self._tip_sha,
            chain_depth=0 if kind == "base" else chain[-1].chain_depth + 1,
            cursor=dict(cursor) if cursor else None,
            extra={"n_dirty": interval.n_dirty(), "n_dead": interval.n_dead()},
        )
        self._tip_sha = manifest_lib.commit(self.directory, man, self.io)
        self._c_frames.inc(len(frames))
        (self._c_base_bytes if kind == "base"
         else self._c_delta_bytes).inc(nbytes_total)
        return man

    def recover(self, like_state=None) -> "recovery_lib.RecoveryResult":
        """Replay the committed chain into this checkpointer's engine; see
        ``ft/recovery.py``. Subsequent saves chain onto the recovered tip."""
        res = recovery_lib.recover(self.directory, self.engine,
                                   like_state=like_state,
                                   sparse_key=self.sparse_key,
                                   registry=self._reg,
                                   state_tree=self.state_tree,
                                   load_state_tree=self.load_state_tree)
        self._chain = list(res.chain)
        self._tip_sha = res.tip_sha
        return res
