"""ColumnIO — columnar sample storage + sharded async reader (paper §2.1).

Storage model (mirrors the paper's requirements, DFS-agnostic):
  * a *table* is a directory of part files; each part holds row groups;
  * each row group stores each column as an independently-compressed
    (zstd) block → **zero-cost column selection** (only selected columns
    are read or decompressed) and high compression (columnar locality);
  * ragged columns are CSR: (values, row_lengths) — the RaggedTensor
    layout of §2.2.1.

Reader model:
  * distributed workers read disjoint part shards (`shard(i, n)`);
  * a multi-threaded `AsyncLoader` prefetches and assembles fixed-budget
    `Ragged` device batches in the background, hiding IO behind compute
    (the paper's "breaking through the IO wall"). Each reader thread owns
    a set of parts (`shard_map`) and drains its own work deque; an idle
    reader steals from the back of the longest peer deque, so a slow
    shard (straggler) never blocks the batch queue — it just contributes
    fewer row groups per unit time.
  * the reader pool is *elastic* (DESIGN.md §10): `add_reader` /
    `remove_reader` / `reassign_shard` let a closed-loop controller
    (`io/autoscale.py`) grow, shrink and rebalance the pool at step edges
    without dropping queued batches or in-flight row groups.

File format (one part):
  [8B magic "RECISCOL"][4B u32 header_len][header JSON]
  then per row group, per column, raw zstd blocks at offsets recorded in
  the header. Header: {"schema": {...}, "groups": [{"n_rows": ..,
  "cols": {name: {"voff": .., "vlen": .., "loff": .., "llen": ..,
  "vdtype": ..}}}]}

Port of ``repro/io/columnio.py``: the same file format (a table written by
either package reads in the other) and the same reader pool. A batch is a
dict of CPU ``repro_torch.io.ragged.Ragged`` columns, integer values as
int64 (the reference runs with x64 on), floats as float32, row_splits
int32; the train cell moves it to its device. Beside the reference's
producer-side ``cursor`` the loader keeps ``position``, the consumer-side
point of resumption (the next batch the consumer will get, with its index
inside the row group), and takes ``start_batch``; in loop mode a start
position rotates the whole cycle of row groups instead of dropping the
groups before it. With one reader thread a run resumed from ``position``
gets the batches an uninterrupted run would have got.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import queue
import threading
import time
from typing import Iterator, Mapping, Sequence

import numpy as np

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib blocks
    zstandard = None
import zlib

import torch

from repro_torch.io.ragged import Ragged

MAGIC = b"RECISCOL"


class _ZlibCompressor:
    """Drop-in block codec when ``zstandard`` is absent. The header records
    the codec so files are never decoded with the wrong one."""

    def __init__(self, level: int = 3):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)


class _ZlibDecompressor:
    def decompress(self, data: bytes, max_output_size: int = 0) -> bytes:
        out = zlib.decompress(data)
        assert not max_output_size or len(out) <= max_output_size
        return out


def _make_compressor(level: int):
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level), "zstd"
    return _ZlibCompressor(level), "zlib"


def _make_decompressor(codec: str):
    if codec == "zstd":
        assert zstandard is not None, (
            "file is zstd-compressed but the zstandard module is missing")
        return zstandard.ZstdDecompressor()
    assert codec == "zlib", f"unknown ColumnIO codec {codec!r}"
    return _ZlibDecompressor()


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    dtype: str = "int64"   # int64 | float32 | float64 | str-hash
    ragged: bool = True    # False → exactly one value per row


class ColumnWriter:
    def __init__(self, path: str | pathlib.Path, schema: Sequence[ColumnSchema],
                 level: int = 3):
        self.path = pathlib.Path(path)
        self.schema = list(schema)
        self._cctx, self._codec = _make_compressor(level)
        self._groups: list[dict] = []
        self._blobs: list[bytes] = []

    def write_group(self, columns: Mapping[str, Sequence[Sequence]]):
        """columns: {name: list of per-row value lists (or scalars)}."""
        meta = {"cols": {}}
        n_rows = None
        for cs in self.schema:
            rows = columns[cs.name]
            if n_rows is None:
                n_rows = len(rows)
            assert len(rows) == n_rows, cs.name
            if cs.ragged:
                lens = np.asarray([len(r) for r in rows], np.int32)
                vals = (np.concatenate([np.asarray(r) for r in rows])
                        if lens.sum() else np.zeros((0,)))
            else:
                lens = np.ones((n_rows,), np.int32)
                vals = np.asarray(rows)
            vals = vals.astype(cs.dtype)
            vblob = self._cctx.compress(vals.tobytes())
            lblob = self._cctx.compress(lens.tobytes())
            meta["cols"][cs.name] = {
                "voff": sum(len(b) for b in self._blobs), "vlen": len(vblob),
                "vdtype": cs.dtype, "raw_vbytes": vals.nbytes,
            }
            self._blobs.append(vblob)
            meta["cols"][cs.name].update(
                loff=sum(len(b) for b in self._blobs), llen=len(lblob),
                raw_lbytes=lens.nbytes)
            self._blobs.append(lblob)
        meta["n_rows"] = n_rows
        self._groups.append(meta)

    def close(self):
        header = json.dumps({
            "schema": [dataclasses.asdict(c) for c in self.schema],
            "groups": self._groups,
            "codec": self._codec,
        }).encode()
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.write(np.uint32(len(header)).tobytes())
            f.write(header)
            for b in self._blobs:
                f.write(b)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ColumnReader:
    """Reads selected columns of selected row groups of one part file."""

    def __init__(self, path: str | pathlib.Path, columns: Sequence[str] | None = None):
        self.path = pathlib.Path(path)
        with open(self.path, "rb") as f:
            assert f.read(8) == MAGIC, f"not a ColumnIO file: {path}"
            hlen = int(np.frombuffer(f.read(4), np.uint32)[0])
            self.header = json.loads(f.read(hlen))
            self._data_start = 12 + hlen
        self._dctx = _make_decompressor(self.header.get("codec", "zstd"))
        self.schema = {c["name"]: ColumnSchema(**c) for c in self.header["schema"]}
        self.columns = list(columns) if columns is not None else list(self.schema)

    @property
    def n_groups(self) -> int:
        return len(self.header["groups"])

    def read_group(self, gi: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """→ {col: (values, row_lengths)}; reads ONLY the selected columns."""
        g = self.header["groups"][gi]
        out = {}
        with open(self.path, "rb") as f:
            for name in self.columns:
                c = g["cols"][name]
                f.seek(self._data_start + c["voff"])
                vals = np.frombuffer(self._dctx.decompress(
                    f.read(c["vlen"]), max_output_size=c["raw_vbytes"]),
                    dtype=self.schema[name].dtype)
                f.seek(self._data_start + c["loff"])
                lens = np.frombuffer(self._dctx.decompress(
                    f.read(c["llen"]), max_output_size=c["raw_lbytes"]), dtype=np.int32)
                out[name] = (vals, lens)
        return out


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """How to assemble device batches: rows per batch + per-column budget."""

    batch_rows: int
    nnz_budget: Mapping[str, int]   # per column


_EWMA_ALPHA = 0.3      # per-reader / per-part service-time smoothing
_IDLE_SLEEP_S = 0.002  # reader poll interval when its deque (and peers') drain


class _Reader:
    """One prefetch thread: its work deque, service-time EWMA and controls."""

    __slots__ = ("rid", "deque", "stop", "thread", "ewma_s", "groups_read",
                 "hist")

    def __init__(self, rid: int, hist):
        self.rid = rid
        self.deque: collections.deque = collections.deque()
        self.stop = threading.Event()
        self.thread: threading.Thread | None = None
        self.ewma_s: float | None = None   # EWMA read+decompress s/group
        self.groups_read = 0
        self.hist = hist                   # io/read_group_s/reader<rid>


class AsyncLoader:
    """Multi-threaded prefetching loader over a sharded table directory.

    Yields {col: Ragged} batches assembled on the host; `overflow` counts
    ids dropped to the static budget (never silent). ``position`` is where
    a resumed loader (``start_part``, ``start_group``, ``start_batch``)
    picks up the stream; ``cursor`` is the reference's, the row group after
    the last one the readers queued.

    Reports into an ``obs.MetricsRegistry`` (default: process-wide) under
    the ``io/`` namespace: row groups read, batches assembled, rows,
    overflow ids, per-group read+decompress time (aggregate and per-reader
    via label suffixes), reader-pool size, and prefetch-queue depth — the
    gauge that tells you whether IO is hiding behind compute. Depth is
    sampled on every put AND every get, so a drained-then-idle queue reads
    0, not the last producer-side value.

    The reader pool is elastic: ``add_reader`` / ``remove_reader`` /
    ``reassign_shard`` are the actuators of the pipeline autoscaler
    (io/autoscale.py), and ``signals()`` is its sensor snapshot. All three
    preserve queued batches and in-flight row groups.
    """

    def __init__(self, table_dir: str | pathlib.Path, spec: BatchSpec,
                 columns: Sequence[str] | None = None,
                 shard: tuple[int, int] = (0, 1), n_threads: int = 4,
                 prefetch: int = 8, loop: bool = False, start_part: int = 0,
                 start_group: int = 0, start_batch: int = 0, registry=None):
        from repro_torch import obs  # local import: io has no other deps
        parts = sorted(pathlib.Path(table_dir).glob("part-*.col"))
        self.parts = [p for i, p in enumerate(parts) if i % shard[1] == shard[0]]
        assert self.parts, f"no parts for shard {shard} in {table_dir}"
        self.spec = spec
        self.columns = columns
        self.loop = loop
        self.overflow = 0
        self.rows_seen = 0
        self._reg = registry if registry is not None else obs.get_registry()
        reg = self._reg
        self._c_groups = reg.counter("io/row_groups_read")
        self._c_batches = reg.counter("io/batches_assembled")
        self._c_rows = reg.counter("io/rows")
        self._c_overflow = reg.counter("io/overflow_ids")
        self._h_read = reg.histogram("io/read_group_s")
        self._g_depth = reg.gauge("io/queue_depth")
        self._g_readers = reg.gauge("io/readers")
        # published once: the cross-worker aggregator sums depth/capacity
        # into agg/io/* for the autoscaler's multi-host signal
        reg.gauge("io/queue_capacity").set(prefetch)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._lock = threading.Lock()          # readers / shard_map / EWMAs
        self._cursor_lock = threading.Lock()
        self.cursor = {"part": start_part, "group": start_group}  # checkpointable
        self.position = {"part": start_part, "group": start_group, "batch": start_batch}
        self.shard_map: dict[int, int] = {}    # part index → owning reader id
        self.part_ewma: dict[int, float] = {}  # part index → EWMA s/group
        self._readers: dict[int, _Reader] = {}
        self._next_rid = 0
        self._live = 0          # threads still running (incl. removed ones)
        self._unfinished = 0    # non-loop: enqueued row groups not yet done
        work = [(pi, gi) for pi, p in enumerate(self.parts)
                for gi in range(ColumnReader(p, columns).n_groups)]
        start = (start_part, start_group)
        first = next((i for i, item in enumerate(work) if item >= start), len(work))
        if loop:  # the whole cycle, from the start position on
            first %= max(len(work), 1)
            work = work[first:] + work[:first]
        else:
            work = work[first:]
        # batches of the start group the consumer already had
        self._skip = {start: start_batch} if work and work[0] == start and start_batch else {}
        self._unfinished = len(work)
        with self._lock:
            rids = [self._new_reader_locked() for _ in range(max(n_threads, 1))]
            for i in range(len(self.parts)):
                self.shard_map[i] = rids[i % len(rids)]
            for item in work:
                self._readers[self.shard_map[item[0]]].deque.append(item)
            for rid in rids:
                self._spawn_locked(self._readers[rid])

    # ----------------------------------------------------- reader pool ops
    def _new_reader_locked(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        hist = self._reg.histogram("io/read_group_s", reader=rid)
        self._readers[rid] = _Reader(rid, hist)
        self._g_readers.set(len(self._readers))
        return rid

    def _spawn_locked(self, r: _Reader):
        r.thread = threading.Thread(target=self._worker, args=(r,), daemon=True)
        self._live += 1
        r.thread.start()

    @property
    def n_readers(self) -> int:
        with self._lock:
            return len(self._readers)

    def add_reader(self) -> int:
        """Grow the pool by one thread; pulls a fair share of shards (and
        their queued work) from the most-loaded owners so the new reader
        owns work immediately instead of only stealing."""
        with self._lock:
            rid = self._new_reader_locked()
            r = self._readers[rid]
            share = max(1, len(self.parts) // len(self._readers))
            while True:
                owned = len([p for p, o in self.shard_map.items() if o == rid])
                if owned >= share:
                    break
                counts: dict[int, int] = {}
                for p, o in self.shard_map.items():
                    counts[o] = counts.get(o, 0) + 1
                donors = [(n, o) for o, n in counts.items()
                          if o != rid and n > 1 and o in self._readers]
                if not donors:
                    break
                _, donor = max(donors)
                give = max(p for p, o in self.shard_map.items() if o == donor)
                self._reassign_locked(give, rid)
            self._spawn_locked(r)
        return rid

    def remove_reader(self, rid: int | None = None) -> int | None:
        """Shrink the pool by one thread (default: the newest). Its shards
        and queued work move to the least-loaded survivors; its in-flight
        row group completes and is re-enqueued (loop mode) before the
        thread exits. Returns the removed rid, or None if only one reader
        remains (the pool never empties)."""
        with self._lock:
            live = sorted(self._readers)
            if len(live) <= 1:
                return None
            if rid is None or rid not in self._readers:
                rid = live[-1]
            r = self._readers.pop(rid)
            self._g_readers.set(len(self._readers))
            survivors = sorted(self._readers)
            counts = {s: 0 for s in survivors}
            for p, o in self.shard_map.items():
                if o in counts:
                    counts[o] += 1
            for p in sorted(p for p, o in self.shard_map.items() if o == rid):
                dst = min(survivors, key=lambda s: (counts[s], s))
                self.shard_map[p] = dst
                counts[dst] += 1
            # park its queued work with the new owners (nothing is dropped)
            while r.deque:
                pi, gi = r.deque.popleft()
                dst = self.shard_map.get(pi)
                tgt = self._readers.get(dst) if dst is not None else None
                (tgt or self._readers[survivors[0]]).deque.append((pi, gi))
            r.stop.set()
        return rid

    def reassign_shard(self, part: int, dst_rid: int) -> bool:
        """Move ownership of ``part`` (and its queued row groups) to reader
        ``dst_rid`` — the controller's explicit work-stealing action."""
        with self._lock:
            if dst_rid not in self._readers or not (0 <= part < len(self.parts)):
                return False
            self._reassign_locked(part, dst_rid)
        return True

    def _reassign_locked(self, part: int, dst_rid: int):
        src = self.shard_map.get(part)
        self.shard_map[part] = dst_rid
        sr = self._readers.get(src) if src is not None else None
        if sr is not None and src != dst_rid:
            moved = [it for it in sr.deque if it[0] == part]
            if moved:
                kept = [it for it in sr.deque if it[0] != part]
                sr.deque.clear()
                sr.deque.extend(kept)
                self._readers[dst_rid].deque.extend(moved)

    def signals(self) -> dict:
        """Controller-facing snapshot (io/autoscale.py Signals fields)."""
        with self._lock:
            shards: dict[int, list[int]] = {rid: [] for rid in self._readers}
            for pi, rid in sorted(self.shard_map.items()):
                if rid in shards:
                    shards[rid].append(pi)
            return {
                "n_readers": len(self._readers),
                "queue_depth": self._q.qsize(),
                "queue_capacity": self._q.maxsize,
                "reader_service_ewma_s": {
                    rid: r.ewma_s for rid, r in self._readers.items()
                    if r.ewma_s is not None},
                "reader_shards": {rid: tuple(s) for rid, s in shards.items()},
                "part_service_ewma_s": dict(self.part_ewma),
            }

    # ------------------------------------------------------------- workers
    def _take_work(self, r: _Reader):
        with self._lock:
            if r.deque:
                return r.deque.popleft()
            victim = max(
                (p for p in self._readers.values() if p is not r and p.deque),
                key=lambda p: len(p.deque), default=None)
            if victim is not None:
                return victim.deque.pop()  # steal from the back
            return None

    def _note_service(self, r: _Reader, pi: int, dt: float):
        self._h_read.observe(dt)
        r.hist.observe(dt)
        a = _EWMA_ALPHA
        with self._lock:
            r.ewma_s = dt if r.ewma_s is None else (1 - a) * r.ewma_s + a * dt
            prev = self.part_ewma.get(pi)
            self.part_ewma[pi] = dt if prev is None else (1 - a) * prev + a * dt
            r.groups_read += 1

    def _worker(self, r: _Reader):
        col_readers: dict[int, ColumnReader] = {}
        try:
            while not (self._stop.is_set() or r.stop.is_set()):
                item = self._take_work(r)
                if item is None:
                    with self._lock:
                        drained = self._unfinished == 0
                    if drained and not self.loop:
                        break
                    time.sleep(_IDLE_SLEEP_S)
                    continue
                pi, gi = item
                if pi not in col_readers:
                    col_readers[pi] = ColumnReader(self.parts[pi], self.columns)
                t0 = time.perf_counter()
                cols = col_readers[pi].read_group(gi)
                self._note_service(r, pi, time.perf_counter() - t0)
                self._c_groups.inc()
                with self._lock:
                    skip = self._skip.pop((pi, gi), 0)
                n_batches = len(next(iter(cols.values()))[1]) // self.spec.batch_rows
                for bi, batch in self._assemble(cols, skip):
                    self._q.put((batch, (pi, gi, bi, n_batches)))
                    self._g_depth.set(self._q.qsize())
                with self._cursor_lock:
                    self.cursor = {"part": pi, "group": gi + 1}
                with self._lock:
                    if self.loop:  # re-enqueue with the CURRENT owner
                        owner = self._readers.get(self.shard_map.get(pi, r.rid))
                        (owner if owner is not None else r).deque.append((pi, gi))
                    else:
                        self._unfinished -= 1
        finally:
            self._retire(r)

    def _retire(self, r: _Reader):
        with self._lock:
            self._readers.pop(r.rid, None)
            self._g_readers.set(len(self._readers))
            leftovers = list(r.deque)
            r.deque.clear()
            live = sorted(self._readers)
            for pi, gi in leftovers:  # defensive: never drop queued work
                dst = self.shard_map.get(pi)
                tgt = self._readers.get(dst) if dst is not None else None
                if tgt is None and live:
                    tgt = self._readers[live[0]]
                if tgt is not None:
                    tgt.deque.append((pi, gi))
            self._live -= 1
            last = self._live == 0
        if last and not self.loop and not self._stop.is_set():
            self._q.put(None)  # single end-of-data sentinel

    def _assemble(self, cols, skip: int = 0) -> Iterator[tuple[int, dict]]:
        """(index in the row group, batch) for each whole batch of the group
        from the ``skip``-th on."""
        any_col = next(iter(cols.values()))
        n_rows = len(any_col[1])
        br = self.spec.batch_rows
        offs = {k: np.concatenate([[0], np.cumsum(l)]) for k, (v, l) in cols.items()}
        for s in range(skip * br, n_rows - br + 1, br):
            batch = {}
            for k, (vals, lens) in cols.items():
                budget = self.spec.nnz_budget[k]
                lo, hi = offs[k][s], offs[k][s + br]
                flat = vals[lo:hi]
                blens = lens[s: s + br].copy()
                if flat.shape[0] > budget:  # truncate & count
                    dropped = int(flat.shape[0] - budget)
                    with self._lock:  # _assemble runs on every reader thread
                        self.overflow += dropped
                    self._c_overflow.inc(dropped)
                    cum = np.cumsum(blens)
                    blens = np.where(cum <= budget, blens, np.maximum(
                        budget - np.concatenate([[0], cum[:-1]]), 0)).astype(np.int32)
                    flat = flat[:budget]
                pad = np.zeros((budget,), dtype=vals.dtype)
                if np.issubdtype(vals.dtype, np.integer):
                    pad -= 1
                pad[: flat.shape[0]] = flat
                splits = np.zeros((br + 1,), np.int32)
                np.cumsum(blens, out=splits[1:])
                dt = np.int64 if np.issubdtype(vals.dtype, np.integer) else np.float32
                batch[k] = Ragged(torch.from_numpy(pad.astype(dt, copy=False)),
                                  torch.from_numpy(splits))
            with self._lock:  # _assemble runs on every reader thread
                self.rows_seen += br
            self._c_batches.inc()
            self._c_rows.inc(br)
            yield s // br, batch

    def __iter__(self):
        while True:
            item = self._q.get()
            self._g_depth.set(self._q.qsize())  # consumer-side depth sample
            if item is None:
                return
            batch, (pi, gi, bi, n_batches) = item
            self.position = ({"part": pi, "group": gi, "batch": bi + 1} if bi + 1 < n_batches
                             else {"part": pi, "group": gi + 1, "batch": 0})
            yield batch

    def stop(self):
        self._stop.set()
