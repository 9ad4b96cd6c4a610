"""Structured telemetry export — rotating JSONL writer + console reporter.

``TelemetryWriter`` appends one JSON object per line to a trace file. Each
``emit`` writes the full line in a single ``write`` under a lock (line-
atomic on POSIX) and flushes, so a preempted/killed run leaves a parseable
trace up to the last completed record. When the file would exceed
``max_bytes`` it rotates: ``trace.jsonl`` → ``trace.jsonl.1`` → … up to
``max_files`` back-files (oldest dropped), so a week-long online-learning
run cannot fill the disk.

Record taxonomy (all records carry ``"type"`` and a wall-clock ``"t"``):
  step     — per-train-step phase timeline (tracing.Tracer.step)
  span     — a standalone span outside any step (final checkpoint, restore)
  summary  — a full MetricsRegistry snapshot (end of Trainer.run)
  event    — anything else (straggler flags, bench results)

``ConsoleReporter`` is the human-facing counterpart: every ``every`` steps
it prints the registry's counter deltas over the interval plus selected
gauges — one compact line, no dependency on the JSONL file.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
from typing import Mapping

import numpy as np

from repro_torch.obs.registry import MetricsRegistry


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.bool_,)):
        return bool(o)
    return str(o)


class TelemetryWriter:
    def __init__(self, path: str | pathlib.Path, max_bytes: int = 64 << 20,
                 max_files: int = 3):
        self.path = pathlib.Path(path)
        self.max_bytes = int(max_bytes)
        self.max_files = int(max_files)
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._pending: list[str] = []
        self.records_written = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def _open(self):
        # crash salvage: a killed run can leave a partial (newline-less)
        # last line; terminate it so it stays one isolated, skippable line
        # instead of corrupting the next appended record
        if self.path.exists() and self.path.stat().st_size:
            with open(self.path, "rb+") as f:
                f.seek(-1, 2)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = self.path.stat().st_size if self.path.exists() else 0

    def _rotate_locked(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        oldest = self.path.with_name(f"{self.path.name}.{self.max_files}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.max_files - 1, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                src.rename(self.path.with_name(f"{self.path.name}.{i + 1}"))
        if self.max_files > 0:
            self.path.rename(self.path.with_name(f"{self.path.name}.1"))
        else:
            self.path.unlink()

    def emit(self, record: Mapping):
        if "t" not in record:
            record = {**record, "t": time.time()}
        line = json.dumps(record, separators=(",", ":"),
                          default=_json_default) + "\n"
        with self._lock:
            # queue-then-drain: a record is only dropped from the queue
            # once its bytes are flushed. If the rotation path (close /
            # rename / reopen) raises mid-emit, the line survives in
            # ``_pending`` and the next emit (or close) re-emits it —
            # previously a rotation-boundary failure lost the record.
            self._pending.append(line)
            self._drain_locked()

    def _drain_locked(self):
        while self._pending:
            line = self._pending[0]
            data = line.encode("utf-8")
            if self._f is None:
                self._open()
            if self._size and self._size + len(data) > self.max_bytes:
                self._rotate_locked()
                self._open()
            self._f.write(line)
            self._f.flush()
            self._size += len(data)
            self.records_written += 1
            self._pending.pop(0)

    def close(self):
        with self._lock:
            try:
                self._drain_locked()  # re-emit anything a failed rotation left
            finally:
                if self._f is not None:
                    self._f.close()
                    self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_jsonl(path: str | pathlib.Path, strict: bool = False) -> list[dict]:
    """Parse a telemetry file (tests / offline analysis). Unparseable
    lines (a salvaged crash tail) are skipped unless ``strict``."""
    out = []
    p = pathlib.Path(path)
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        if line.strip():
            try:
                out.append(json.loads(line))
            except ValueError:
                if strict:
                    raise
    return out


def tail_jsonl(path: str | pathlib.Path,
               offset: int = 0) -> tuple[list[dict], int]:
    """Incremental JSONL read for live aggregation (obs/aggregator.py).

    Returns ``(records, new_offset)``: complete records whose bytes lie
    after ``offset``; a partial trailing line (a record mid-write by
    another process) is left for the next call. A file smaller than
    ``offset`` means it was rotated/truncated underneath us — the tail
    restarts from 0. Unparseable lines are skipped."""
    p = pathlib.Path(path)
    if not p.exists():
        return [], 0
    size = p.stat().st_size
    if size < offset:
        offset = 0
    if size == offset:
        return [], offset
    with open(p, "rb") as f:
        f.seek(offset)
        data = f.read()
    end = data.rfind(b"\n")
    if end < 0:
        return [], offset
    records = []
    for raw in data[:end + 1].splitlines():
        if raw.strip():
            try:
                records.append(json.loads(raw))
            except ValueError:
                pass
    return records, offset + end + 1


class ConsoleReporter:
    def __init__(self, registry: MetricsRegistry, every: int = 50,
                 printer=print):
        self.registry = registry
        self.every = int(every)
        self.printer = printer
        self._last_counters: dict[str, float] = {}

    def maybe_report(self, step: int):
        if self.every <= 0 or step % self.every != 0:
            return
        self.report(step)

    def report(self, step: int):
        snap = self.registry.snapshot()
        deltas, gauges, hists = [], [], []
        for name, v in snap.items():
            if isinstance(v, dict):  # histogram summary
                if v.get("count"):
                    hists.append(f"{name} p50={v['p50']:.4g} p99={v['p99']:.4g}")
                continue
            m = self.registry.get(name)
            if m is not None and m.kind == "counter":
                d = v - self._last_counters.get(name, 0.0)
                self._last_counters[name] = v
                if d:
                    deltas.append(f"{name} +{d:g}")
            elif v:
                gauges.append(f"{name}={v:g}")
        parts = deltas + gauges + hists
        self.printer(f"[obs step {step}] " + " | ".join(parts))
