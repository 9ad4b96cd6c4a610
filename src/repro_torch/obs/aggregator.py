"""Cross-worker telemetry aggregation (DESIGN.md §12); a copy of
``repro/obs/aggregator.py``.

``TelemetryAggregator`` is the single-pane view over N training workers:
each worker's Trainer emits periodic ``{"type": "snapshot", "worker": …,
"snapshot": <RegistrySnapshot>}`` records into its own JSONL telemetry
file (``TrainConfig.snapshot_every``); the aggregator incrementally tails
those files (``telemetry.tail_jsonl`` — byte offsets, rotation-aware,
partial-line tolerant), keeps the *latest* snapshot per ``(worker,
epoch)`` — a preempted worker restarts with fresh (zeroed) counters and
a new epoch (its resume step), so snapshots from different epochs are
different streams and must SUM, not overwrite — and publishes the
merged view into a global registry:

  * every worker metric, merged with obs/merge.py semantics (counters
    sum exactly, gauges last-writer, histogram buckets element-wise);
  * ``agg/workers`` — number of workers contributing;
  * ``agg/phase_mean_s/<phase>/<worker>`` — per-worker mean seconds for
    each step phase (``trace/<phase>_s``), via ``obs.label``;
  * ``agg/skew/<phase>`` — max worker mean / median worker mean: the
    cross-worker imbalance series (1.0 = balanced). ``attribute()``
    names the straggler behind any skew above threshold — NestPipe's
    "which host, which phase" question;
  * ``agg/io/queue_depth`` / ``agg/io/queue_capacity`` — summed across
    workers: the autoscaler's first multi-host signal
    (``io/autoscale.Signals.agg_queue_*``).

The aggregator is pull-based and stateless-on-disk: it can start late,
crash, and restart — offsets rebuild from the files. Run standalone with
``python -m repro_torch.obs.aggregator <files...> [--prometheus-port P]``.
"""
from __future__ import annotations

import glob as _glob
import math
import pathlib
import threading
from typing import Iterable

from .merge import RegistrySnapshot, merge_snapshots
from .registry import MetricsRegistry, label
from .telemetry import tail_jsonl
from .tracing import PHASES

SNAPSHOT_RECORD = "snapshot"


class TelemetryAggregator:
    """Tail per-worker telemetry files; merge + derive into one registry.

    Thread-safe: ``poll``/``publish`` may be driven from a controller
    thread while a scrape endpoint reads the registry."""

    def __init__(self, paths: Iterable[str | pathlib.Path] = (),
                 registry: MetricsRegistry | None = None,
                 phases: tuple[str, ...] = PHASES,
                 skew_threshold: float = 1.5):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.phases = tuple(phases)
        self.skew_threshold = float(skew_threshold)
        self._lock = threading.Lock()
        self._paths: list[pathlib.Path] = []
        self._offsets: dict[pathlib.Path, int] = {}
        # newest snapshot per (worker, epoch): one entry per process
        # incarnation, merged across epochs at read time
        self._latest: dict[tuple[str, int], RegistrySnapshot] = {}
        for p in paths:
            self.add_path(p)

    # -- sources ------------------------------------------------------------

    def add_path(self, path: str | pathlib.Path):
        p = pathlib.Path(path)
        with self._lock:
            if p not in self._offsets:
                self._paths.append(p)
                self._offsets[p] = 0

    def discover(self, pattern: str) -> int:
        """Add every file matching ``pattern`` (late workers join live)."""
        n = 0
        for hit in sorted(_glob.glob(pattern)):
            p = pathlib.Path(hit)
            with self._lock:
                new = p not in self._offsets
            if new:
                self.add_path(p)
                n += 1
        return n

    # -- ingest -------------------------------------------------------------

    def poll(self) -> int:
        """Tail every source; ingest new snapshot records. Returns the
        number of snapshots ingested."""
        with self._lock:
            sources = list(self._paths)
            offsets = dict(self._offsets)
        n = 0
        for p in sources:
            records, new_off = tail_jsonl(p, offsets.get(p, 0))
            with self._lock:
                self._offsets[p] = new_off
            for rec in records:
                if rec.get("type") == SNAPSHOT_RECORD:
                    n += 1 if self.ingest(rec, default_worker=p.stem) else 0
        return n

    def ingest(self, record: dict, default_worker: str = "w") -> bool:
        """Install one snapshot record; keeps the newest per (worker,
        epoch) (capture stamp ``t``, arrival order breaking ties)."""
        try:
            snap = RegistrySnapshot.from_json(record["snapshot"])
        except (KeyError, ValueError, TypeError):
            return False
        worker = record.get("worker") or snap.worker or default_worker
        key = (worker, snap.epoch)
        with self._lock:
            cur = self._latest.get(key)
            if cur is None or snap.t >= cur.t:
                self._latest[key] = snap
                return True
        return False

    # -- views --------------------------------------------------------------

    @property
    def workers(self) -> list[str]:
        with self._lock:
            return sorted({w for w, _e in self._latest})

    def merged(self) -> RegistrySnapshot:
        with self._lock:
            snaps = [self._latest[k] for k in sorted(self._latest)]
        return merge_snapshots(snaps)

    def _per_worker(self) -> list[tuple[str, RegistrySnapshot]]:
        """One lifetime snapshot per worker: its epochs merged (counter
        sums span restarts; gauges take the newest incarnation)."""
        with self._lock:
            items = sorted(self._latest.items())
        by_worker: dict[str, list[RegistrySnapshot]] = {}
        for (worker, _epoch), snap in items:
            by_worker.setdefault(worker, []).append(snap)
        return [(w, snaps[0] if len(snaps) == 1 else merge_snapshots(snaps))
                for w, snaps in by_worker.items()]

    def phase_means(self) -> dict[str, dict[str, float]]:
        """{phase: {worker: mean seconds}} over ``trace/<phase>_s``."""
        items = self._per_worker()
        out: dict[str, dict[str, float]] = {}
        for phase in self.phases:
            name = f"trace/{phase}_s"
            per: dict[str, float] = {}
            for worker, snap in items:
                e = snap.metrics.get(name)
                if e and e["kind"] == "histogram" and e["count"]:
                    per[worker] = snap.histogram_summary(name)["mean"]
            if per:
                out[phase] = per
        return out

    def skew(self) -> dict[str, float]:
        """{phase: max worker mean / median worker mean} (≥ 1.0)."""
        out = {}
        for phase, per in self.phase_means().items():
            means = sorted(per.values())
            med = means[len(means) // 2] if len(means) % 2 else \
                (means[len(means) // 2 - 1] + means[len(means) // 2]) / 2
            if med > 0:
                out[phase] = max(means) / med
        return out

    def attribute(self) -> list[dict]:
        """Straggler attribution: for each phase whose skew exceeds the
        threshold, the worker with the highest mean. Sorted worst-first —
        the answer to "who is slow, and in which phase"."""
        out = []
        means = self.phase_means()
        for phase, ratio in self.skew().items():
            if ratio >= self.skew_threshold:
                per = means[phase]
                worker = max(per, key=lambda w: (per[w], w))
                out.append({"phase": phase, "worker": worker,
                            "skew": ratio, "mean_s": per[worker]})
        out.sort(key=lambda d: -d["skew"])
        return out

    # -- publish ------------------------------------------------------------

    def agg_queue(self) -> tuple[float, int]:
        """(summed io/queue_depth, summed io/queue_capacity) across
        workers — nan/0 when no worker reports them."""
        depth = math.nan
        cap = 0
        snaps = [snap for _w, snap in self._per_worker()]
        for snap in snaps:
            d = snap.metrics.get("io/queue_depth")
            if d and d["kind"] == "gauge":
                depth = (0.0 if math.isnan(depth) else depth) + d["value"]
            c = snap.metrics.get("io/queue_capacity")
            if c and c["kind"] == "gauge":
                cap += int(c["value"])
        return depth, cap

    def publish(self) -> MetricsRegistry:
        """Republish the merged view + derived ``agg/`` series into the
        aggregator's registry (absolute overwrite — idempotent)."""
        merged = self.merged()
        merged.publish(self.registry)
        reg = self.registry
        reg.gauge("agg/workers").set(len(self.workers))
        for phase, per in self.phase_means().items():
            for worker, mean in per.items():
                reg.gauge(label(f"agg/phase_mean_s/{phase}",
                                worker=worker)).set(mean)
        for phase, ratio in self.skew().items():
            reg.gauge(f"agg/skew/{phase}").set(ratio)
        depth, cap = self.agg_queue()
        if not math.isnan(depth):
            reg.gauge("agg/io/queue_depth").set(depth)
        if cap:
            reg.gauge("agg/io/queue_capacity").set(cap)
        return reg

    def refresh(self) -> MetricsRegistry:
        """poll + publish in one call (the controller-facing entry)."""
        self.poll()
        return self.publish()


def _main(argv=None) -> int:
    import argparse
    import json
    import time as _time

    ap = argparse.ArgumentParser(
        description="merge per-worker telemetry JSONL into one view")
    ap.add_argument("paths", nargs="+",
                    help="worker telemetry files (or glob patterns)")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                    help="poll every SEC seconds (default: once)")
    ap.add_argument("--prometheus-port", type=int, default=None,
                    help="serve the merged registry for scraping")
    ap.add_argument("--skew-threshold", type=float, default=1.5)
    args = ap.parse_args(argv)

    agg = TelemetryAggregator(skew_threshold=args.skew_threshold)
    for pat in args.paths:
        if _glob.has_magic(pat):
            agg.discover(pat)
        else:
            agg.add_path(pat)
    exporter = None
    if args.prometheus_port is not None:
        from .prometheus import PrometheusExporter
        exporter = PrometheusExporter(agg.registry, port=args.prometheus_port)
        print(f"serving /metrics on port {exporter.start()}")
    try:
        while True:
            agg.refresh()
            report = {"workers": agg.workers, "skew": agg.skew(),
                      "stragglers": agg.attribute()}
            print(json.dumps(report, sort_keys=True))
            if args.watch <= 0:
                break
            _time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    finally:
        if exporter is not None:
            exporter.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
