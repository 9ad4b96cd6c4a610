"""Mergeable registry snapshots — the cross-process telemetry unit
(DESIGN.md §12).

A ``RegistrySnapshot`` is a versioned, JSON-serializable capture of a
``MetricsRegistry``. Snapshots from N workers merge into one global view
with *provably* order-independent semantics:

  * **Counters** sum as exact dyadic rationals: every finite float is
    ``m / 2**s`` with integer ``m``; addition aligns the shifts and adds
    the (arbitrary-precision) mantissas — no rounding ever happens inside
    the merge, so the result is bit-identical under any association or
    permutation of the inputs. The float view rounds exactly once, at
    read time.
  * **Gauges** take the labeled last writer: lexicographic max over the
    ``(last_set_t, value)`` pair — a max-semilattice, hence associative,
    commutative, and idempotent.
  * **Histograms** merge moments (count as int sum, sum as exact dyadic,
    min/max as min/max) plus the fixed-boundary exponential buckets
    (``registry.BUCKET_SCALE``) as element-wise integer sums. The P²
    marker state is *not* serialized — it is a per-stream estimator;
    merged histograms answer quantiles from the buckets
    (``registry.bucket_quantile``), clamped to the true observed range.

``merge_snapshots([])`` returns the empty snapshot — the merge identity.

The schema (``SNAPSHOT_VERSION`` = 2)::

    {"v": 2, "worker": "w0"|null, "epoch": <int>,
     "t": <capture wall-clock>,
     "metrics": {
       "<name>": {"kind": "counter", "sum": [m, s]},
       "<name>": {"kind": "gauge", "value": v, "t": t},
       "<name>": {"kind": "histogram", "count": n, "sum": [m, s],
                  "min": x|null, "max": x|null,
                  "buckets": {"<idx>": n, ...}}}}

v2 adds ``epoch``: a worker's process incarnation (the Trainer stamps
its resume step). Counters reset to zero when a preempted worker
restarts, so its pre- and post-restart snapshots are NOT successive
views of one stream — the aggregator keeps the newest snapshot *per
(worker, epoch)* and SUMS across epochs (DESIGN.md §13). v1 payloads
(no epoch) read as epoch 0; merged snapshots carry the max epoch seen.

Non-finite sums degrade to the IEEE string sentinels ``"inf"/"-inf"/
"nan"`` (merge propagates them with IEEE addition semantics).
"""
from __future__ import annotations

import json
import math
import time
from fractions import Fraction
from typing import Iterable

from . import registry as _reg

SNAPSHOT_VERSION = 2
_READABLE_VERSIONS = (1, 2)   # v1: no epoch field (reads as epoch 0)

# ---------------------------------------------------------------------------
# exact dyadic accumulator: value == m / 2**s  (m: bigint, s: int >= 0)
# ---------------------------------------------------------------------------

_SPECIALS = {"inf": math.inf, "-inf": -math.inf, "nan": math.nan}


def dy_encode(v: float):
    """float → canonical ``[m, s]`` dyadic pair (or an IEEE sentinel str)."""
    v = float(v)
    if not math.isfinite(v):
        return "nan" if math.isnan(v) else ("inf" if v > 0 else "-inf")
    num, den = v.as_integer_ratio()          # den is a power of two
    return [num, den.bit_length() - 1]


def _dy_norm(num: int, shift: int):
    if num == 0:
        return [0, 0]
    while shift > 0 and not (num & 1):
        num >>= 1
        shift -= 1
    return [num, shift]


def dy_add(a, b):
    """Exact dyadic addition; sentinels follow IEEE float addition."""
    if isinstance(a, str) or isinstance(b, str):
        # any sentinel + finite = that sentinel; inf + -inf = nan;
        # nan poisons — exactly IEEE addition over {finite, ±inf, nan}
        fa = _SPECIALS[a] if isinstance(a, str) else 0.0
        fb = _SPECIALS[b] if isinstance(b, str) else 0.0
        s = fa + fb
        return "nan" if math.isnan(s) else ("inf" if s > 0 else "-inf")
    (na, sa), (nb, sb) = a, b
    if sa < sb:
        na, sa, nb, sb = nb, sb, na, sa
    return _dy_norm(na + (nb << (sa - sb)), sa)


def dy_value(a) -> float:
    """Dyadic pair → float, rounded exactly once (IEEE round-to-nearest)."""
    if isinstance(a, str):
        return _SPECIALS[a]
    num, shift = a
    if shift == 0:
        return float(num)
    return float(Fraction(num, 1 << shift))


def _dy_load(a):
    """Validate/canonicalize a deserialized dyadic field."""
    if isinstance(a, str):
        if a not in _SPECIALS:
            raise ValueError(f"bad dyadic sentinel {a!r}")
        return a
    num, shift = a
    return _dy_norm(int(num), int(shift))


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------


class RegistrySnapshot:
    """Versioned, mergeable capture of a MetricsRegistry."""

    __slots__ = ("version", "worker", "t", "epoch", "metrics")

    def __init__(self, metrics: dict | None = None, worker: str | None = None,
                 t: float = 0.0, version: int = SNAPSHOT_VERSION,
                 epoch: int = 0):
        if version not in _READABLE_VERSIONS:
            raise ValueError(
                f"snapshot version {version} != supported {SNAPSHOT_VERSION}")
        # v1 payloads normalize to the current in-memory form (epoch 0)
        self.version = SNAPSHOT_VERSION
        self.worker = worker
        self.t = float(t)
        self.epoch = int(epoch)
        self.metrics: dict[str, dict] = metrics if metrics is not None else {}

    # -- capture ------------------------------------------------------------

    @classmethod
    def capture(cls, registry: "_reg.MetricsRegistry",
                worker: str | None = None,
                t: float | None = None,
                epoch: int = 0) -> "RegistrySnapshot":
        metrics: dict[str, dict] = {}
        with registry._lock:
            items = list(registry._metrics.items())
        for name, m in items:
            if m.kind == "counter":
                metrics[name] = {"kind": "counter", "sum": dy_encode(m.value)}
            elif m.kind == "gauge":
                metrics[name] = {"kind": "gauge", "value": m.value,
                                 "t": m.last_set_t}
            else:  # histogram
                buckets = m.buckets()   # flushes pending P²/bucket state
                n = m.count
                metrics[name] = {
                    "kind": "histogram", "count": n,
                    "sum": dy_encode(m.sum),
                    "min": m.min if n else None,
                    "max": m.max if n else None,
                    "buckets": {str(k): v for k, v in
                                sorted(buckets.items())},
                }
        return cls(metrics, worker=worker,
                   t=time.time() if t is None else t, epoch=epoch)

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> dict:
        return {"v": self.version, "worker": self.worker, "t": self.t,
                "epoch": self.epoch, "metrics": self.metrics}

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, obj: dict | str) -> "RegistrySnapshot":
        if isinstance(obj, str):
            obj = json.loads(obj)
        metrics: dict[str, dict] = {}
        for name, e in obj.get("metrics", {}).items():
            kind = e.get("kind")
            if kind == "counter":
                metrics[name] = {"kind": "counter",
                                 "sum": _dy_load(e["sum"])}
            elif kind == "gauge":
                metrics[name] = {"kind": "gauge",
                                 "value": float(e["value"]),
                                 "t": float(e["t"])}
            elif kind == "histogram":
                metrics[name] = {
                    "kind": "histogram", "count": int(e["count"]),
                    "sum": _dy_load(e["sum"]),
                    "min": None if e["min"] is None else float(e["min"]),
                    "max": None if e["max"] is None else float(e["max"]),
                    "buckets": {str(int(k)): int(v)
                                for k, v in e["buckets"].items()},
                }
            else:
                raise ValueError(f"metric {name!r}: unknown kind {kind!r}")
        return cls(metrics, worker=obj.get("worker"),
                   t=float(obj.get("t", 0.0)),
                   version=int(obj.get("v", -1)),
                   epoch=int(obj.get("epoch", 0)))

    # -- scalar views -------------------------------------------------------

    def counter_value(self, name: str) -> float:
        return dy_value(self.metrics[name]["sum"])

    def histogram_summary(self, name: str) -> dict:
        e = self.metrics[name]
        n = e["count"]
        if not n:
            return {"count": 0}
        total = dy_value(e["sum"])
        buckets = {int(k): v for k, v in e["buckets"].items()}
        out = {"count": n, "sum": total, "mean": total / n,
               "min": e["min"], "max": e["max"]}
        for p in (0.5, 0.95, 0.99):
            out[f"p{int(round(p * 100))}"] = _reg.bucket_quantile(
                buckets, n, p, e["min"], e["max"])
        return out

    # -- publish ------------------------------------------------------------

    def publish(self, registry: "_reg.MetricsRegistry"):
        """Install this snapshot's state into ``registry`` (absolute
        overwrite per metric — the aggregator republishes whole merged
        snapshots, it does not accumulate deltas)."""
        for name, e in self.metrics.items():
            kind = e["kind"]
            if kind == "counter":
                registry.counter(name)._restore_state(dy_value(e["sum"]))
            elif kind == "gauge":
                registry.gauge(name)._restore_state(e["value"], e["t"])
            else:
                mn = math.inf if e["min"] is None else e["min"]
                mx = -math.inf if e["max"] is None else e["max"]
                registry.histogram(name)._restore_state(
                    e["count"], dy_value(e["sum"]), mn, mx,
                    {int(k): v for k, v in e["buckets"].items()})


def _merge_entry(name: str, a: dict, b: dict) -> dict:
    if a["kind"] != b["kind"]:
        raise ValueError(
            f"metric {name!r}: kind mismatch {a['kind']} vs {b['kind']}")
    kind = a["kind"]
    if kind == "counter":
        return {"kind": "counter", "sum": dy_add(a["sum"], b["sum"])}
    if kind == "gauge":
        # last-writer-wins: lexicographic max over (t, value) — a total
        # order, so ties on t deterministically prefer the larger value
        return dict(a if (a["t"], a["value"]) >= (b["t"], b["value"]) else b)
    buckets = {k: v for k, v in a["buckets"].items()}
    for k, v in b["buckets"].items():
        buckets[k] = buckets.get(k, 0) + v
    mins = [x for x in (a["min"], b["min"]) if x is not None]
    maxs = [x for x in (a["max"], b["max"]) if x is not None]
    return {"kind": "histogram",
            "count": a["count"] + b["count"],
            "sum": dy_add(a["sum"], b["sum"]),
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "buckets": {k: buckets[k]
                        for k in sorted(buckets, key=int)}}


def merge_snapshots(
        snapshots: Iterable[RegistrySnapshot]) -> RegistrySnapshot:
    """Fold snapshots into one. Exactly associative + commutative:
    ``merge([a, merge([b, c])]) == merge([merge([a, b]), c])`` bit-for-bit
    for any floats (see module docstring). Empty input → the identity."""
    out: dict[str, dict] = {}
    t = 0.0
    epoch = 0
    workers = []
    for s in snapshots:
        if s.version != SNAPSHOT_VERSION:
            raise ValueError(f"cannot merge snapshot version {s.version}")
        t = max(t, s.t)
        epoch = max(epoch, s.epoch)   # max-semilattice, like t
        if s.worker:
            # merged snapshots carry joined lists — re-split so nested
            # merges stay associative on the worker label too
            workers.extend(s.worker.split(","))
        for name, e in s.metrics.items():
            cur = out.get(name)
            out[name] = dict(e) if cur is None else _merge_entry(name, cur, e)
    worker = ",".join(sorted(set(workers))) if workers else None
    return RegistrySnapshot(out, worker=worker, t=t, epoch=epoch)
