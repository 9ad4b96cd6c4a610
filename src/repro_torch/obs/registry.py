"""MetricsRegistry — the single sink for runtime + kernel-quality metrics
(DESIGN.md §9).

Every subsystem (Trainer, TieredEmbeddingStore, AsyncLoader, AsyncSaver,
the MBU/roofline bridge) registers instruments here under a unified naming
scheme:

    <subsystem>/<metric>[_<unit>]     e.g.  storage/hits, trainer/step_wall_s

Names are validated at registration: lower snake_case segments joined by
``/`` with at least one subsystem prefix — a misnamed metric is a bug, not
a style nit, because downstream tooling (BENCH_*.json, the JSONL trace,
dashboards) keys on stable names.

Three instrument kinds:
  * ``Counter``   — monotone accumulator (events, rows, bytes).
  * ``Gauge``     — last-value (occupancy, hit-rate, last step), stamped
    with its last write time so cross-process merges can pick the
    last writer (obs/merge.py).
  * ``Histogram`` — streaming distribution: count/sum/min/max plus p50,
    p95, p99 via the P² algorithm (Jain & Chlamtac 1985) — O(1) memory,
    no samples stored, which is what a 1,500-accelerator run needs —
    PLUS fixed-boundary exponential buckets (base 2^(1/4)), the
    *mergeable* representation: same boundaries on every worker, so a
    cross-process merge is an element-wise bucket sum (obs/merge.py)
    and the Prometheus exposition has real ``le`` buckets.

``observe`` is batched: the cheap moments (count/sum/min/max) update
inline, while P² marker updates and bucket assignment drain every
``_DRAIN_AT`` observations (or on any read) — this is what keeps a
fully-instrumented observe under ~2 µs instead of ~10 µs.

All mutating ops are thread-safe (AsyncLoader workers and the AsyncSaver
thread write concurrently with the train loop).
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(/[a-z][a-z0-9_]*)+$")

# names already validated once this process — check_name is on the span /
# instrument-lookup hot path, so the regex runs once per distinct name
_CHECKED_NAMES: set[str] = set()
_CHECKED_CAP = 1 << 16


def valid_name(name: str) -> bool:
    return bool(NAME_RE.match(name))


def check_name(name: str) -> str:
    if name in _CHECKED_NAMES:
        return name
    if not valid_name(name):
        raise ValueError(
            f"bad metric name {name!r}: want snake_case segments joined by "
            "'/' with a subsystem prefix, e.g. 'storage/hits'")
    if len(_CHECKED_NAMES) < _CHECKED_CAP:  # bounded: dynamic-name safety
        _CHECKED_NAMES.add(name)
    return name


def span_name(name: str) -> str:
    """Validate a Tracer span name against the shared metric namespace.

    Spans and metrics are ONE namespace: every span folds into a
    ``trace/<name>_s`` registry histogram (tracing.py), and the ROADMAP
    ``table2_e2e``→``trace/`` fold keys on the same scheme. A span name
    must therefore be a bare snake_case segment (optionally ``/``-nested,
    e.g. ``data_wait`` or ``eval/val_loss``) such that both
    ``trace/<name>`` and ``trace/<name>_s`` pass ``check_name``. Returns
    the derived histogram name ``trace/<name>_s``."""
    check_name(f"trace/{name}")
    return check_name(f"trace/{name}_s")


# ---------------------------------------------------------------------------
# exponential histogram buckets — the mergeable representation
# ---------------------------------------------------------------------------

# Fixed boundaries shared by EVERY histogram in every process: bucket i
# covers (2^((i-1)/SCALE), 2^(i/SCALE)] — base 2^(1/4) ≈ 1.19, so a
# bucket-estimated quantile is within ~±9% of the true value. Fixed (not
# adaptive) is the point: two workers' buckets align index-for-index, so
# merging is an element-wise sum (associative + commutative, obs/merge.py).
BUCKET_SCALE = 4
# everything ≤ 0 lands here (durations are positive; a zero observation
# must still be counted somewhere mergeable)
UNDERFLOW_BUCKET = -(1 << 30)


def bucket_index(x: float) -> int:
    if x <= 0.0:
        return UNDERFLOW_BUCKET
    return math.ceil(math.log2(x) * BUCKET_SCALE)


def bucket_upper(i: int) -> float:
    """Upper (inclusive) bound of bucket ``i``; 0.0 for the underflow."""
    if i == UNDERFLOW_BUCKET:
        return 0.0
    return 2.0 ** (i / BUCKET_SCALE)


def bucket_quantile(buckets: dict[int, int], count: int, p: float,
                    lo: float = -math.inf, hi: float = math.inf) -> float:
    """Estimate the p-quantile from exponential bucket counts (used for
    merged / restored histograms, where no P² marker state exists). The
    estimate is the geometric midpoint of the covering bucket, clamped to
    the true observed [min, max] when known."""
    if not count or not buckets:
        return math.nan
    target = p * count
    acc = 0
    last = UNDERFLOW_BUCKET
    for i in sorted(buckets):
        acc += buckets[i]
        last = i
        if acc >= target:
            break
    if last == UNDERFLOW_BUCKET:
        return max(lo, 0.0) if math.isfinite(lo) else 0.0
    mid = 2.0 ** ((last - 0.5) / BUCKET_SCALE)
    return min(max(mid, lo), hi)


def sanitize(fragment: str) -> str:
    """Coerce an arbitrary label (arch id, op name) into one legal
    snake_case name segment: ``wide-deep`` → ``wide_deep``."""
    s = re.sub(r"[^a-z0-9_]", "_", str(fragment).lower()).strip("_")
    return s or "x"


def label(name: str, **labels) -> str:
    """Cheap label support: append one ``<key><value>`` segment per label,
    sorted by key — ``label("storage/hits", shard=3)`` → ``storage/hits/
    shard3``. Labels are just name suffixes: no cardinality tracking, no
    per-series dict — a labelled series is an ordinary registry entry, so
    per-shard / per-reader counters cost exactly one instrument each
    (the ROADMAP's "cheap label support" requirement)."""
    for k in sorted(labels):
        seg = f"{sanitize(k)}{sanitize(labels[k]) if not isinstance(labels[k], int) else labels[k]}"
        name = f"{name}/{seg}"
    return check_name(name)


class Counter:
    kind = "counter"
    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def read(self):
        return self._v

    def _restore_state(self, v: float):
        """Install a merged value (obs/merge.py publish)."""
        with self._lock:
            self._v = float(v)


class Gauge:
    kind = "gauge"
    __slots__ = ("name", "_v", "_t", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._t = 0.0          # wall-clock of the last set (merge ordering)
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._v = float(v)
            self._t = time.time()

    @property
    def value(self) -> float:
        return self._v

    @property
    def last_set_t(self) -> float:
        """Wall-clock time of the last ``set`` (0.0 = never written).
        Cross-process gauge merges are last-writer-wins on this stamp
        (obs/merge.py)."""
        return self._t

    def read(self):
        return self._v

    def _restore_state(self, v: float, t: float):
        """Install a merged (value, stamp) pair (obs/merge.py publish)."""
        with self._lock:
            self._v = float(v)
            self._t = float(t)


class _P2Quantile:
    """Single-quantile P² estimator: 5 markers, O(1) update, no samples.

    Until 5 observations arrive it falls back to the exact small-sample
    quantile of the buffered values."""

    __slots__ = ("p", "_q", "_pos", "_des", "_inc")

    def __init__(self, p: float):
        self.p = float(p)
        self._q: list[float] = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._des = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
        self._inc = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def observe(self, x: float):
        self.observe_sorted([x])

    def observe_sorted(self, batch: list[float]):
        """Feed a SORTED batch of observations in one amortized update.

        The classic P² update is per-observation; here the marker
        positions advance by rank counts over the whole batch (one
        ``bisect`` per marker), the desired positions by ``n·inc``, and
        the parabolic marker adjustment loops until settled (each pass
        moves a marker at most one position, exactly as the sequential
        algorithm would). This is what makes ``Histogram.observe``'s
        amortized cost O(log n) per sample instead of O(markers)."""
        q = self._q
        i0 = 0
        n_all = len(batch)
        while len(q) < 5 and i0 < n_all:
            bisect.insort(q, batch[i0])
            i0 += 1
        if i0 == n_all:
            return
        batch = batch[i0:] if i0 else batch
        n = len(batch)
        pos, des = self._pos, self._des
        if batch[0] < q[0]:
            q[0] = batch[0]
        if batch[-1] >= q[4]:
            q[4] = batch[-1]
        for i in (1, 2, 3):
            pos[i] += bisect.bisect_left(batch, q[i])
        pos[4] += n
        inc = self._inc
        for i in (1, 2, 3, 4):
            des[i] += n * inc[i]
        # marker adjustment: moderate drift replays the classic
        # single-step parabolic move (matching sequential P² dynamics,
        # which keeps the estimator unbiased on skewed data); only a
        # bursty drift > _JUMP_AT positions (e.g. a monotone stream)
        # takes one linear multi-position jump so the settle stays O(1)
        # per batch instead of O(drift).
        moved = True
        passes = 5   # chained headroom can need a second pass; 5 is ample
        while moved and passes > 0:
            moved = False
            passes -= 1
            for i in (1, 2, 3):
                d = des[i] - pos[i]
                if d >= 1 and pos[i + 1] - pos[i] > 1:
                    s, room = 1, pos[i + 1] - pos[i] - 1
                elif d <= -1 and pos[i - 1] - pos[i] < -1:
                    s, room = -1, pos[i] - pos[i - 1] - 1
                else:
                    continue
                j = min(math.floor(abs(d)), room)
                if j > _JUMP_AT:
                    q[i] = q[i] + s * j * (q[i + s] - q[i]) / (
                        pos[i + s] - pos[i])
                    pos[i] += s * j
                else:
                    for _ in range(int(j)):
                        qn = self._parabolic(i, s)
                        if not (q[i - 1] < qn < q[i + 1]):  # linear fallback
                            qn = q[i] + s * (q[i + s] - q[i]) / (
                                pos[i + s] - pos[i])
                        q[i] = qn
                        pos[i] += s
                        if s * (pos[i + s] - pos[i]) <= 1:
                            break  # hit the blocking neighbor
                moved = True

    def _parabolic(self, i: int, s: int) -> float:
        q, n = self._q, self._pos
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    @property
    def value(self) -> float:
        q = self._q
        if not q:
            return math.nan
        if len(q) < 5:
            return q[min(int(self.p * len(q)), len(q) - 1)]
        return q[2]


_DRAIN_AT = 64   # pending observations before an amortized P²/bucket drain
_P2_CHUNK = 32   # stream-order sub-chunk fed to each P² estimator per step;
                 # larger chunks are cheaper but bias the markers on skewed
                 # distributions (rank counts go stale within a chunk)
_JUMP_AT = 8     # marker drift beyond which settle takes a linear multi-jump


class Histogram:
    kind = "histogram"
    __slots__ = ("name", "_count", "_sum", "_min", "_max", "_quants",
                 "_buckets", "_pending", "_lock")

    def __init__(self, name: str, quantiles: tuple[float, ...] = (0.5, 0.95, 0.99)):
        self.name = name
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._quants = {p: _P2Quantile(p) for p in quantiles}
        self._buckets: dict[int, int] = {}
        self._pending: list[float] = []
        self._lock = threading.Lock()

    def observe(self, x: float):
        """O(1) fast path: count/sum/min/max update inline; the expensive
        P² marker walk and bucket assignment are deferred to a batched
        drain every ``_DRAIN_AT`` observations (or any read)."""
        x = float(x)
        with self._lock:
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x
            pend = self._pending
            pend.append(x)
            if len(pend) >= _DRAIN_AT:
                self._drain_locked()

    def _drain_locked(self):
        pend = self._pending
        if not pend:
            return
        buckets = self._buckets
        ceil, log2, scale = math.ceil, math.log2, BUCKET_SCALE
        for x in pend:
            i = ceil(log2(x) * scale) if x > 0.0 else UNDERFLOW_BUCKET
            buckets[i] = buckets.get(i, 0) + 1
        # P² feed preserves arrival order at _P2_CHUNK granularity: each
        # chunk is sorted in isolation (a globally sorted drain would be
        # a monotone feed — the estimator's worst case).
        quants = self._quants.values()
        for k in range(0, len(pend), _P2_CHUNK):
            chunk = sorted(pend[k:k + _P2_CHUNK])
            for q in quants:
                q.observe_sorted(chunk)
        self._pending = []

    def _flush(self):
        with self._lock:
            self._drain_locked()

    # restored (merged) histograms carry moments + buckets but no P²
    # marker state — obs/merge.py installs them via this hook
    def _restore_state(self, count: int, sum_: float, min_: float,
                       max_: float, buckets: dict[int, int]):
        with self._lock:
            self._count = int(count)
            self._sum = float(sum_)
            self._min = float(min_)
            self._max = float(max_)
            self._buckets = {int(k): int(v) for k, v in buckets.items()}
            self._pending = []
            self._quants = {p: _P2Quantile(p) for p in self._quants}

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min

    @property
    def max(self) -> float:
        return self._max

    def buckets(self) -> dict[int, int]:
        """Exponential bucket counts (index → count; see bucket_upper)."""
        self._flush()
        with self._lock:
            return dict(self._buckets)

    def quantile(self, p: float) -> float:
        """P² estimate while live; bucket estimate for restored/merged
        histograms (whose P² markers never saw the raw stream)."""
        self._flush()
        est = self._quants[p]
        if est._q:
            return est.value
        return bucket_quantile(self._buckets, self._count, p,
                               self._min, self._max)

    def summary(self) -> dict[str, float]:
        self._flush()
        if not self._count:
            return {"count": 0}
        out = {"count": self._count, "sum": self._sum,
               "mean": self._sum / self._count,
               "min": self._min, "max": self._max}
        for p, est in self._quants.items():
            out[f"p{int(round(p * 100))}"] = (
                est.value if est._q
                else bucket_quantile(self._buckets, self._count, p,
                                     self._min, self._max))
        return out

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def read(self):
        return self.summary()


class MetricsRegistry:
    """Create-or-get instrument registry. A name is bound to one instrument
    kind for the registry's lifetime — re-registering with a different kind
    raises (two subsystems silently sharing a name is a bug)."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        check_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(label(name, **labels) if labels else name, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(label(name, **labels) if labels else name, Gauge)

    def histogram(self, name: str,
                  quantiles: tuple[float, ...] = (0.5, 0.95, 0.99),
                  **labels) -> Histogram:
        return self._get(label(name, **labels) if labels else name,
                         Histogram, quantiles)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: scalar} for counters/gauges, {name: summary dict} for
        histograms — JSON-ready (the TelemetryWriter summary record)."""
        with self._lock:
            items = list(self._metrics.items())
        return {k: m.read() for k, m in items}

    def flat(self) -> dict[str, float]:
        """Fully-flat {name: float} view; histogram summaries expand to
        ``<name>/p50`` etc. (for console reporters / BENCH json)."""
        out: dict[str, float] = {}
        for k, m in self.snapshot().items():
            if isinstance(m, dict):
                for sk, sv in m.items():
                    out[f"{k}/{sk}"] = sv
            else:
                out[k] = m
        return out
