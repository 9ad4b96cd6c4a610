"""Prometheus text-exposition bridge (DESIGN.md §12); a copy of
``repro/obs/prometheus.py`` (it imports only the registry).

Renders a ``MetricsRegistry`` in Prometheus text format 0.0.4 for
scrape-based collection on real pods; the JSONL trace stays the source of
truth for per-step records. Three pieces:

  * :func:`mangle` — deterministic name map from the registry scheme
    (``storage/hits``) to Prometheus (``recis_storage_hits``). The map is
    lossy (``/`` and ``_`` both become ``_``): :func:`mangling_table`,
    :func:`render` and ``--selfcheck`` raise on a collision in the live
    registry.
  * :func:`render` — exposition text: counters as ``<name>_total``,
    gauges as-is, histograms as cumulative ``_bucket{le="..."}`` series
    (from the mergeable exponential buckets, upper bounds =
    ``registry.bucket_upper``) plus ``_sum``/``_count`` and P² quantile
    gauges under ``<name>{quantile="0.5"}``.
  * :func:`validate_exposition` — a strict stdlib parser for the subset
    we emit (TYPE/HELP comments, sample syntax, label syntax, cumulative
    le monotonicity, ``_count`` == ``+Inf`` bucket). Run by
    ``python -m repro_torch.obs.prometheus --selfcheck`` and by the scrape
    tests.
  * :class:`PrometheusExporter` — optional stdlib ``http.server`` scrape
    endpoint (``GET /metrics``), used by ``repro_torch.launch.train
    --prometheus-port``.
"""
from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import registry as _reg

PREFIX = "recis_"

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?[0-9]+))?$")
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def mangle(name: str) -> str:
    """Registry name → Prometheus metric name. Total and deterministic,
    but not injective: ``mangling_table`` raises on a collision."""
    return PREFIX + name.replace("/", "_")


def mangling_table(names) -> dict[str, str]:
    """{registry name → prometheus name}; raises on collision."""
    table: dict[str, str] = {}
    seen: dict[str, str] = {}
    for n in sorted(names):
        m = mangle(n)
        if m in seen:
            raise ValueError(
                f"prometheus name collision: {n!r} and {seen[m]!r} both "
                f"mangle to {m!r}")
        seen[m] = n
        table[n] = m
    return table


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def render(registry: "_reg.MetricsRegistry") -> str:
    """Exposition text (0.0.4) for every instrument in ``registry``."""
    with registry._lock:
        items = sorted(registry._metrics.items())
    mangling_table([n for n, _ in items])  # collision check on live names
    out: list[str] = []
    for name, m in items:
        pname = mangle(name)
        if m.kind == "counter":
            out.append(f"# HELP {pname}_total registry counter {name}")
            out.append(f"# TYPE {pname}_total counter")
            out.append(f"{pname}_total {_fmt(m.value)}")
        elif m.kind == "gauge":
            out.append(f"# HELP {pname} registry gauge {name}")
            out.append(f"# TYPE {pname} gauge")
            out.append(f"{pname} {_fmt(m.value)}")
        else:
            buckets = m.buckets()
            count, total = m.count, m.sum
            out.append(f"# HELP {pname} registry histogram {name}")
            out.append(f"# TYPE {pname} histogram")
            acc = 0
            for i in sorted(buckets):
                acc += buckets[i]
                le = _fmt(_reg.bucket_upper(i))
                out.append(f'{pname}_bucket{{le="{le}"}} {acc}')
            out.append(f'{pname}_bucket{{le="+Inf"}} {count}')
            out.append(f"{pname}_sum {_fmt(total)}")
            out.append(f"{pname}_count {count}")
            s = m.summary()
            for k, v in s.items():
                if k.startswith("p") and k[1:].isdigit():
                    q = int(k[1:]) / 100.0
                    out.append(f'{pname}{{quantile="{q}"}} {_fmt(v)}')
    return "\n".join(out) + "\n" if out else ""


def validate_exposition(text: str) -> list[str]:
    """Validate exposition text; returns a list of problems (empty = ok).

    Checks the subset of the 0.0.4 format we emit: line syntax, label
    syntax, TYPE-before-samples, no duplicate TYPE, histogram ``le``
    cumulative monotonicity, and ``_count`` == the ``+Inf`` bucket."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    hist: dict[str, dict] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                if not _METRIC_NAME_RE.match(parts[2]):
                    problems.append(f"line {ln}: bad metric name in {parts[1]}")
                elif parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3].split()[0] not in (
                            "counter", "gauge", "histogram", "summary",
                            "untyped"):
                        problems.append(f"line {ln}: bad TYPE")
                    elif parts[2] in typed:
                        problems.append(
                            f"line {ln}: duplicate TYPE for {parts[2]}")
                    else:
                        typed[parts[2]] = parts[3].split()[0]
            # other comments are legal and ignored
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {ln}: unparsable sample {line!r}")
            continue
        name, labels, value = m.group("name"), m.group("labels"), m.group(
            "value")
        if labels:
            for pair in _split_labels(labels):
                if not _LABEL_RE.match(pair):
                    problems.append(f"line {ln}: bad label {pair!r}")
        try:
            v = float(value)
        except ValueError:
            problems.append(f"line {ln}: bad value {value!r}")
            continue
        base = name
        for suffix in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                break
        family = base if base in typed else (
            name if name in typed else None)
        if family is None:
            problems.append(f"line {ln}: sample {name!r} precedes its TYPE")
            continue
        if typed.get(base) == "histogram" and name.endswith("_bucket"):
            le = _parse_le(labels or "")
            h = hist.setdefault(base, {"les": [], "counts": [], "count": None})
            if le is None:
                problems.append(f"line {ln}: histogram bucket without le")
            else:
                h["les"].append(le)
                h["counts"].append(v)
        elif typed.get(base) == "histogram" and name.endswith("_count"):
            hist.setdefault(base, {"les": [], "counts": [], "count": None})[
                "count"] = v
    for base, h in hist.items():
        les, counts = h["les"], h["counts"]
        if sorted(les) != les:
            problems.append(f"{base}: le bounds not sorted")
        if sorted(counts) != counts:
            problems.append(f"{base}: bucket counts not cumulative")
        if not les or not math.isinf(les[-1]):
            problems.append(f"{base}: missing +Inf bucket")
        elif h["count"] is not None and counts[-1] != h["count"]:
            problems.append(
                f"{base}: _count {h['count']} != +Inf bucket {counts[-1]}")
    return problems


def _split_labels(s: str) -> list[str]:
    # labels we emit never contain escaped quotes or commas in values,
    # but split safely on commas outside quotes anyway
    out, cur, inq = [], [], False
    for ch in s:
        if ch == '"':
            inq = not inq
            cur.append(ch)
        elif ch == "," and not inq:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [p.strip() for p in out if p.strip()]


def _parse_le(labels: str):
    for pair in _split_labels(labels):
        if pair.startswith("le="):
            raw = pair[3:].strip('"')
            try:
                return float(raw)
            except ValueError:
                return None
    return None


class _ScrapeHandler(BaseHTTPRequestHandler):
    # the exporter injects itself as server.exporter
    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = render(self.server.exporter.registry).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # silence per-scrape stderr noise
        pass


class PrometheusExporter:
    """Stdlib scrape endpoint: ``GET /metrics`` renders the registry.

    ``start`` binds (port 0 = ephemeral) and serves from a daemon thread;
    ``stop`` shuts down and joins. All cross-method state hand-off is
    lock-protected."""

    def __init__(self, registry: "_reg.MetricsRegistry", port: int = 0,
                 host: str = "127.0.0.1"):
        self.registry = registry
        self._host = host
        self._port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    def start(self) -> int:
        with self._lock:
            if self._server is not None:
                return self._server.server_address[1]
            srv = ThreadingHTTPServer((self._host, self._port),
                                      _ScrapeHandler)
            srv.exporter = self
            srv.daemon_threads = True
            t = threading.Thread(target=srv.serve_forever,
                                 name="prometheus-exporter", daemon=True)
            self._server = srv
            self._thread = t
        t.start()
        return srv.server_address[1]

    @property
    def port(self) -> int | None:
        with self._lock:
            return self._server.server_address[1] if self._server else None

    def stop(self):
        with self._lock:
            srv, t = self._server, self._thread
            self._server = None
            self._thread = None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if t is not None:
            t.join(timeout=5.0)


def _selfcheck() -> int:
    """Render a representative registry and validate it."""
    reg = _reg.MetricsRegistry()
    reg.counter("io/rows_read").inc(12345)
    reg.counter("storage/hits", shard=3).inc(7)
    reg.gauge("io/queue_depth").set(5)
    reg.gauge("agg/skew/device_step").set(1.25)
    h = reg.histogram("trace/device_step_s")
    for i in range(200):
        h.observe(0.001 * (1 + (i % 13)))
    h.observe(0.0)  # underflow bucket renders le="0.0"
    text = render(reg)
    problems = validate_exposition(text)
    # the canonical names from DESIGN.md §9 must also mangle collision-free
    mangling_table([
        "trainer/step_wall_s", "trainer/steps", "storage/hits",
        "storage/misses", "io/queue_depth", "io/rows_read", "ckpt/save_s",
        "mbu/flash_attention", "trace/data_wait_s", "trace/device_step_s",
        "agg/skew/device_step", "obs/anomaly/device_step",
    ])
    for p in problems:
        print(f"prometheus selfcheck: {p}")
    if problems:
        return 1
    print(f"prometheus selfcheck: OK ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--selfcheck", action="store_true",
                    help="render+validate a representative registry")
    args = ap.parse_args()
    if args.selfcheck:
        raise SystemExit(_selfcheck())
    ap.error("nothing to do (use --selfcheck)")
