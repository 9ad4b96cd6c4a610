"""repro_torch.obs — the observability layer (port of ``repro/obs``,
DESIGN.md §9): the modules the training loop reports through.

  * ``MetricsRegistry`` — counters / gauges / streaming histograms under
    ``subsystem/metric`` names (registry.py, a copy).
  * ``RegistrySnapshot`` / ``merge_snapshots`` — versioned, mergeable
    cross-process snapshots (merge.py, a copy).
  * ``Tracer`` — step-phase span tracing for the train loop, with an
    optional ``torch.profiler.record_function`` bridge (tracing.py).
  * ``TelemetryWriter`` / ``ConsoleReporter`` — rotating JSONL export and
    periodic human-readable reporting (telemetry.py, a copy).
  * ``AnomalyDetector`` — rolling median/MAD per-phase gate feeding the
    watchdog ring buffer (anomaly.py).
  * ``record_mbu`` / ``record_roofline`` — fold kernel-quality numbers
    into the same namespace (mbu_bridge.py, a copy).
  * ``TelemetryAggregator`` — tails per-worker JSONL, merges into one
    registry, derives ``agg/skew/<phase>`` + straggler attribution
    (aggregator.py, a copy).
  * ``render`` / ``PrometheusExporter`` — Prometheus text exposition +
    stdlib scrape endpoint (prometheus.py, a copy).

A process-wide default registry lets far-apart components (an AsyncLoader
thread, the AsyncSaver, the Trainer) share one sink without plumbing;
tests that need isolation construct their own ``MetricsRegistry`` and pass
it down, or call ``reset_default_registry``.
"""
from __future__ import annotations

from repro_torch.obs.aggregator import TelemetryAggregator  # noqa: F401
from repro_torch.obs.anomaly import AnomalyDetector  # noqa: F401
from repro_torch.obs.mbu_bridge import record_mbu, record_roofline  # noqa: F401
from repro_torch.obs.merge import (  # noqa: F401
    SNAPSHOT_VERSION, RegistrySnapshot, merge_snapshots,
)
from repro_torch.obs.prometheus import (  # noqa: F401
    PrometheusExporter, mangle, render, validate_exposition,
)
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, NAME_RE, check_name,
    label, sanitize, span_name, valid_name,
)
from repro_torch.obs.telemetry import (  # noqa: F401
    ConsoleReporter, TelemetryWriter, read_jsonl, tail_jsonl,
)
from repro_torch.obs.tracing import PHASES, StepTrace, Tracer  # noqa: F401

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default_registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _default_registry
    _default_registry = reg
    return reg


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (test isolation)."""
    return set_registry(MetricsRegistry())
