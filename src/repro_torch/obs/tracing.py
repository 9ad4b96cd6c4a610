"""Span-based step-phase tracing (DESIGN.md §9).

The train loop's wall-time decomposes into a fixed phase taxonomy:

    data_wait    blocked on the input iterator (AsyncLoader queue empty)
    pre_step     host-side step-edge work before the step
                 (tiered-store fill: host→HBM promotes + demotes)
    device_step  the step itself, incl. the device synchronise
    post_step    host-side step-edge work after the step (admission spill)
    checkpoint   saver hand-off / final blocking save
    eval         interleaved eval passes
    evict        staleness eviction windows
    autoscale    pipeline-controller decision + actuation (io/autoscale)

``Tracer.step(n)`` opens a per-step timeline; ``Tracer.span(name)`` timed
blocks inside it accumulate into that step's record, which is emitted as
one JSONL ``step`` record and folded into the registry's ``trace/<name>_s``
histograms. Spans outside a step (the final checkpoint) emit standalone
``span`` records. With ``profile=True`` each span additionally opens a
``torch.profiler.record_function`` range so the phases show up in
``torch.profiler`` / Perfetto traces next to the device's own events.

At 1,500+-accelerator scale this is what makes stragglers diagnosable:
the watchdog consumes ``StepTrace.spans`` and reports *which phase* was
slow, not just that the step was (NestPipe's observation, paper §2.4).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator

from repro_torch.obs.registry import MetricsRegistry, span_name
from repro_torch.obs.telemetry import TelemetryWriter

PHASES = ("data_wait", "pre_step", "device_step", "post_step",
          "checkpoint", "eval", "evict", "autoscale")


class StepTrace:
    """One step's phase timeline: span name → accumulated seconds."""

    __slots__ = ("step", "spans", "meta", "cancelled", "_t0")

    def __init__(self, step: int):
        self.step = step
        self.spans: dict[str, float] = {}
        self.meta: dict = {}
        self.cancelled = False
        self._t0 = time.perf_counter()

    def add(self, name: str, dur_s: float):
        self.spans[name] = self.spans.get(name, 0.0) + dur_s

    def annotate(self, **kv):
        """Attach extra fields to the emitted step record (loss, wall_s,
        straggler flag…)."""
        self.meta.update(kv)

    def cancel(self):
        """Suppress emission (the step never ran — iterator exhausted)."""
        self.cancelled = True

    def record(self) -> dict:
        return {"type": "step", "step": self.step,
                "dur_s": time.perf_counter() - self._t0,
                "spans": dict(self.spans), **self.meta}


def _profiler_annotation(name: str):
    try:
        from torch.profiler import record_function
        return record_function(f"repro/{name}")
    except Exception:  # profiler unavailable in this build
        return contextlib.nullcontext()


class Tracer:
    """Binds spans to a registry (histograms) and a writer (JSONL)."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 writer: TelemetryWriter | None = None,
                 profile: bool = False):
        self.registry = registry
        self.writer = writer
        self.profile = profile
        self._current: StepTrace | None = None

    @contextlib.contextmanager
    def step(self, step: int) -> Iterator[StepTrace]:
        st = StepTrace(step)
        prev, self._current = self._current, st
        try:
            yield st
        finally:
            self._current = prev
            if not st.cancelled and self.writer is not None:
                self.writer.emit(st.record())

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        hist_name = span_name(name)  # spans + metrics share one namespace
        prof = _profiler_annotation(name) if self.profile else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
            if self.registry is not None:
                self.registry.histogram(hist_name).observe(dt)
            if self._current is not None:
                self._current.add(name, dt)
            elif self.writer is not None:  # standalone span
                self.writer.emit({"type": "span", "name": name, "dur_s": dt})


class NullTracer(Tracer):
    """Zero-cost stand-in when telemetry is disabled: spans still time via
    perf_counter (needed by the watchdog's phase attribution) but nothing
    is exported."""

    def __init__(self):
        super().__init__(registry=None, writer=None, profile=False)
