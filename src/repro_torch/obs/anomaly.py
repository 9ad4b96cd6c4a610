"""Rolling median/MAD anomaly detection over step-phase durations
(DESIGN.md §12).

The StragglerWatchdog (pipelines/trainer.py) flags slow *steps* against an
EMA+kσ baseline of total wall time. This module watches each *phase*
independently with a robust baseline: a rolling window of the last
``window`` durations per phase, flagging

    dur > median + k · max(1.4826 · MAD, rel_floor · median, abs_floor_s)

The 1.4826 factor makes the MAD a consistent σ estimate under normality;
the relative floor keeps the gate meaningful when a phase is so stable
its MAD is ~0 (a 5% blip is not an anomaly); the absolute floor (default
100 µs) mutes phases whose durations are pure scheduler noise. Median/MAD
(not mean/σ) so that the anomalies themselves — which stay in the window —
cannot drag the baseline: a 50%-contaminated window still attributes.

Each anomaly increments ``obs/anomaly/<phase>`` (and ``obs/anomaly/
total``), lands in the watchdog's bounded ring buffer as a phase-
attributed ``StragglerEvent`` (one place to look for "what went wrong"),
and emits a JSONL ``event`` record when a writer is attached.
"""
from __future__ import annotations

import collections
import statistics
from typing import Mapping

from .registry import MetricsRegistry, check_name

# consistency constant: MAD → σ under a normal baseline
MAD_SIGMA = 1.4826


class AnomalyDetector:
    """Per-phase rolling median/MAD gate over span durations.

    ``watchdog`` is any object with a ``push(event)`` ring buffer (the
    trainer's StragglerWatchdog); ``writer`` any object with ``emit``."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 window: int = 64, k: float = 6.0, min_samples: int = 16,
                 rel_floor: float = 0.05, abs_floor_s: float = 1e-4,
                 watchdog=None, writer=None):
        self.registry = registry
        self.window = int(window)
        self.k = float(k)
        self.min_samples = max(int(min_samples), 2)
        self.rel_floor = float(rel_floor)
        self.abs_floor_s = float(abs_floor_s)
        self.watchdog = watchdog
        self.writer = writer
        self._win: dict[str, collections.deque[float]] = {}
        self.total = 0

    def threshold(self, phase: str) -> float | None:
        """Current gate for ``phase`` (None until min_samples seen)."""
        win = self._win.get(phase)
        if win is None or len(win) < self.min_samples:
            return None
        med = statistics.median(win)
        mad = statistics.median(abs(x - med) for x in win)
        return med + self.k * max(MAD_SIGMA * mad, self.rel_floor * med,
                                  self.abs_floor_s)

    def observe_step(self, step: int, spans: Mapping[str, float]) -> list[dict]:
        """Feed one step's phase timeline; returns this step's anomalies
        (also counted / ring-buffered / emitted as side effects)."""
        anomalies: list[dict] = []
        for phase, dur in spans.items():
            thr = self.threshold(phase)
            win = self._win.get(phase)
            if win is None:
                win = self._win[phase] = collections.deque(maxlen=self.window)
            # anomalous durations enter the window too: the median/MAD
            # baseline tolerates them, and a persistent regime change
            # re-baselines within ~window/2 steps instead of never
            win.append(float(dur))
            if thr is None or dur <= thr:
                continue
            self.total += 1
            anomaly = {"type": "event", "event": "anomaly", "step": step,
                       "phase": phase, "dur_s": float(dur),
                       "threshold_s": float(thr)}
            anomalies.append(anomaly)
            if self.registry is not None:
                self.registry.counter(
                    check_name(f"obs/anomaly/{phase}")).inc()
                self.registry.counter("obs/anomaly/total").inc()
            if self.watchdog is not None:
                from repro_torch.pipelines.trainer import StragglerEvent
                self.watchdog.push(StragglerEvent(
                    step, float(dur), float(thr), phase))
            if self.writer is not None:
                self.writer.emit(anomaly)
        return anomalies
