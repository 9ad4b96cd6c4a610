"""Deterministic fault injection for the checkpoint path (DESIGN.md §13);
a copy of ``repro/ft/chaos.py`` on the port's ``ft.manifest``.

A :class:`ChaosSchedule` is a list of events, written
``<action>@<site>:<n>``::

    crash@frame:3      raise InjectedCrash just before the 3rd frame commit
    torn@frame:5       write a truncated frame AT THE FINAL PATH, then crash
    crash@manifest:2   crash before the 2nd manifest's atomic rename
    crash@head:1       crash before the 1st HEAD update (manifest already
                       committed — the "after rename" matrix case)
    crash@step:12      raise from the training loop when step 12 begins
    sigterm@step:7     deliver SIGTERM to this process at step 7 (the
                       PreemptionGuard path: graceful save, then stop)

Counters are *lifetime* counts across the whole run of a schedule —
restarts share the same :class:`ChaosIO`, so "the 3rd frame write" means
the 3rd ever, not the 3rd since the last recovery. That is what makes a
schedule a reproducible script: same seed, same code → same crash points.

``ChaosSchedule.seeded`` derives a schedule from an integer seed with a
private deterministic PRNG (splitmix-style), so chaos tests can sweep
seeds without any global random state.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import signal
from typing import Mapping

from repro_torch.checkpoint import safetensors_io as st
from repro_torch.ft.manifest import FileIO

_ACTIONS = ("crash", "torn", "sigterm")
_IO_SITES = ("frame", "manifest", "head")
_SITES = _IO_SITES + ("step",)


class InjectedCrash(RuntimeError):
    """Stands in for SIGKILL: the process abandons everything mid-flight.

    Tests (and the launch driver) treat it as process death — nothing
    that would normally run on the way out (final save, GC, flushes) may
    run after it."""


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    action: str   # crash | torn | sigterm
    site: str     # frame | manifest | head | step
    n: int        # 1-based lifetime count at which the event fires

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}")
        if self.site not in _SITES:
            raise ValueError(f"unknown chaos site {self.site!r}")
        if self.action == "torn" and self.site != "frame":
            raise ValueError("torn writes only make sense at site 'frame'")
        if self.action == "sigterm" and self.site != "step":
            raise ValueError("sigterm fires at site 'step'")
        if self.n < 1:
            raise ValueError("event counts are 1-based")

    def __str__(self):
        return f"{self.action}@{self.site}:{self.n}"


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return z ^ (z >> 31)


class ChaosSchedule:
    def __init__(self, events: list[ChaosEvent]):
        self.events = list(events)

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        events = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            try:
                action, _, rest = tok.partition("@")
                site, _, n = rest.partition(":")
                events.append(ChaosEvent(action, site, int(n)))
            except ValueError as e:
                raise ValueError(f"bad chaos event {tok!r}: {e}") from None
        return cls(events)

    @classmethod
    def seeded(cls, seed: int, n_events: int = 5,
               max_count: int = 8) -> "ChaosSchedule":
        """Deterministic schedule: ≥1 torn frame write, the rest spread
        over the io sites, counts in [1, max_count]."""
        state = seed
        events = []
        for i in range(n_events):
            state = _splitmix(state)
            if i == 0:
                action, site = "torn", "frame"
            else:
                site = _IO_SITES[state % len(_IO_SITES)]
                action = "crash"
            n = 1 + (_splitmix(state ^ i) % max_count)
            events.append(ChaosEvent(action, site, n))
        # dedupe identical (site, n) pairs — one event per call site
        seen, out = set(), []
        for ev in events:
            if (ev.site, ev.n) not in seen:
                seen.add((ev.site, ev.n))
                out.append(ev)
        return cls(out)

    def __str__(self):
        return ",".join(str(e) for e in self.events)

    def io_events(self) -> list[ChaosEvent]:
        return [e for e in self.events if e.site in _IO_SITES]

    def step_events(self) -> list[ChaosEvent]:
        return [e for e in self.events if e.site == "step"]


class StepChaos:
    """Training-loop side of a schedule: call ``on_step(step)`` at the top
    of every step. Fires each step event at most once (lifetime)."""

    def __init__(self, schedule: ChaosSchedule):
        self._events = {e.n: e for e in schedule.step_events()}
        self.fired: list[ChaosEvent] = []

    def on_step(self, step: int):
        ev = self._events.pop(int(step), None)
        if ev is None:
            return
        self.fired.append(ev)
        if ev.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return  # the PreemptionGuard turns this into a graceful stop
        raise InjectedCrash(f"chaos: {ev}")


class ChaosIO(FileIO):
    """FileIO that counts every persistence call site and injects the
    schedule's io events. Lifetime counters survive recovery — share one
    instance across all restarts of a chaos run."""

    def __init__(self, schedule: ChaosSchedule, durable: bool = False):
        # chaos runs live in test tmpdirs; skip fsync for speed unless asked
        self.durable = durable
        self.counts = {s: 0 for s in _IO_SITES}
        self.fired: list[ChaosEvent] = []
        self._events: dict[tuple[str, int], ChaosEvent] = {}
        for ev in schedule.io_events():
            self._events[(ev.site, ev.n)] = ev

    def _tick(self, site: str) -> ChaosEvent | None:
        self.counts[site] += 1
        ev = self._events.pop((site, self.counts[site]), None)
        if ev is not None:
            self.fired.append(ev)
        return ev

    def write_frame(self, path: pathlib.Path, tensors: Mapping,
                    metadata: Mapping[str, str] | None = None
                    ) -> tuple[int, str]:
        ev = self._tick("frame")
        if ev is None:
            return super().write_frame(path, tensors, metadata)
        if ev.action == "torn":
            # simulate a torn in-place write: half the payload lands at the
            # FINAL path (no temp, no rename), then the process dies.
            data = st.dumps(tensors, metadata)
            with open(path, "wb") as f:  # reclint: disable=F001
                f.write(data[: max(1, len(data) // 2)])
            raise InjectedCrash(f"chaos: {ev} ({path.name})")
        raise InjectedCrash(f"chaos: {ev} ({path.name})")

    def write_manifest(self, path: pathlib.Path, data: bytes):
        ev = self._tick("manifest")
        if ev is not None:
            raise InjectedCrash(f"chaos: {ev} ({path.name})")
        super().write_manifest(path, data)

    def write_head(self, path: pathlib.Path, text: str):
        ev = self._tick("head")
        if ev is not None:
            raise InjectedCrash(f"chaos: {ev}")
        super().write_head(path, text)
