"""Closed-loop data-pipeline autoscaler (DESIGN.md §10); port of
``repro/io/autoscale.py``, a copy but for the ``obs`` it reports into. The
controller drives the port's ``io.columnio.AsyncLoader``, whose
``signals()`` gives the fields ``PipelineController.signals`` reads.

RecIS attributes most of its sparse-path wins to keeping the accelerator
fed; NestPipe makes the same point at 1,500+ accelerator scale — a static
reader/prefetch config leaves throughput on the table whenever one shard
is slow. This module closes the loop: the registry signals the trainer
already records (``trace/data_wait_s``, ``io/queue_depth``, per-reader
read+decompress EWMAs) *drive* the AsyncLoader's elastic reader pool at
step edges instead of just flagging stragglers.

Three action families:

  * **scale up**   — starved queue (data_wait high, prefetch queue low)
                     → add a reader thread, up to ``max_readers``;
  * **steal**      — one persistently-slow reader (service EWMA > k× the
                     pool median) → explicitly reassign one of its shards
                     to the fastest reader (work-stealing beyond the
                     deque-stealing default: ownership moves, so the
                     rebalance persists across loop epochs);
  * **scale down** — data_wait ≈ 0 with a full queue → drop a reader and
                     stop burning host CPU on prefetch nobody waits for.

The decision core is the PURE function ``decide(signals, state, cfg) →
(actions, state')`` — no clock, no threads, no registry access — so the
simulation test harness (``tests/test_autoscale.py``) can drive it from
scripted traces and assert exact action sequences with zero sleeps.
Oscillation is prevented by hysteresis: a condition must persist for
``patience`` consecutive step edges before acting, and after any action
the controller holds for ``cooldown_steps`` edges so the pipeline can
settle into the new configuration before being judged again.

``PipelineController`` binds the core to a live ``AsyncLoader`` + registry
(the Trainer calls ``on_step`` at each step edge); ``SimPipeline`` is the
deterministic fake-clock pipeline model shared by the tests and
``repro_torch.benchmarks.table2_autoscale``.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Mapping

from repro_torch import obs

_NEVER = -(10 ** 9)


# ---------------------------------------------------------------------------
# signals and actions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Signals:
    """One step-edge observation of the pipeline (all fields host-side)."""

    step: int
    data_wait_s: float                 # last step's trace/data_wait span
    queue_depth: int                   # io/queue_depth at the step edge
    queue_capacity: int
    n_readers: int
    reader_service_ewma_s: Mapping[int, float]   # rid → EWMA s/row-group
    reader_shards: Mapping[int, tuple[int, ...]]  # rid → owned part indices
    part_service_ewma_s: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    data_wait_p95_s: float = math.nan  # trace/data_wait_s p95 (fallback)
    # cross-worker aggregates (obs/aggregator.py agg/io/*) — the first
    # multi-host signal: nan/0 = no aggregator attached, purely local.
    agg_queue_depth: float = math.nan
    agg_queue_capacity: int = 0

    @property
    def wait_s(self) -> float:
        """Effective wait signal: the per-step span when present, else the
        registry p95 (e.g. a consumer that only samples the histogram)."""
        if not math.isnan(self.data_wait_s):
            return self.data_wait_s
        return 0.0 if math.isnan(self.data_wait_p95_s) else self.data_wait_p95_s

    @property
    def agg_queue_frac(self) -> float:
        """Fleet-wide queue fill fraction (nan when unavailable)."""
        if math.isnan(self.agg_queue_depth) or self.agg_queue_capacity <= 0:
            return math.nan
        return self.agg_queue_depth / self.agg_queue_capacity


@dataclasses.dataclass(frozen=True)
class ScaleUp:
    kind = "scale_up"


@dataclasses.dataclass(frozen=True)
class ScaleDown:
    rid: int
    kind = "scale_down"


@dataclasses.dataclass(frozen=True)
class StealShard:
    part: int
    src: int
    dst: int
    kind = "steal_shard"


Action = ScaleUp | ScaleDown | StealShard


# ---------------------------------------------------------------------------
# the pure controller core
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_readers: int = 1
    max_readers: int = 8
    starve_wait_s: float = 2e-3    # wait EWMA above this = starving
    idle_wait_s: float = 2e-4      # wait EWMA below this = overprovisioned
    low_queue_frac: float = 0.25   # queue below this fraction confirms starve
    high_queue_frac: float = 0.75  # queue above this fraction confirms idle
    slow_reader_factor: float = 3.0  # EWMA > k× median → steal a shard
    patience: int = 3              # consecutive edges before acting
    cooldown_steps: int = 5        # edges to hold after any action
    wait_alpha: float = 0.3        # EWMA smoothing of the wait signal
    # a reversal within this many edges of the reversed action ratchets the
    # floor/ceiling (see decide) — the anti-oscillation guard. Generous by
    # default: a starve→scale-up cycle is only detected after the prefetch
    # queue drains, which can lag the mistaken scale-down by many steps.
    reversal_window: int = 60


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Everything ``decide`` remembers between step edges (pure data)."""

    wait_ewma_s: float | None = None
    starved_streak: int = 0
    idle_streak: int = 0
    slow_streak: int = 0
    last_action_step: int = _NEVER
    last_action_kind: str | None = None
    # ratcheted bounds: a scale-up that reverses a recent scale-down proves
    # the lower size starves → floor rises; the mirror case lowers ceil.
    # Each reversal tightens [floor, ceil], so ping-ponging workloads
    # converge to a fixed size instead of oscillating forever.
    floor: int = 0
    ceil: int | None = None


def _slow_reader_plan(sig: Signals, cfg: AutoscaleConfig) -> StealShard | None:
    """A StealShard action if exactly-one-action rebalancing applies:
    slowest reader's EWMA > k× median, it owns ≥ 2 shards (something to
    give away), and a faster destination exists. The *cheapest* of its
    shards moves (by part EWMA) — the hot shard stays local, everything
    else is offloaded so the hot shard stops queueing behind cold work."""
    ewmas = dict(sig.reader_service_ewma_s)
    if len(ewmas) < 2:
        return None
    med = statistics.median(ewmas.values())
    src = max(ewmas, key=lambda r: (ewmas[r], r))
    if med <= 0 or ewmas[src] <= cfg.slow_reader_factor * med:
        return None
    owned = tuple(sig.reader_shards.get(src, ()))
    if len(owned) < 2:
        return None
    dst = min(ewmas, key=lambda r: (ewmas[r], r))
    if dst == src:
        return None
    part = min(owned,
               key=lambda p: (sig.part_service_ewma_s.get(p, math.inf), p))
    return StealShard(part=part, src=src, dst=dst)


def decide(sig: Signals, state: ControllerState,
           cfg: AutoscaleConfig = AutoscaleConfig(),
           ) -> tuple[tuple[Action, ...], ControllerState]:
    """Pure step-edge decision: (signals, state) → (actions, state').

    At most ONE action per edge — a control loop that moves one knob at a
    time is trivially convergent under cooldown, and the simulation tests
    assert the exact sequence. Streaks keep accumulating during cooldown,
    so a persistent condition fires on the first edge out of it.
    """
    a = cfg.wait_alpha
    wait = sig.wait_s
    ewma = wait if state.wait_ewma_s is None else (
        (1 - a) * state.wait_ewma_s + a * wait)

    cap = max(sig.queue_capacity, 1)
    frac = sig.queue_depth / cap
    starving = ewma > cfg.starve_wait_s and frac <= cfg.low_queue_frac
    idle = ewma < cfg.idle_wait_s and frac >= cfg.high_queue_frac
    # multi-host gate: when a cross-worker aggregate is present, sizing
    # actions additionally require the FLEET queue fraction to agree —
    # one worker's transient blip must not resize its pool while the rest
    # of the fleet is healthy (still a pure function of the signals).
    agg_frac = sig.agg_queue_frac
    if not math.isnan(agg_frac):
        starving = starving and agg_frac <= cfg.low_queue_frac
        idle = idle and agg_frac >= cfg.high_queue_frac
    steal = _slow_reader_plan(sig, cfg)

    st = dataclasses.replace(
        state,
        wait_ewma_s=ewma,
        starved_streak=state.starved_streak + 1 if starving else 0,
        idle_streak=state.idle_streak + 1 if idle else 0,
        slow_streak=state.slow_streak + 1 if steal is not None else 0,
    )
    if sig.step - state.last_action_step < cfg.cooldown_steps:
        return (), st  # hysteresis: hold after any action

    floor = max(cfg.min_readers, st.floor)
    ceil = cfg.max_readers if st.ceil is None else min(cfg.max_readers, st.ceil)
    action: Action | None = None
    if steal is not None and st.slow_streak >= cfg.patience:
        action = steal  # rebalance first: cheaper than a thread
    elif starving and st.starved_streak >= cfg.patience \
            and sig.n_readers < ceil:
        action = ScaleUp()
    elif idle and st.idle_streak >= cfg.patience and sig.n_readers > floor:
        action = ScaleDown(rid=max(sig.reader_shards, default=_NEVER))

    if action is None:
        return (), st

    # reversal ratchet: undoing a recent opposite action proves that size
    # was wrong — tighten the bound so we never revisit it.
    new_floor, new_ceil = st.floor, st.ceil
    recent = sig.step - state.last_action_step <= cfg.reversal_window
    if isinstance(action, ScaleUp) and recent \
            and state.last_action_kind == "scale_down":
        new_floor = max(new_floor, sig.n_readers + 1)
    if isinstance(action, ScaleDown) and recent \
            and state.last_action_kind == "scale_up":
        new_ceil = sig.n_readers - 1 if new_ceil is None \
            else min(new_ceil, sig.n_readers - 1)
    if new_ceil is not None and new_floor > new_ceil:
        new_ceil = new_floor  # bounds crossed: pin to the floor
    return (action,), dataclasses.replace(
        st, starved_streak=0, idle_streak=0, slow_streak=0,
        last_action_step=sig.step, last_action_kind=action.kind,
        floor=new_floor, ceil=new_ceil)


# ---------------------------------------------------------------------------
# live binding: loader + registry
# ---------------------------------------------------------------------------

class PipelineController:
    """Binds the pure core to an ``AsyncLoader`` and a MetricsRegistry.

    The Trainer calls ``on_step(step, spans)`` at each step edge (next to
    the StorageTrainerHooks); signals are read from ``loader.signals()``
    plus the step's ``data_wait`` span (p95 fallback from the registry's
    ``trace/data_wait_s``), actions are applied to the loader, and every
    decision is counted under the ``autoscale/`` namespace.
    """

    def __init__(self, loader, cfg: AutoscaleConfig = AutoscaleConfig(),
                 registry: obs.MetricsRegistry | None = None,
                 aggregator=None):
        self.loader = loader
        self.cfg = cfg
        self.state = ControllerState()
        self.registry = registry if registry is not None else obs.get_registry()
        # optional obs.TelemetryAggregator: polled at each step edge so the
        # fleet-wide agg/io/queue_* gauges gate sizing actions (decide)
        self.aggregator = aggregator
        reg = self.registry
        self._c_actions = reg.counter("autoscale/actions")
        self._c_kind = {k: reg.counter(f"autoscale/{k}")
                        for k in ("scale_up", "scale_down", "steal_shard")}
        self._g_readers = reg.gauge("autoscale/readers")
        self._g_wait = reg.gauge("autoscale/wait_ewma_s")
        self.actions_log: list[tuple[int, Action]] = []

    def signals(self, step: int,
                spans: Mapping[str, float] | None = None) -> Signals:
        s = self.loader.signals()
        h = self.registry.get("trace/data_wait_s")
        p95 = math.nan
        if h is not None and getattr(h, "count", 0):
            p95 = h.quantile(0.95)
        wait = math.nan if spans is None else float(spans.get("data_wait", 0.0))
        agg_depth, agg_cap = math.nan, 0
        if self.aggregator is not None:
            self.aggregator.refresh()
            agg_depth, agg_cap = self.aggregator.agg_queue()
        return Signals(
            step=step, data_wait_s=wait, data_wait_p95_s=p95,
            queue_depth=s["queue_depth"], queue_capacity=s["queue_capacity"],
            n_readers=s["n_readers"],
            reader_service_ewma_s=s["reader_service_ewma_s"],
            reader_shards=s["reader_shards"],
            part_service_ewma_s=s["part_service_ewma_s"],
            agg_queue_depth=agg_depth, agg_queue_capacity=agg_cap)

    def on_step(self, step: int,
                spans: Mapping[str, float] | None = None) -> tuple[Action, ...]:
        actions, self.state = decide(self.signals(step, spans),
                                     self.state, self.cfg)
        for act in actions:
            self.apply(act)
            self.actions_log.append((step, act))
            self._c_actions.inc()
            self._c_kind[act.kind].inc()
        self._g_readers.set(self.loader.n_readers)
        self._g_wait.set(self.state.wait_ewma_s or 0.0)
        return actions

    def apply(self, act: Action):
        if isinstance(act, ScaleUp):
            self.loader.add_reader()
        elif isinstance(act, ScaleDown):
            self.loader.remove_reader(act.rid if act.rid != _NEVER else None)
        elif isinstance(act, StealShard):
            self.loader.reassign_shard(act.part, act.dst)


# ---------------------------------------------------------------------------
# deterministic simulation harness (fake clock — no threads, no sleeps)
# ---------------------------------------------------------------------------

class SimPipeline:
    """Discrete-event model of AsyncLoader + consumer on a virtual clock.

    Readers own parts (round-robin start assignment, same as the real
    loader); each continuously produces one batch per owned part in
    round-robin order, taking ``part_service_s[p]`` virtual seconds per
    batch, blocking while the prefetch queue is full. The consumer pops
    one batch per step and then computes for ``consume_s``. ``data_wait``
    per step is exact queueing delay — everything is a pure function of
    the scripted inputs, so tests assert on it without wall-clock flake.

    Mirrors the loader's actuator semantics: ``add_reader`` pulls a fair
    share of shards from the most-loaded owners, ``remove_reader`` hands
    shards to the least-loaded survivors, ``reassign_shard`` moves
    ownership; service EWMAs use the loader's smoothing constant.
    """

    _ALPHA = 0.3  # keep in sync with columnio._EWMA_ALPHA

    def __init__(self, part_service_s: Mapping[int, float], n_readers: int,
                 queue_capacity: int = 8, consume_s: float = 0.01):
        self.part_service_s = dict(part_service_s)
        self.queue_capacity = queue_capacity
        self.consume_s = consume_s
        self.t = 0.0
        self.queue: list[float] = []       # enqueue times of queued batches
        self.slot_free_t = 0.0             # last consumer pop (slot freed)
        self.next_rid = 0
        self.readers: dict[int, dict] = {}
        self.shard_map: dict[int, int] = {}
        rids = [self._new_reader() for _ in range(n_readers)]
        for i, p in enumerate(sorted(self.part_service_s)):
            self.shard_map[p] = rids[i % len(rids)]
        self.data_wait_trace: list[float] = []

    # -- actuators (mirror AsyncLoader) ------------------------------------
    def _new_reader(self) -> int:
        rid = self.next_rid
        self.next_rid += 1
        # part: in-flight part (None = idle); pending: completion time of a
        # finished batch stuck behind a full queue (blocked producer)
        self.readers[rid] = {"busy_until": self.t, "cursor": 0, "ewma": None,
                             "part": None, "pending": None}
        return rid

    def _owned(self, rid: int) -> list[int]:
        return sorted(p for p, o in self.shard_map.items() if o == rid)

    def add_reader(self) -> int:
        rid = self._new_reader()
        share = max(1, len(self.part_service_s) // len(self.readers))
        while len(self._owned(rid)) < share:
            counts = {r: len(self._owned(r)) for r in self.readers if r != rid}
            donors = [(n, r) for r, n in counts.items() if n > 1]
            if not donors:
                break
            _, donor = max(donors)
            self.shard_map[max(self._owned(donor))] = rid
        return rid

    def remove_reader(self, rid: int | None = None):
        live = sorted(self.readers)
        if len(live) <= 1:
            return None
        if rid is None or rid not in self.readers:
            rid = live[-1]
        self.readers.pop(rid)
        survivors = sorted(self.readers)
        for p in self._owned(rid):
            dst = min(survivors, key=lambda s: (len(self._owned(s)), s))
            self.shard_map[p] = dst
        return rid

    def reassign_shard(self, part: int, dst: int) -> bool:
        if dst not in self.readers or part not in self.shard_map:
            return False
        self.shard_map[part] = dst
        return True

    @property
    def n_readers(self) -> int:
        return len(self.readers)

    # -- the virtual clock -------------------------------------------------
    def _start_next(self, rid: int, r: dict):
        owned = self._owned(rid)
        if not owned:
            r["part"] = None
            return
        r["part"] = owned[r["cursor"] % len(owned)]
        r["cursor"] += 1
        r["busy_until"] = r["busy_until"] + self.part_service_s[r["part"]]

    def _produce_until(self, t: float, first: bool = False):
        """Advance reader completions up to virtual time ``t``.

        A reader whose batch finishes against a full queue parks it in
        ``pending`` — its clock STOPS (blocked producer) and the batch is
        enqueued only when a consumer pop frees a slot (``slot_free_t``),
        at which point the reader resumes from that instant. With
        ``first=True`` it stops after the first enqueue (starved consumer
        waiting for exactly one batch — no future-stamped run-ahead).
        """
        n0 = len(self.queue)
        while not (first and len(self.queue) > n0):
            # start idle readers that (re)gained shards
            for rid, r in self.readers.items():
                if r["part"] is None and r["pending"] is None \
                        and self._owned(rid):
                    r["busy_until"] = max(r["busy_until"], self.t)
                    self._start_next(rid, r)
            # un-block parked batches as capacity allows
            while len(self.queue) < self.queue_capacity:
                pend = [(r["pending"], rid)
                        for rid, r in self.readers.items()
                        if r["pending"] is not None]
                if not pend:
                    break
                done, rid = min(pend)
                r = self.readers[rid]
                avail = max(done, self.slot_free_t)
                self.queue.append(avail)
                r["pending"] = None
                r["busy_until"] = avail
                self._start_next(rid, r)
            # advance the earliest in-flight completion ≤ t
            busy = [(r["busy_until"], rid) for rid, r in self.readers.items()
                    if r["part"] is not None]
            if not busy:
                return
            done, rid = min(busy)
            if done > t:
                return
            r = self.readers[rid]
            a = self._ALPHA
            svc = self.part_service_s[r["part"]]
            r["ewma"] = svc if r["ewma"] is None else (1 - a) * r["ewma"] + a * svc
            r["part"] = None
            if len(self.queue) < self.queue_capacity:
                self.queue.append(done)
                r["busy_until"] = done
                self._start_next(rid, r)
            else:
                r["pending"] = done  # blocked until a consumer pop

    def step(self) -> float:
        """Consume one batch; returns this step's exact data_wait seconds."""
        self._produce_until(self.t)
        if any(q <= self.t for q in self.queue):
            wait = 0.0
        else:
            self._produce_until(math.inf, first=True)
            if not self.queue:
                raise RuntimeError("no reader owns any shard")
            wait = max(0.0, min(self.queue) - self.t)
        ready = min(self.queue)
        self.queue.remove(ready)
        pop_t = max(self.t, ready)
        self.slot_free_t = pop_t
        self.t = pop_t + self.consume_s
        # the freed slot un-blocks stalled producers during the compute span
        self._produce_until(self.t)
        self.data_wait_trace.append(wait)
        return wait

    def signals(self, step: int, wait: float) -> Signals:
        shards = {rid: tuple(self._owned(rid)) for rid in self.readers}
        return Signals(
            step=step, data_wait_s=wait, queue_depth=len(self.queue),
            queue_capacity=self.queue_capacity, n_readers=len(self.readers),
            reader_service_ewma_s={rid: r["ewma"]
                                   for rid, r in self.readers.items()
                                   if r["ewma"] is not None},
            reader_shards=shards,
            part_service_ewma_s=dict(self.part_service_s))

    def apply(self, act: Action):
        if isinstance(act, ScaleUp):
            self.add_reader()
        elif isinstance(act, ScaleDown):
            self.remove_reader(act.rid if act.rid != _NEVER else None)
        elif isinstance(act, StealShard):
            self.reassign_shard(act.part, act.dst)


def simulate(sim: SimPipeline, steps: int,
             cfg: AutoscaleConfig | None = None) -> dict:
    """Run ``steps`` consumer steps, optionally under the controller.

    Returns {data_wait_trace, actions (list of (step, action)), n_readers,
    shard_map, mean_wait_last20} — the quantities the acceptance criteria
    assert on. Pure function of its inputs: same script, same result.
    """
    state = ControllerState()
    actions: list[tuple[int, Action]] = []
    for i in range(1, steps + 1):
        wait = sim.step()
        if cfg is not None:
            acts, state = decide(sim.signals(i, wait), state, cfg)
            for act in acts:
                sim.apply(act)
                actions.append((i, act))
    tail = sim.data_wait_trace[-20:]
    return {
        "data_wait_trace": list(sim.data_wait_trace),
        "actions": actions,
        "n_readers": sim.n_readers,
        "shard_map": dict(sim.shard_map),
        "mean_wait_last20": sum(tail) / len(tail) if tail else 0.0,
        "total_wait_s": sum(sim.data_wait_trace),
        "virtual_time_s": sim.t,
    }
