"""Pipelines — the component that connects ColumnIO + Feature/Embedding
Engines + Optimizer + Saver into training workflows (paper §2.1), with the
1000+-node fault-tolerance posture of DESIGN.md §8:

  * checkpoint/restart     sharded async safetensors + data-cursor resume
  * preemption safety      SIGTERM → final checkpoint before exit
  * straggler mitigation   phase-attributed wall-time watchdog (EMA + kσ);
                           slow steps are logged with the PHASE that caused
                           them (data_wait vs host edges vs device step)
  * eviction windows       stale-feature eviction during continuous training
  * multistage             interleaved train/eval; online-learning windows

Observability (DESIGN.md §9): every step runs under ``obs.Tracer`` spans
(``data_wait`` / ``pre_step`` / ``device_step`` / ``post_step`` /
``checkpoint``), all counters land in one ``obs.MetricsRegistry``, and —
when ``TrainConfig.telemetry_path`` is set — each step emits a structured
JSONL record plus a final registry summary.

Port of ``repro/pipelines/trainer.py``. The step runs as the cell gives it
(PyTorch runs eagerly: no jit, no donation), and ``device_step`` ends in a
synchronise of the cell's device. A cell whose state is not a tree of
dicts, lists, tuples and tensors (an ``nn.Module`` inside) gives
``state_tree(state)`` and ``load_state_tree(state, tree)``: the checkpoint
holds that tree, in the reference's layout; so does the dense part of a
delta frame (``ft_mode="delta"``).
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import time
from typing import Any, Callable, Iterator, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import saver as saver_lib


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_last: int = 3
    n_ckpt_shards: int = 4
    resume: bool = True
    # False: a rank of a process group other than the writer; it takes part
    # in every save's collectives (the cell's state_tree, the hooks'
    # ckpt_extra) and writes nothing
    ckpt_writer: bool = True
    # straggler watchdog
    watchdog: bool = True
    watchdog_k: float = 4.0          # flag steps slower than EMA + k·σ
    watchdog_warmup: int = 8
    watchdog_max_events: int = 512   # event ring-buffer capacity
    # eviction (continuous training)
    evict_every: int = 0             # 0 = off
    evict_age_steps: int = 1000
    # eval interleave (multistage)
    eval_every: int = 0
    log_every: int = 10
    # observability (DESIGN.md §9)
    telemetry_path: str | None = None  # JSONL trace destination (None = off)
    console_every: int = 0             # periodic registry report (0 = off)
    profile_spans: bool = False        # bridge spans to torch.profiler
    # cross-process telemetry (DESIGN.md §12)
    worker: str | None = None          # worker id stamped on snapshots
    snapshot_every: int = 0            # emit mergeable registry snapshots
    # per-phase rolling median/MAD anomaly gate (obs/anomaly.py)
    anomaly: bool = True
    anomaly_k: float = 6.0
    anomaly_window: int = 64
    # fault tolerance (DESIGN.md §13): "delta" swaps the full-snapshot
    # AsyncSaver for ft.DeltaCheckpointer — incremental dirty-row frames
    # on a crash-consistent manifest chain
    ft_mode: str = "full"              # "full" | "delta"
    ft_max_chain_depth: int = 8        # deltas per base before compaction
    ft_compact_dirty_fraction: float = 0.5
    ft_keep_chains: int = 2            # committed chains GC retains
    ft_io: Any = None                  # ft.FileIO override (chaos harness)


class StragglerEvent(NamedTuple):
    step: int
    wall_s: float
    threshold: float
    phase: str | None = None   # slowest-vs-baseline phase, when known


class StragglerWatchdog:
    """EMA + kσ step-time anomaly detector (DESIGN.md §8), phase-aware.

    On a real pod this drives two mitigations: (a) report the slow host to
    the scheduler, (b) mark its IO shard so AsyncLoader's shared work queue
    re-balances. Here it records the events for tests/metrics.

    Fed the step's phase timeline (``StepTrace.spans``), a flagged event is
    *attributed*: the phase whose duration exceeds its own EMA baseline by
    the most is named — "step 412 was slow because data_wait", which is
    what makes a straggler actionable. Events live in a bounded ring buffer
    (a week-long online run must not grow host memory without bound);
    overflow is counted in ``dropped``.
    """

    def __init__(self, k: float = 4.0, warmup: int = 8, alpha: float = 0.1,
                 max_events: int = 512):
        self.k = k
        self.warmup = warmup
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: collections.deque[StragglerEvent] = collections.deque(
            maxlen=max_events)
        self.dropped = 0
        self._phase_mean: dict[str, float] = {}

    def _update_phases(self, phases: Mapping[str, float] | None):
        if not phases:
            return
        a = self.alpha
        for name, dur in phases.items():
            prev = self._phase_mean.get(name)
            self._phase_mean[name] = (dur if prev is None
                                      else (1 - a) * prev + a * dur)

    def attribute(self, phases: Mapping[str, float] | None) -> str | None:
        """Name the phase most above its own baseline (None if no data)."""
        if not phases:
            return None
        excess = {n: d - self._phase_mean.get(n, 0.0)
                  for n, d in phases.items()}
        return max(excess, key=excess.get)  # type: ignore[arg-type]

    def push(self, event: StragglerEvent):
        """Append to the bounded ring buffer, counting overflow. Shared
        entry point: the EMA gate below and the per-phase median/MAD
        detector (obs/anomaly.py) both land events here — one place to
        look for "what went wrong"."""
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(event)

    def observe(self, step: int, dt: float,
                phases: Mapping[str, float] | None = None) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EMA
            self.mean = dt if self.n == 1 else (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + self.alpha * (dt - self.mean) ** 2
            self._update_phases(phases)
            return False
        thresh = self.mean + self.k * max(np.sqrt(self.var), 0.05 * self.mean)
        slow = dt > thresh
        if slow:
            self.push(
                StragglerEvent(step, dt, float(thresh), self.attribute(phases)))
        else:  # only non-anomalous steps update the baseline
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + self.alpha * (dt - self.mean) ** 2
            self._update_phases(phases)
        return slow


class PreemptionGuard:
    """Signal → checkpoint-and-exit flag (preemption safety).

    Installs a handler for each signal in ``signals`` (SIGTERM by default —
    what schedulers send; pass ``(SIGTERM, SIGINT)`` to also catch Ctrl-C)
    and restores the previous handlers on ``restore()``. Restore is
    idempotent: a second call is a no-op.
    """

    def __init__(self, install: bool = True,
                 signals: tuple = (signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        if install:
            for sig in signals:
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)
        self._prev = {}


@dataclasses.dataclass
class TrainResult:
    state: Any
    steps_run: int
    metrics_history: list[dict]
    straggler_events: list
    resumed_from: int | None
    preempted: bool = False
    registry: Any = None          # obs.MetricsRegistry of the run


# hook-metric keys with these suffixes are occupancy/ratio gauges: a logged
# interval keeps their LAST value; everything else is a count and is SUMMED
# over the interval (so rows cover the whole interval, not just the logged
# step).
_GAUGE_SUFFIXES = ("_rows", "_rate")


class Trainer:
    """Drives a Cell's step function over a data stream with full FT.

    ``cell.step_fn`` has signature (state, batch) → (state, metrics) when
    ``cell.returns_state`` else (state, batch) → metrics (serve cells).
    ``cell.device``, where the cell has one, is synchronised after each
    step.

    ``registry`` defaults to the process-wide ``obs.get_registry()`` so the
    trainer shares a sink with the engine's tiered store, AsyncLoader and
    AsyncSaver without explicit plumbing.
    """

    def __init__(self, cell, cfg: TrainConfig,
                 evict_fn: Callable[[Any, int], Any] | None = None,
                 hooks: Any | None = None,
                 registry: obs.MetricsRegistry | None = None,
                 controller: Any | None = None):
        self.cell = cell
        self.cfg = cfg
        self.evict_fn = evict_fn
        # Step-edge hooks (e.g. storage.StorageTrainerHooks): pre_step /
        # post_step run OUTSIDE the step — that is where the tiered
        # embedding store moves rows host↔device (spill/fill, DESIGN.md §3)
        # and where its state joins the checkpoint (ckpt_extra/on_restore).
        self.hooks = hooks
        # Pipeline autoscaler (io.autoscale.PipelineController): called at
        # each step edge with the step's span timeline so it can react to
        # this step's data_wait, not a lagging aggregate (DESIGN.md §10).
        self.controller = controller
        self._step = cell.step_fn
        self.registry = registry if registry is not None else obs.get_registry()
        self.writer = (obs.TelemetryWriter(cfg.telemetry_path)
                       if cfg.telemetry_path else None)
        self.tracer = obs.Tracer(self.registry, self.writer,
                                 profile=cfg.profile_spans)
        self.reporter = (obs.ConsoleReporter(self.registry, cfg.console_every)
                         if cfg.console_every else None)
        self.saver = None
        self.ft = None
        if cfg.ft_mode == "delta":
            self._init_delta_ckpt()
        elif cfg.ft_mode != "full":
            raise ValueError(f"unknown ft_mode {cfg.ft_mode!r}")
        elif cfg.ckpt_dir and cfg.ckpt_writer:
            self.saver = saver_lib.AsyncSaver(cfg.ckpt_dir, cfg.n_ckpt_shards,
                                              cfg.keep_last,
                                              registry=self.registry)
        self.watchdog = StragglerWatchdog(cfg.watchdog_k, cfg.watchdog_warmup,
                                          max_events=cfg.watchdog_max_events)
        self.anomaly = (obs.AnomalyDetector(
            self.registry, window=cfg.anomaly_window, k=cfg.anomaly_k,
            watchdog=self.watchdog, writer=self.writer)
            if cfg.anomaly else None)
        # snapshot epoch: bumped to the resume step by run() so counters
        # from different process incarnations merge additively (§12/§13)
        self._epoch = 0

    def _init_delta_ckpt(self):
        """ft_mode="delta": dirty-row tracking + incremental frames on a
        crash-consistent manifest chain (DESIGN.md §13)."""
        from repro_torch import ft as ft_lib
        from repro_torch.core import write_log

        cfg = self.cfg
        engine = getattr(self.hooks, "engine", None)
        if cfg.ckpt_dir is None or engine is None:
            raise ValueError(
                "ft_mode='delta' needs ckpt_dir and engine-bearing hooks "
                "(storage.StorageTrainerHooks or ft.FTTrainerHooks)")
        tracker = ft_lib.DirtyTracker(registry=self.registry)
        if hasattr(self.hooks, "attach_tracker"):
            self.hooks.attach_tracker(tracker)
        write_log.set_observer(tracker)
        self.ft = ft_lib.DeltaCheckpointer(
            cfg.ckpt_dir, engine, tracker,
            sparse_key=getattr(self.hooks, "state_key", "sparse"),
            n_shards=cfg.n_ckpt_shards,
            max_chain_depth=cfg.ft_max_chain_depth,
            compact_dirty_fraction=cfg.ft_compact_dirty_fraction,
            keep_chains=cfg.ft_keep_chains,
            registry=self.registry, io=cfg.ft_io,
            state_tree=getattr(self.cell, "state_tree", None),
            load_state_tree=getattr(self.cell, "load_state_tree", None))

    def _emit_snapshot(self, step: int):
        """One mergeable registry snapshot record (the aggregator's input
        unit, DESIGN.md §12). The epoch distinguishes this process
        incarnation from pre-restart ones (counters reset at a resume, so
        the aggregator must SUM epochs, not take the newest)."""
        if self.writer is None:
            return
        worker = self.cfg.worker or "w0"
        snap = obs.RegistrySnapshot.capture(self.registry, worker=worker,
                                            epoch=self._epoch)
        self.writer.emit({"type": "snapshot", "step": step, "worker": worker,
                          "snapshot": snap.to_json()})

    # -- checkpoint glue ----------------------------------------------------
    def _state_tree(self, state):
        fn = getattr(self.cell, "state_tree", None)
        return fn(state) if fn is not None else state

    def _save(self, state, step: int, cursor: Mapping | None, blocking=False):
        cursor = {"part": 0, "group": 0, "batch": 0, **(cursor or {})}
        if self.ft is not None:
            with self.tracer.span("checkpoint"):
                self.ft.save(state, step, cursor=cursor)
            return
        if not self.cfg.ckpt_dir:
            return
        with self.tracer.span("checkpoint"):
            payload = {"state": self._state_tree(state),
                       "cursor": cursor,
                       "saved_step": np.int64(step)}
            extra = (self.hooks.ckpt_extra()
                     if self.hooks is not None and hasattr(self.hooks, "ckpt_extra")
                     else None)
            if self.saver is None:  # not the writing rank
                return
            self.saver.save(payload, step, extra_tensors=extra)
            if blocking:
                self.saver.wait()

    def try_resume(self, init_state) -> tuple[Any, int, Mapping | None]:
        """→ (state, start_step, data_cursor). Falls back to fresh init.

        Idempotent: resuming twice from the same chain/checkpoint yields
        the same (state, step) — recovery never mutates the chain."""
        if not (self.cfg.ckpt_dir and self.cfg.resume):
            return init_state, 0, None
        if self.ft is not None:
            if not self.ft.has_chain():
                return init_state, 0, None
            res = self.ft.recover(like_state=init_state)
            return res.state, int(res.step), res.cursor
        step = saver_lib.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return init_state, 0, None
        cursor = {"part": 0, "group": 0}
        if "cursor/batch" in saver_lib.leaf_names(self.cfg.ckpt_dir, step):
            cursor["batch"] = 0  # the reference's checkpoints have no batch
        like = {"state": self._state_tree(init_state), "cursor": cursor,
                "saved_step": np.int64(0)}
        restored = saver_lib.restore(self.cfg.ckpt_dir, like, step)
        load = getattr(self.cell, "load_state_tree", None)
        state = load(init_state, restored["state"]) if load is not None else restored["state"]
        if self.hooks is not None and hasattr(self.hooks, "on_restore"):
            extra = saver_lib.restore_extra(self.cfg.ckpt_dir, step)
            state = self.hooks.on_restore(state, extra)
        return (state, int(restored["saved_step"]),
                {k: int(v) for k, v in restored["cursor"].items()})

    def _sync(self):
        device = getattr(self.cell, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    # -- interval hook-metric accumulation ----------------------------------
    @staticmethod
    def _accumulate(interval: dict, hook_metrics: Mapping) -> None:
        for k, v in hook_metrics.items():
            if k.endswith(_GAUGE_SUFFIXES):
                interval[k] = float(v)
            else:
                interval[k] = interval.get(k, 0.0) + float(v)

    @staticmethod
    def _finalize_interval(interval: dict) -> dict:
        # ratio gauges are recomputed over the interval's sums, so a logged
        # row reports the interval hit-rate, not the last step's
        if "storage/hit_rate" in interval:
            lk = interval.get("storage/lookups", 0.0)
            interval["storage/hit_rate"] = (
                interval.get("storage/hits", 0.0) / lk if lk else 1.0)
        return interval

    # -- the loop -------------------------------------------------------------
    def run(self, state, batches: Iterator, start_step: int = 0,
            cursor_fn: Callable[[], Mapping] | None = None,
            eval_fn: Callable[[Any, int], Mapping] | None = None,
            install_signals: bool = False) -> TrainResult:
        cfg = self.cfg
        reg = self.registry
        guard = PreemptionGuard(install=install_signals)
        history: list[dict] = []
        interval: dict[str, float] = {}
        step = start_step
        preempted = False
        resumed_from = start_step if start_step else None
        self._epoch = start_step
        it = iter(batches)
        c_steps = reg.counter("trainer/steps")
        c_straggler = reg.counter("trainer/straggler_events")
        h_wall = reg.histogram("trainer/step_wall_s")
        g_step = reg.gauge("trainer/last_step")

        while step < cfg.total_steps:
            with self.tracer.step(step + 1) as st:
                with self.tracer.span("data_wait"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        st.cancel()
                        break
                t0 = time.perf_counter()
                hook_metrics: dict = {}
                if self.hooks is not None:
                    with self.tracer.span("pre_step"):
                        state, hook_metrics = self.hooks.pre_step(
                            state, batch, step + 1)
                with self.tracer.span("device_step"):
                    if self.cell.returns_state:
                        state, metrics = self._step(state, batch)
                    else:
                        metrics = self._step(state, batch)
                    self._sync()
                if self.hooks is not None:
                    with self.tracer.span("post_step"):
                        state, post_m = self.hooks.post_step(state, step + 1)
                    hook_metrics.update(post_m)
                dt = time.perf_counter() - t0
                step += 1

                c_steps.inc()
                h_wall.observe(dt)
                g_step.set(step)
                self._accumulate(interval, hook_metrics)

                slow = cfg.watchdog and self.watchdog.observe(
                    step, dt, st.spans)
                if slow:
                    c_straggler.inc()
                if self.anomaly is not None:
                    self.anomaly.observe_step(step, st.spans)
                m_scalar = {k: float(v) for k, v in metrics.items()
                            if (v.dim() if isinstance(v, torch.Tensor) else np.ndim(v)) == 0}
                st.annotate(wall_s=dt, straggler=bool(slow), metrics=m_scalar)
                if slow and self.watchdog.events:
                    st.annotate(straggler_phase=self.watchdog.events[-1].phase)

                if step % cfg.log_every == 0 or slow:
                    m = dict(m_scalar)
                    m.update(self._finalize_interval(interval))
                    interval = {}
                    m.update(step=step, wall_s=dt, straggler=bool(slow))
                    history.append(m)

                if self.controller is not None:
                    with self.tracer.span("autoscale"):
                        self.controller.on_step(step, st.spans)

                if (cfg.evict_every and self.evict_fn
                        and step % cfg.evict_every == 0):
                    with self.tracer.span("evict"):
                        state = self.evict_fn(
                            state, max(step - cfg.evict_age_steps, 0))

                if eval_fn and cfg.eval_every and step % cfg.eval_every == 0:
                    with self.tracer.span("eval"):
                        history.append(
                            {"step": step,
                             **{f"eval_{k}": v for k, v in
                                eval_fn(state, step).items()}})

                if cfg.ckpt_every and step % cfg.ckpt_every == 0:
                    self._save(state, step,
                               cursor_fn() if cursor_fn else None)

                if cfg.snapshot_every and step % cfg.snapshot_every == 0:
                    self._emit_snapshot(step)

            if self.reporter is not None:
                self.reporter.maybe_report(step)
            if guard.requested:
                preempted = True
                break

        # final (or preemption) checkpoint — blocking, then restore handlers
        self._save(state, step, cursor_fn() if cursor_fn else None, blocking=True)
        guard.restore()
        reg.gauge("trainer/straggler_events_dropped").set(self.watchdog.dropped)
        if cfg.snapshot_every:
            self._emit_snapshot(step)  # final state always lands a snapshot
        if self.writer is not None:
            self.writer.emit({"type": "summary", "steps_run": step - start_step,
                              "preempted": preempted,
                              "metrics": reg.snapshot()})
        return TrainResult(state=state, steps_run=step - start_step,
                           metrics_history=history,
                           straggler_events=list(self.watchdog.events),
                           resumed_from=resumed_from, preempted=preempted,
                           registry=reg)
