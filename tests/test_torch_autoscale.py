"""The port's pipeline autoscaler (``repro_torch.io.autoscale``) against the
JAX package's (``repro.io.autoscale``) on the CPU: every scripted
``decide()`` trace of tests/test_autoscale.py gives the same actions and
states in both, ``SimPipeline``/``simulate`` give the same exact results on
the same calibration, ``PipelineController`` applies the same actions to a
scripted loader, and the port's ``AsyncLoader`` keeps every row through its
elastic actuators. No test depends on wall-clock time or thread timing."""
import dataclasses
import math

import numpy as np
import pytest

from repro import obs as j_obs
from repro.io import autoscale as j_as
from repro_torch import obs as t_obs
from repro_torch.io import autoscale as t_as
from repro_torch.io import columnio as t_cio

NAN = math.nan


def _sig(pkg, step, wait=0.0, depth=0, cap=8, n=2, ewma=None, shards=None, parts=None,
         p95=NAN, agg_depth=NAN, agg_cap=0):
    return pkg.Signals(
        step=step, data_wait_s=wait, queue_depth=depth, queue_capacity=cap, n_readers=n,
        reader_service_ewma_s=ewma if ewma is not None else {0: 0.01, 1: 0.01},
        reader_shards=shards if shards is not None else {0: (0, 2), 1: (1, 3)},
        part_service_ewma_s=parts or {}, data_wait_p95_s=p95,
        agg_queue_depth=agg_depth, agg_queue_capacity=agg_cap)


def _act(a) -> tuple:
    return (a.kind, *dataclasses.astuple(a))


_HOT = dict(n=4, ewma={0: 0.09, 1: 0.01, 2: 0.02, 3: 0.015},
            shards={0: (0, 4), 1: (1, 5), 2: (2, 6), 3: (3, 7)}, parts={0: 0.05, 4: 0.01})
_OUTRANK = dict(n=3, ewma={0: 0.09, 1: 0.01, 2: 0.01}, shards={0: (0, 3), 1: (1, 4), 2: (2, 5)},
                parts={0: 0.05, 3: 0.01})

# (config, [(step, signal fields)]): the traces of tests/test_autoscale.py's
# TestDecideScripted and tests/test_obs_agg.py's TestAutoscaleAggGate
SCRIPTS = {
    "starved_scales_up": (dict(patience=3, cooldown_steps=5),
                          [(i, dict(wait=0.01)) for i in range(1, 11)]),
    "scale_up_max": (dict(patience=1, cooldown_steps=1, max_readers=2),
                     [(i, dict(wait=0.01, n=2)) for i in range(1, 6)]),
    "idle_scales_down": (dict(patience=3, cooldown_steps=5),
                         [(i, dict(depth=8)) for i in range(1, 5)]),
    "scale_down_min": (dict(patience=1, cooldown_steps=1, min_readers=2),
                       [(i, dict(depth=8, n=2)) for i in range(1, 6)]),
    "hot_shard_steals": (dict(patience=3, cooldown_steps=5, slow_reader_factor=3.0),
                         [(i, dict(wait=0.001, depth=4, **_HOT)) for i in range(1, 5)]),
    "steal_needs_two_shards": (dict(patience=1, cooldown_steps=1),
                               [(i, dict(wait=0.001, depth=4, ewma={0: 0.09, 1: 0.01},
                                         shards={0: (0,), 1: (1, 2, 3)})) for i in range(1, 6)]),
    "steal_outranks_scale_up": (dict(patience=2, cooldown_steps=3),
                                [(i, dict(wait=0.01, **_OUTRANK)) for i in range(1, 3)]),
    "flapping": (dict(patience=3, cooldown_steps=5),
                 [(i, dict(wait=0.01 if i % 2 else 0.0, depth=0 if i % 2 else 8)) for i in range(1, 41)]),
    "reversal_ratchet": (dict(patience=3, cooldown_steps=2, reversal_window=60),
                         [(i, dict(depth=8, n=2)) for i in range(1, 4)]
                         + [(i, dict(wait=0.01, n=1)) for i in range(4, 9)]
                         + [(i, dict(depth=8, n=2)) for i in range(9, 40)]),
    "p95_fallback": (dict(patience=2, cooldown_steps=2),
                     [(i, dict(wait=NAN, p95=0.02)) for i in range(1, 8)]),
    "fleet_healthy_gates": (dict(patience=3, cooldown_steps=5),
                            [(i, dict(wait=0.01, agg_depth=19.2, agg_cap=24)) for i in range(1, 9)]),
    "fleet_starved_confirms": (dict(patience=3, cooldown_steps=5),
                               [(i, dict(wait=0.01, agg_depth=2.0, agg_cap=24)) for i in range(1, 5)]),
}


def _run_script(pkg, name):
    cfg_kw, trace = SCRIPTS[name]
    cfg, st, out = pkg.AutoscaleConfig(**cfg_kw), pkg.ControllerState(), []
    states = []
    for step, kw in trace:
        acts, st = pkg.decide(_sig(pkg, step, **kw), st, cfg)
        out.extend((step, _act(a)) for a in acts)
        states.append(dataclasses.asdict(st))
    return out, states


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_decide_scripted_traces_equal(name):
    j_out, j_states = _run_script(j_as, name)
    t_out, t_states = _run_script(t_as, name)
    assert t_out == j_out
    assert t_states == j_states


def test_decide_scripts_are_not_vacuous():
    """The traces above reach every action kind and the ratchet."""
    kinds = {a[0] for name in SCRIPTS for _, a in _run_script(t_as, name)[0]}
    assert kinds == {"scale_up", "scale_down", "steal_shard"}
    assert _run_script(t_as, "reversal_ratchet")[1][-1]["floor"] == 2


PARTS = {p: (0.05 if p == 0 else 0.01) for p in range(8)}  # p0 is 5x slow
SIMS = {  # (part service, readers, queue capacity, consume s, steps, config or None)
    "two_readers": (PARTS, 2, 8, 0.004, 200, dict(slow_reader_factor=2.5, max_readers=6)),
    "four_readers": (PARTS, 4, 8, 0.0015, 300, dict(slow_reader_factor=2.5, max_readers=6)),
    "four_readers_fixed": (PARTS, 4, 8, 0.0015, 300, None),
    "overprovisioned": ({p: 0.001 for p in range(4)}, 4, 8, 0.01, 300, dict(min_readers=1, max_readers=8)),
    "blocked_producer": ({0: 0.001}, 1, 2, 0.1, 10, None),
    "table2_calibration": ({0: 3.2e-3, 1: 3.6e-4, 2: 3.7e-4, 3: 3.5e-4}, 1, 8, 4.8e-4, 400,
                           dict(min_readers=1, max_readers=4, starve_wait_s=0.25 * 4.8e-4,
                                idle_wait_s=0.02 * 4.8e-4)),
}


def _simulate(pkg, name):
    parts, n, cap, consume, steps, cfg = SIMS[name]
    r = pkg.simulate(pkg.SimPipeline(parts, n, cap, consume), steps,
                     pkg.AutoscaleConfig(**cfg) if cfg is not None else None)
    return {**r, "actions": [(s, _act(a)) for s, a in r["actions"]]}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_simulate_equal(name):
    j, t = _simulate(j_as, name), _simulate(t_as, name)
    assert t == j
    if SIMS[name][-1] is not None and name != "overprovisioned":
        assert t["actions"]  # the controller acted


class _ScriptedLoader:
    """A loader whose ``signals()`` returns the next scripted dict, and
    which records the actuator calls the controller makes."""

    def __init__(self, script):
        self.script = list(script)
        self.i = 0
        self.calls = []
        self.n_readers = script[0]["n_readers"]

    def signals(self):
        s = self.script[min(self.i, len(self.script) - 1)]
        self.i += 1
        return s

    def add_reader(self):
        self.calls.append(("add_reader",))
        self.n_readers += 1
        return self.n_readers - 1

    def remove_reader(self, rid=None):
        self.calls.append(("remove_reader", rid))
        self.n_readers -= 1
        return rid

    def reassign_shard(self, part, dst):
        self.calls.append(("reassign_shard", part, dst))
        return True


def _loader_script():
    base = dict(queue_capacity=8, part_service_ewma_s={0: 0.05, 2: 0.01})
    out = []
    for i in range(40):
        if i < 10:    # starved: an empty queue behind two even readers
            out.append(dict(base, queue_depth=0, n_readers=2, reader_service_ewma_s={0: 0.01, 1: 0.01},
                            reader_shards={0: (0, 2), 1: (1, 3)}))
        elif i < 22:  # reader 0 slow
            out.append(dict(base, queue_depth=4, n_readers=3,
                            reader_service_ewma_s={0: 0.09, 1: 0.01, 2: 0.012},
                            reader_shards={0: (0, 2), 1: (1,), 2: (3,)}))
        else:         # full and idle
            out.append(dict(base, queue_depth=8, n_readers=3,
                            reader_service_ewma_s={0: 0.01, 1: 0.01, 2: 0.01},
                            reader_shards={0: (0,), 1: (1, 2), 2: (3,)}))
    return out


@pytest.mark.parametrize("spans", ["span", "p95"])
def test_pipeline_controller_applies_the_same_actions(spans):
    script = _loader_script()
    waits = [0.01] * 10 + [0.001] * 12 + [0.0] * 18
    runs = {}
    for name, pkg, obs in (("j", j_as, j_obs), ("t", t_as, t_obs)):
        reg = obs.MetricsRegistry()
        loader = _ScriptedLoader(script)
        ctl = pkg.PipelineController(loader, pkg.AutoscaleConfig(patience=2, cooldown_steps=3), registry=reg)
        h = reg.histogram("trace/data_wait_s")
        for step, w in enumerate(waits, 1):
            h.observe(w)
            ctl.on_step(step, {"data_wait": w} if spans == "span" else None)
        runs[name] = dict(calls=loader.calls, log=[(s, _act(a)) for s, a in ctl.actions_log],
                          state=dataclasses.asdict(ctl.state),
                          metrics={k: v for k, v in reg.snapshot().items() if k.startswith("autoscale/")})
    assert runs["t"] == runs["j"]
    kinds = {a[0] for _, a in runs["t"]["log"]}
    assert {"scale_up", "steal_shard"} <= kinds


def _write_table(tmp_path, n_parts=4, n_groups=3, rows_per_group=64, slow_part=0, slow_mult=8):
    table = tmp_path / "tbl"
    table.mkdir()
    schema = [t_cio.ColumnSchema("ids", "int64", ragged=True)]
    rng = np.random.default_rng(0)
    total_rows = 0
    for pi in range(n_parts):
        k = 4 * (slow_mult if pi == slow_part else 1)
        with t_cio.ColumnWriter(table / f"part-{pi:05d}.col", schema) as w:
            for _ in range(n_groups):
                w.write_group({"ids": [rng.integers(0, 1 << 30, size=k).tolist()
                                       for _ in range(rows_per_group)]})
                total_rows += rows_per_group
    return table, total_rows


def test_elastic_actuators_preserve_every_row(tmp_path):
    """Every actuator mid-flight, then a drain: the rows are counted, and
    every part keeps a live owner (no timing is asserted)."""
    table, total_rows = _write_table(tmp_path)
    spec = t_cio.BatchSpec(batch_rows=32, nnz_budget={"ids": 32 * 40})
    loader = t_cio.AsyncLoader(table, spec, n_threads=1, prefetch=4, registry=t_obs.MetricsRegistry())
    try:
        it = iter(loader)
        rows = sum(next(it)["ids"].n_rows for _ in range(2))
        r1 = loader.add_reader()
        r2 = loader.add_reader()
        assert loader.reassign_shard(0, r2)
        assert loader.remove_reader(r1) == r1
        s = loader.signals()
        assert set(s) >= {"queue_depth", "queue_capacity", "n_readers", "reader_service_ewma_s",
                          "reader_shards", "part_service_ewma_s"}
        for b in it:
            rows += b["ids"].n_rows
        assert rows == total_rows
        assert loader.overflow == 0
    finally:
        loader.stop()


def test_controller_signals_read_the_port_loader(tmp_path):
    """``PipelineController.signals`` reads every field it needs from the
    port's loader (``reader_shards`` included)."""
    table, _ = _write_table(tmp_path)
    reg = t_obs.MetricsRegistry()
    spec = t_cio.BatchSpec(batch_rows=32, nnz_budget={"ids": 32 * 40})
    loader = t_cio.AsyncLoader(table, spec, n_threads=2, prefetch=4, loop=True, registry=reg)
    try:
        ctl = t_as.PipelineController(loader, registry=reg)
        sig = ctl.signals(1, {"data_wait": 0.0})
        assert sig.n_readers == 2 and sig.queue_capacity == 4
        assert sorted(p for ps in sig.reader_shards.values() for p in ps) == [0, 1, 2, 3]
    finally:
        loader.stop()
