"""Twin of ``benchmarks/table4_obs.py``: what the observability layer costs.

Full telemetry (registry counters, step-phase spans, the JSONL trace and
the watchdog's phase attribution) is meant to cost under 5% of step wall
time. Two measurements:

  * end to end: the port's Trainer runs the MSE cell of
    ``repro_torch.examples.train_mse`` at the example's batch of 128,
    telemetry ON (a JSONL trace) and OFF (no writer; the spans still run,
    the Trainer's floor): the best of ``repeats`` runs each. The reference
    times its wide-deep smoke cell (not ported, ROADMAP A5) OFF and then
    ON, each on a cell of its own; here both Trainers drive one cell and
    their runs alternate, because at this batch the step's time moves more
    between runs than telemetry costs.
  * micro: the cost of one primitive (counter.inc, histogram.observe, a
    span, one JSONL emit, a snapshot capture and 3-way merge).

Run: PYTHONPATH=src python -m repro_torch.benchmarks.table4_obs \\
         [--steps 50] [--repeats 3] [--out FILE] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

from repro_torch import obs
from repro_torch.examples import train_mse
from repro_torch.launch.common import resolve_device
from repro_torch.pipelines import TrainConfig, Trainer

MICRO_N = 100_000


def steps_per_s(workdir: pathlib.Path, device, steps: int, repeats: int) -> dict[bool, list[float]]:
    """{telemetry on: [steps/s of each timed run]}: one cell, one Trainer
    with telemetry and one without, each warmed by a run, then ``repeats``
    pairs of timed runs in alternating order (off-on, on-off, ...), so that
    neither side always runs first on a warmer host."""
    cell = train_mse.MSECell(device, batch=train_mse.BATCH)
    # the batches are drawn once, on the host; the step moves each to the device
    batches = [train_mse.to_batch(train_mse.batch_arrays(cell.specs, train_mse.BATCH, s), "cpu")
               for s in range(steps)]
    trainers = {on: Trainer(cell, TrainConfig(total_steps=steps, log_every=10, watchdog=True,
                                              telemetry_path=str(workdir / "trace.jsonl") if on else None),
                            registry=obs.MetricsRegistry())
                for on in (False, True)}
    state = cell.init_state()
    for tr in trainers.values():  # warm
        state = tr.run(state, iter(batches)).state
    rates: dict[bool, list[float]] = {False: [], True: []}
    for i in range(repeats):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            res = trainers[on].run(state, iter(batches))
            dt = time.perf_counter() - t0
            state = res.state
            assert res.steps_run == steps
            rates[on].append(steps / dt)
    trainers[True].writer.close()
    return rates


def micro(n: int = MICRO_N) -> dict[str, float]:
    reg = obs.MetricsRegistry()
    out = {}

    c = reg.counter("bench/counter")
    t0 = time.perf_counter()
    for _ in range(n):
        c.inc()
    out["counter_inc_ns"] = (time.perf_counter() - t0) / n * 1e9

    h = reg.histogram("bench/hist")
    t0 = time.perf_counter()
    for i in range(n):
        h.observe(i * 1e-6)
    out["histogram_observe_ns"] = (time.perf_counter() - t0) / n * 1e9

    tracer = obs.Tracer(reg, writer=None)
    m = n // 10
    t0 = time.perf_counter()
    for _ in range(m):
        with tracer.span("device_step"):
            pass
    out["span_ns"] = (time.perf_counter() - t0) / m * 1e9

    with tempfile.TemporaryDirectory() as td:
        w = obs.TelemetryWriter(pathlib.Path(td) / "t.jsonl")
        rec = {"type": "step", "step": 1, "spans": {"data_wait": 0.001, "device_step": 0.004}}
        t0 = time.perf_counter()
        for _ in range(m):
            w.emit(rec)
        out["jsonl_emit_ns"] = (time.perf_counter() - t0) / m * 1e9
        w.close()

    # the aggregator's hot path: capture → serialize → 3-way merge
    sreg = obs.MetricsRegistry()
    sreg.counter("train/steps_total").inc(1000)
    sreg.gauge("io/queue_depth").set(5.0)
    sh = sreg.histogram("trace/device_step_s")
    for i in range(512):
        sh.observe(1e-3 + i * 1e-6)
    k = 200
    t0 = time.perf_counter()
    for _ in range(k):
        s = obs.RegistrySnapshot.capture(sreg, worker="w0", t=0.0)
        obs.merge_snapshots([s, s, s]).to_json_str()
    out["snapshot_merge3_us"] = (time.perf_counter() - t0) / k * 1e6
    return out


def run(steps: int = 50, repeats: int = 3, device=None, out: pathlib.Path | None = None,
        micro_n: int = MICRO_N) -> dict:
    device = resolve_device(device)
    print("observability: instrumentation overhead (telemetry ON vs OFF, same cell)")
    mic = micro(micro_n)
    for k, v in mic.items():
        print(f"  micro {k:24s} {v:12.3f} {k.rsplit('_', 1)[-1]}/op")
    with tempfile.TemporaryDirectory() as td:
        rates = steps_per_s(pathlib.Path(td), device, steps, repeats)
        n_records = len(obs.read_jsonl(pathlib.Path(td) / "trace.jsonl"))
    base, full = max(rates[False]), max(rates[True])
    overhead = max(0.0, 1.0 - full / base)
    print(f"  telemetry OFF  {base:.3f} steps/s")
    print(f"  telemetry ON   {full:.3f} steps/s   ({n_records} JSONL records)")
    print(f"  overhead       {overhead * 100:.3f} %  (budget: < 5%)")
    result = {"cell": f"repro_torch.examples.train_mse.MSECell (batch {train_mse.BATCH})", "device": str(device),
              "steps": steps, "repeats": repeats, "base_steps_per_s": base,
              "telemetry_steps_per_s": full, "overhead_fraction": overhead,
              "runs_steps_per_s": {"off": rates[False], "on": rates[True]},
              "overhead_budget": 0.05, "jsonl_records": n_records, "micro": mic}
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(result, indent=2) + "\n")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None, help="where the cell runs (default: the card)")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="write the numbers here as JSON")
    args = ap.parse_args(argv)
    return run(args.steps, args.repeats, args.device, args.out)


if __name__ == "__main__":
    main()
