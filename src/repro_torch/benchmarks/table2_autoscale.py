"""Twin of the ``--autoscale`` half of ``benchmarks/table2_e2e.py``: the
pipeline autoscaler, fixed reader pool against the closed loop, on a
calibrated ``SimPipeline`` (``repro_torch.io.autoscale``).

Real per-part read+decompress times over a synthetic slow-shard ColumnIO
table (written with the port's ``ColumnWriter``, read with its
``ColumnReader``) and a real measured compute step (the reference's
64-256-256-1 MLP in bf16 at batch 256, on the card, timed to a
``torch.cuda.synchronize``) calibrate the deterministic simulator, which
then replays the same workload with one fixed reader and under the
controller. Given one calibration the result is exact.

Run: PYTHONPATH=src python -m repro_torch.benchmarks.table2_autoscale \\
         [--steps 400] [--out FILE] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.io.autoscale import AutoscaleConfig, SimPipeline, simulate
from repro_torch.io.columnio import ColumnReader, ColumnSchema, ColumnWriter
from repro_torch.launch.common import resolve_device
from repro_torch.models.layers import MIXED, MLP


def write_slow_shard_table(table: pathlib.Path, n_parts=4, n_groups=4,
                           rows_per_group=1024, slow_part=0, slow_mult=8,
                           seed=0) -> pathlib.Path:
    """One part carries ``slow_mult``× the ids per row — a genuinely slower
    shard (more bytes to read + decompress), not a sleep."""
    table.mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    schema = [ColumnSchema("ids", dtype="int64", ragged=True)]
    for pi in range(n_parts):
        k = 16 * (slow_mult if pi == slow_part else 1)
        with ColumnWriter(table / f"part-{pi:05d}.col", schema) as w:
            for _ in range(n_groups):
                ids = r.integers(0, 1 << 30, size=(rows_per_group, k))
                w.write_group({"ids": ids.tolist()})
    return table


def calibrate_reads(table: pathlib.Path) -> dict[int, float]:
    """Real per-part mean group read+decompress seconds."""
    out = {}
    for pi, p in enumerate(sorted(table.glob("part-*.col"))):
        rd = ColumnReader(p)
        rd.read_group(0)  # touch the page cache once
        t0 = time.perf_counter()
        for gi in range(rd.n_groups):
            rd.read_group(gi)
        out[pi] = (time.perf_counter() - t0) / rd.n_groups
    return out


def calibrate_compute(device, iters: int = 30) -> float:
    """Real per-step seconds of the small DNN step (the consumer): the
    64-256-256-1 MLP in bf16 at batch 256."""
    mlp = MLP((64, 256, 256, 1), torch.Generator().manual_seed(0), device)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256, 64)).astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        torch.sum(mlp(x, MIXED))
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = torch.sum(mlp(x, MIXED))
        sync()
        del y
    return (time.perf_counter() - t0) / iters


def simulate_modes(part_service: dict[int, float], consume_s: float, steps: int) -> dict:
    """One fixed reader against the controller, on the same calibration
    (``benchmarks/table2_e2e.py::run_autoscale``'s settings)."""
    # waiting a quarter-step per step is starvation, a fiftieth is noise
    cfg = AutoscaleConfig(min_readers=1, max_readers=4,
                          starve_wait_s=0.25 * consume_s,
                          idle_wait_s=0.02 * consume_s)
    out = {}
    for mode in ("fixed", "autoscale"):
        sim = SimPipeline(part_service, n_readers=1, queue_capacity=8, consume_s=consume_s)
        r = simulate(sim, steps, cfg if mode == "autoscale" else None)
        out[mode] = {
            "steps": steps,
            "data_wait_total_s": r["total_wait_s"],
            "data_wait_last20_mean_s": r["mean_wait_last20"],
            "virtual_steps_per_s": steps / r["virtual_time_s"],
            "n_readers_final": r["n_readers"],
            "n_actions": len(r["actions"]),
            "actions": [(s, a.kind) for s, a in r["actions"]],
        }
    return out


def run(steps: int = 400, device=None, out: pathlib.Path | None = None) -> dict:
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="recis_as_") as td:
        part_service = calibrate_reads(write_slow_shard_table(pathlib.Path(td) / "table"))
    consume_s = calibrate_compute(device)
    result = {"calibration": {"part_service_ms": {str(k): v * 1e3 for k, v in part_service.items()},
                              "compute_ms": consume_s * 1e3, "device": str(device)},
              **simulate_modes(part_service, consume_s, steps)}
    print("pipeline autoscaler: fixed vs closed loop (calibrated SimPipeline)")
    print("calibration: " + ", ".join(f"part{k}={v * 1e3:.3f}ms" for k, v in part_service.items())
          + f", compute={consume_s * 1e3:.3f}ms on {device}")
    for mode in ("fixed", "autoscale"):
        s = result[mode]
        print(f"{mode:9s}: wait_total={s['data_wait_total_s'] * 1e3:.3f}ms "
              f"last20={s['data_wait_last20_mean_s'] * 1e3:.3f}ms "
              f"steps/s={s['virtual_steps_per_s']:.3f} readers={s['n_readers_final']} "
              f"actions={s['n_actions']}")
    if out is not None:
        pathlib.Path(out).write_text(json.dumps(result, indent=2) + "\n")
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400, help="simulated consumer steps")
    ap.add_argument("--device", default=None, help="where the compute step is timed (default: the card)")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="write the numbers here as JSON")
    args = ap.parse_args(argv)
    return run(args.steps, args.device, args.out)


if __name__ == "__main__":
    main()
