"""End-to-end train driver (twin of ``repro/launch/train.py``): --arch/--shape
→ cell → Trainer loop, on the card unless ``--device cpu``.

It runs the reduced (smoke) config of the arch, as the reference does on
its CPU container. The flags are the reference's, with ``--device`` added;
``main`` parses them and calls ``run(args, arch)`` with the smoke config,
and a caller that wants another config (published widths, a cut vocab)
calls ``run`` itself.

With ``--data-dir`` (recsys archs) batches stream from a ColumnIO table
through an AsyncLoader instead of the synthetic generator; ``--autoscale``
then closes the loop with a ``PipelineController`` (DESIGN.md §10) that
resizes the reader pool and rebalances shards from the registry's
step-edge signals. The loader's batches stay on the host: the train step
moves each to the card, so the copy is timed in ``device_step``, not in the
``data_wait`` the controller reads.

Two deliberate differences from the reference:

  * the reference builds its loader before it resumes, and checkpoints the
    producer-side ``cursor``; the twin builds the loader after the resume,
    from the restored consumer-side ``position``, and checkpoints that, so
    a resumed run (one loader thread) trains on the batches an
    uninterrupted run would have;
  * the synthesized table's row groups hold at least one batch (the
    reference writes 256-row groups, which give no whole batch, and so no
    batch at all, for ``--batch`` above 256).

``--ckpt-mode delta`` (recsys archs, with ``--ckpt-dir``) writes incremental
frames on a manifest chain: a tiered cell marks its dirty rows through its
``storage_hooks``, any other through an ``ft.FTTrainerHooks`` on the cell's
engine, and a chaos schedule's frame, manifest and head events fire in the
checkpointer's ``ChaosIO``.

An LM arch (``--arch qwen2.5-3b`` and the other transformers) trains its
``train_4k`` cell at ``--batch`` x ``--seq-len``; with ``--ckpt-dir`` it
checkpoints the reference's LM train state (the stacked-layer transformer,
AdamW's moments alike, the token rows), so ``--resume`` goes on from
either package's checkpoint, after an injected crash or a SIGTERM as a
recsys run does. ``--ckpt-mode delta`` and ``--data-dir`` stay recsys
paths, as in the reference.

``--arch gin-tu`` trains the GIN cell of ``--shape`` (default ``molecule``
at the smoke sizes of ``smoke_shape``, the reference's) on its
``make_batch`` graphs; checkpoints hold its state tree (the reference's
layout), and over several ranks each rank takes its slice of every global
batch (``launch/gnn_cell.py``).

Over several ranks (a recsys arch on synthetic batches), under torchrun:
each rank takes its slice of every global batch and holds one shard of
every table (``launch/recsys_cell.py``); ``--dist-backend`` names the
backend (``gloo``: the CPU with ``--device cpu``, or ranks sharing one
card; ``nccl``: one card a rank). Rank 0 alone writes the telemetry, the
checkpoints and the console; a checkpoint holds the dense state and the
union of the ranks' exported rows, and on resume each rank imports the rows
it owns (``checkpoint/sharded.py``). Either layout resumes at any number of
ranks: one device resuming a checkpoint that ranks wrote imports every row
and goes on in that layout; ranks resuming a one-device checkpoint export
its rows from its state tree (each rank holds the whole table once for
that). ``--data-dir``, ``--autoscale``,
``--ckpt-mode delta`` and the LM archs are refused there, as the reference
refuses ``--data-dir`` on more than one device; ``gin-tu`` runs there too.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \\
      --steps 100 --batch 256 --ckpt-dir /tmp/ckpt [--resume] [--device cpu]
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch dlrm-mlperf --dist-backend gloo --device cpu
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.core import comm
from repro_torch.ft.chaos import InjectedCrash
from repro_torch.launch import mesh
from repro_torch.launch.cells import build_arch_cell
from repro_torch.launch.common import resolve_device
from repro_torch.pipelines import TrainConfig, Trainer

CHAOS_EXIT = 42  # an injected crash is "the process died here" — not an error
ROWS_PER_GROUP = 256  # the reference's row groups for a synthesized table


def smoke_shape(arch, shape_name: str | None, batch: int, seq_len: int) -> ShapeCell:
    fam = arch.family
    if fam == "lm":
        return ShapeCell(shape_name or "train_4k", "train",
                         {"seq_len": seq_len, "global_batch": batch})
    if fam == "recsys":
        return ShapeCell(shape_name or "train_batch", "train", {"batch": batch})
    return ShapeCell(shape_name or "molecule", "graph_batch",
                     {"n_nodes": 12, "n_edges": 24, "batch": batch,
                      "d_feat": 16, "n_classes": 2})


def _with_step_chaos(stream, chaos, start: int):
    """Fire the schedule's step events as the trainer pulls batches: the
    batch yielded k-th becomes trainer step ``start + k``."""
    step = start
    for batch in stream:
        step += 1
        chaos.on_step(step)
        yield batch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=ARCH_IDS)
    p.add_argument("--shape", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--use-pallas", action="store_true",
                   help="accepted for the reference's command lines: the port "
                        "always runs its CUDA kernels on the card (and their "
                        "plain versions on the CPU)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; no CPU fallback)")
    p.add_argument("--dist-backend", choices=mesh.BACKENDS, default=None,
                   help="the process group's backend under torchrun (WORLD_SIZE > 1): "
                        "gloo (the CPU, or ranks sharing one card) or nccl (one card a rank)")
    p.add_argument("--telemetry", default=None, metavar="PATH",
                   help="write a JSONL step-phase trace (DESIGN.md §9)")
    p.add_argument("--console-every", type=int, default=0,
                   help="print a registry report every N steps")
    p.add_argument("--profile-spans", action="store_true",
                   help="bridge step-phase spans to torch.profiler")
    # ColumnIO data path + pipeline autoscaler (DESIGN.md §10)
    p.add_argument("--data-dir", default=None, metavar="DIR",
                   help="stream batches from a ColumnIO table (synthesized "
                        "there on first use; recsys archs only)")
    p.add_argument("--data-rows", type=int, default=8192,
                   help="rows to synthesize when --data-dir is empty")
    p.add_argument("--data-parts", type=int, default=4,
                   help="part files when synthesizing the table")
    p.add_argument("--io-threads", type=int, default=2,
                   help="initial AsyncLoader reader threads")
    p.add_argument("--prefetch", type=int, default=8,
                   help="AsyncLoader prefetch-queue capacity")
    p.add_argument("--autoscale", action="store_true",
                   help="closed-loop reader-pool autoscaler (needs --data-dir)")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="reader-pool floor")
    p.add_argument("--autoscale-max", type=int, default=8,
                   help="reader-pool ceiling")
    # fault tolerance (DESIGN.md §13)
    p.add_argument("--ckpt-mode", choices=("full", "delta"), default="full",
                   help="full = sharded snapshot saver; delta = incremental "
                        "dirty-row frames (needs --ckpt-dir)")
    p.add_argument("--chaos-schedule", default=None, metavar="SPEC",
                   help="deterministic fault injection, e.g. "
                        "'crash@step:12,sigterm@step:40' (frame, manifest "
                        "and head sites fire only in delta mode) "
                        f"(an injected crash exits {CHAOS_EXIT})")
    # cross-process telemetry (DESIGN.md §12)
    p.add_argument("--worker-id", default=None, metavar="ID",
                   help="worker id stamped on telemetry snapshots")
    p.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                   help="emit a mergeable registry snapshot every N steps "
                        "(needs --telemetry; 0 = off)")
    p.add_argument("--prometheus-port", type=int, default=None, metavar="P",
                   help="serve GET /metrics for scraping (0 = ephemeral)")
    p.add_argument("--aggregate", nargs="*", default=None, metavar="GLOB",
                   help="tail peer telemetry files; publishes agg/* and "
                        "gates the autoscaler on the fleet queue")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.snapshot_every and not args.telemetry:
        p.error("--snapshot-every requires --telemetry (snapshots ride the "
                "JSONL trace)")
    if args.autoscale and not args.data_dir:
        p.error("--autoscale requires --data-dir (nothing to scale without "
                "an AsyncLoader)")
    run(args, get_config(args.arch, smoke=True))
    return 0


def _make_loader(args, arch, cursor):
    """The AsyncLoader over ``--data-dir`` (synthesized there on first
    use), its budgets the cell's, from the restored position."""
    from repro_torch.io import datagen
    from repro_torch.io.columnio import AsyncLoader, BatchSpec
    from repro_torch.launch.recsys_cell import _ids_per_row, _model_mod

    table = pathlib.Path(args.data_dir)
    model_specs = _model_mod(arch.arch_id).feature_specs(arch.model)
    if not any(table.glob("part-*.col")):
        gens = datagen.gen_for_specs(model_specs, seq_mean_len=4.0)
        datagen.write_table(table, gens, n_rows=args.data_rows,
                            rows_per_group=max(ROWS_PER_GROUP, args.batch),
                            n_parts=args.data_parts)
        print(f"synthesized table: {table} ({args.data_rows} rows, "
              f"{args.data_parts} parts)")
    # the loader pads every column to the cell's budget (batch * ids-per-row)
    bspec = BatchSpec(batch_rows=args.batch,
                      nnz_budget={s.name: args.batch * _ids_per_row(s)
                                  for s in model_specs})
    cursor = cursor or {}
    return AsyncLoader(table, bspec, n_threads=args.io_threads,
                       prefetch=args.prefetch, loop=True,
                       start_part=cursor.get("part", 0),
                       start_group=cursor.get("group", 0),
                       start_batch=cursor.get("batch", 0))


def _refuse_multi_rank(args, arch) -> None:
    """What the multi-rank driver does not run (ROADMAP A6b)."""
    refused = {"--data-dir": args.data_dir, "--autoscale": args.autoscale,
               "--ckpt-mode delta": args.ckpt_mode == "delta",
               f"the {arch.family} family": arch.family not in ("recsys", "gnn")}
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise ValueError(f"not run over several ranks: {', '.join(bad)}")
    if args.dist_backend is None:
        raise ValueError("WORLD_SIZE > 1: name the backend with --dist-backend (gloo or nccl)")


def _rows_hooks(args, arch, shape, cell, group, device):
    """The checkpoint hooks of the layout ranks write (the dense state in
    the tree, every rank's rows gathered into the extra file), or None for
    the one-device layout (the rows in the tree). Ranks always take it, and
    so does one device resuming a checkpoint that ranks wrote. Ranks
    resuming a one-device checkpoint read its rows from its tree."""
    from repro_torch.checkpoint import sharded
    from repro_torch.launch import recsys_cell

    found = sharded.layout(args.ckpt_dir) if args.resume else None
    if group is None and found != "rows":
        return None
    cell.state_tree, cell.load_state_tree = recsys_cell.dense_state_tree, recsys_cell.load_dense_state_tree
    one_device = None
    if found == "tree":
        one_device = lambda: sharded.rows_of_tree(build_arch_cell(arch, shape, device=device), args.ckpt_dir)  # noqa: E731
    return sharded.ShardedRowsHooks(cell.engine, group, one_device)


def run(args: argparse.Namespace, arch):
    """Train ``arch`` (an ``ArchConfig``) as the flags say; returns the
    ``TrainResult`` and the ``PipelineController`` (None without
    ``--autoscale``). An injected crash ends the process with CHAOS_EXIT.
    Under torchrun with WORLD_SIZE > 1 it joins the process group first
    and leaves it at the end."""
    if args.ckpt_mode == "delta" and not args.ckpt_dir:
        raise ValueError("--ckpt-mode delta requires --ckpt-dir")
    if args.data_dir and arch.family != "recsys":
        raise ValueError("--data-dir is a recsys-family data path")
    if args.ckpt_mode == "delta" and arch.family != "recsys":
        raise ValueError("--ckpt-mode delta writes engine rows: a recsys-family checkpoint")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _refuse_multi_rank(args, arch)
        group = mesh.init_group(args.dist_backend)
        try:
            return _run(args, arch, group, mesh.rank_device(args.dist_backend, args.device))
        finally:
            mesh.close()
    return _run(args, arch, None, resolve_device(args.device))


def _run(args, arch, group, device):
    lead = comm.rank(group) == 0  # the rank that writes and prints
    say = print if lead else (lambda *a, **k: None)
    shape = smoke_shape(arch, args.shape, args.batch, args.seq_len)
    cell = build_arch_cell(arch, shape, device=device, group=group)
    if args.ckpt_dir and cell.state_tree is None:
        raise NotImplementedError(
            f"checkpoints of the {arch.family} train cell are not ported yet")

    hooks = ft_io = step_chaos = None
    if args.chaos_schedule:
        from repro_torch.ft import ChaosIO, ChaosSchedule, StepChaos
        sched = ChaosSchedule.parse(args.chaos_schedule)
        step_chaos = StepChaos(sched)
        if args.ckpt_mode == "delta":  # io sites fire only in delta mode
            ft_io = ChaosIO(sched)
        say(f"chaos schedule: {sched}")
    if args.ckpt_mode == "delta":
        from repro_torch.ft import FTTrainerHooks
        hooks = cell.storage_hooks or FTTrainerHooks(cell.engine, cell.ids_fn, state_key="sparse")
    if args.ckpt_dir and args.ckpt_mode != "delta" and arch.family == "recsys":
        hooks = _rows_hooks(args, arch, shape, cell, group, device)

    tcfg = TrainConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, resume=args.resume,
                       ckpt_writer=lead,
                       log_every=args.log_every,
                       telemetry_path=args.telemetry if lead else None,
                       console_every=args.console_every if lead else 0,
                       profile_spans=args.profile_spans,
                       worker=args.worker_id,
                       snapshot_every=args.snapshot_every if lead else 0,
                       ft_mode=args.ckpt_mode, ft_io=ft_io)
    trainer = Trainer(cell, tcfg, hooks=hooks)
    exporter = None
    if args.prometheus_port is not None and lead:
        exporter = obs.PrometheusExporter(trainer.registry,
                                          port=args.prometheus_port)
        say(f"prometheus: serving /metrics on port {exporter.start()}")

    state = cell.init_state()
    state, start, cursor = trainer.try_resume(state)
    if hasattr(hooks, "track"):
        hooks.track(state)
    if start:
        say(f"resumed from step {start} (cursor={cursor})")

    loader = controller = None
    if args.data_dir:
        loader = _make_loader(args, arch, cursor)
        if args.autoscale:
            from repro_torch.io.autoscale import AutoscaleConfig, PipelineController
            aggregator = None
            if args.aggregate is not None:
                aggregator = obs.TelemetryAggregator()
                for pat in args.aggregate:
                    aggregator.discover(pat)
            controller = PipelineController(
                loader, AutoscaleConfig(min_readers=args.autoscale_min,
                                        max_readers=args.autoscale_max),
                aggregator=aggregator)
            trainer.controller = controller

    def batches():
        s = args.seed + start
        while True:
            yield cell.make_batch(s)
            s += 1

    stream = iter(loader) if loader is not None else batches()
    if step_chaos is not None:
        stream = _with_step_chaos(stream, step_chaos, start)
    cursor_fn = ((lambda: loader.position) if loader is not None
                 else (lambda: {"part": 0, "group": 0}))
    try:
        res = trainer.run(state, stream, start_step=start,
                          cursor_fn=cursor_fn, install_signals=True)
    except InjectedCrash as e:
        # stands in for SIGKILL: nothing that would normally run on the
        # way out (final save, GC, loader drain) may run after it
        say(f"CHAOS: {e}", flush=True)
        os._exit(CHAOS_EXIT)
    if loader is not None:
        loader.stop()
    if exporter is not None:
        exporter.stop()
    for m in res.metrics_history[-5:]:
        say({k: round(v, 5) if isinstance(v, float) else v for k, v in m.items()})
    say(f"ran {res.steps_run} steps"
          + (f", resumed from {res.resumed_from}" if res.resumed_from else "")
          + (", PREEMPTED" if res.preempted else ""))
    if res.straggler_events:
        say(f"straggler events: {len(res.straggler_events)}")
        for ev in res.straggler_events[-3:]:
            say(f"  step {ev.step}: {ev.wall_s*1e3:.1f}ms "
                  f"(thresh {ev.threshold*1e3:.1f}ms, phase={ev.phase})")
    # phase timeline summary from the unified registry (DESIGN.md §9)
    snap = res.registry.snapshot()
    for name in sorted(snap):
        if name.startswith("trace/") and isinstance(snap[name], dict) \
                and snap[name].get("count"):
            s = snap[name]
            say(f"{name:28s} p50={s['p50']*1e3:8.3f}ms "
                  f"p99={s['p99']*1e3:8.3f}ms total={s['sum']:.3f}s")
    if controller is not None:
        say(f"autoscale: {len(controller.actions_log)} actions, "
              f"final readers={loader.n_readers}")
        for s, act in controller.actions_log:
            say(f"  step {s}: {act}")
    if args.telemetry:
        say(f"telemetry trace: {args.telemetry}")
    return res, controller


if __name__ == "__main__":
    sys.exit(main())
