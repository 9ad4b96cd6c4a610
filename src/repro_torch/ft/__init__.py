"""repro_torch.ft — fault tolerance for sparse training (port of
``repro/ft``, DESIGN.md §13).

Five parts, one invariant:

  dirty.py      which rows changed this checkpoint interval
  delta.py      base + chained delta frames (incremental checkpoints)
  manifest.py   crash-consistent manifest chain + GC
  chaos.py      seeded deterministic fault injection
  recovery.py   chain replay → ``engine.import_rows`` → resumed Trainer

The invariant: for any prefix of a crash schedule, recovery returns the
newest fully-committed save, bit-identical to an uninterrupted run's
state at that step, at any device count.
"""
from repro_torch.ft.chaos import (ChaosEvent, ChaosIO, ChaosSchedule, InjectedCrash,
                                  StepChaos)
from repro_torch.ft.delta import (DeltaCheckpointer, export_rows_subset,
                                  flatten_tree, live_row_count, unflatten_like)
from repro_torch.ft.dirty import DirtyInterval, DirtyTracker
from repro_torch.ft.hooks import FTTrainerHooks
from repro_torch.ft.manifest import FileIO, Manifest, commit, gc, load_chain
from repro_torch.ft.recovery import RecoveryResult, recover, replay_rows

__all__ = [
    "ChaosEvent", "ChaosIO", "ChaosSchedule", "InjectedCrash", "StepChaos",
    "DeltaCheckpointer", "export_rows_subset", "flatten_tree",
    "live_row_count", "unflatten_like",
    "DirtyInterval", "DirtyTracker", "FTTrainerHooks",
    "FileIO", "Manifest", "commit", "gc", "load_chain",
    "RecoveryResult", "recover", "replay_rows",
]
