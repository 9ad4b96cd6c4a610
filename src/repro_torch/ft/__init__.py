"""repro_torch.ft — fault tolerance for sparse training (port of
``repro/ft``, DESIGN.md §13): the parts the full-snapshot train driver
uses.

  manifest.py   crash-consistent manifest chain + GC
  chaos.py      seeded deterministic fault injection

The reference's ``dirty``, ``hooks``, ``recovery`` and ``delta`` serve only
the incremental checkpoints of ``--ckpt-mode delta`` and wait for ROADMAP
A4 (``recovery`` imports ``delta``, which imports jax).
"""
from repro_torch.ft.chaos import (ChaosEvent, ChaosIO, ChaosSchedule, InjectedCrash,
                                  StepChaos)
from repro_torch.ft.manifest import FileIO, Manifest, commit, gc, load_chain

__all__ = [
    "ChaosEvent", "ChaosIO", "ChaosSchedule", "InjectedCrash", "StepChaos",
    "FileIO", "Manifest", "commit", "gc", "load_chain",
]
