"""Process groups for the multi-rank paths (port of ``repro/launch/mesh.py``).

The reference names a JAX mesh and its axes; the port names a
``torch.distributed`` process group. A group is made only when a caller
asks (nothing at import), either from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an
explicit rank, world size and ``torch.distributed.FileStore`` path, as the
tests rendezvous (no port to collide between test workers).

The caller names the backend; nothing picks one silently:

  * ``nccl`` puts each rank on its own card (``cuda:LOCAL_RANK``); NCCL
    refuses two ranks of one communicator on one device;
  * ``gloo`` runs on the CPU, and also for several ranks sharing one card,
    where ``core/comm.py`` stages each CUDA tensor through pinned host
    memory.

``make_production_mesh`` (the reference's 16×16 TPU pod shapes) serves only
``launch/dryrun.py`` and is not ported with it yet.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.core import comm

BACKENDS = ("gloo", "nccl")
TIMEOUT = datetime.timedelta(seconds=600)  # of every collective


def init_group(backend: str, *, rank: int | None = None, world_size: int | None = None,
               store_path: str | os.PathLike | None = None):
    """Create the default process group and return it (the reference's
    mesh over every device). With ``rank`` and ``world_size`` the ranks
    meet through a ``FileStore`` at ``store_path``; without them, through
    torchrun's ``env://`` variables."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("no RANK/WORLD_SIZE in the environment: run under torchrun, "
                               "or pass rank, world_size and store_path")
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        if world_size is None or store_path is None:
            raise ValueError("an explicit rank needs world_size and store_path")
        store = dist.FileStore(str(store_path), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=TIMEOUT)
    return dist.group.WORLD


def rank_device(backend: str, device=None) -> torch.device:
    """This rank's device. ``nccl``: the card ``LOCAL_RANK`` names (set as
    the current device). ``gloo``: ``device`` as the caller names it, the
    card (``cuda``) when it names none."""
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device if device is not None else "cuda")


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def n_devices(group) -> int:
    """Ranks in the group (the reference's mesh size); 1 for no group."""
    return comm.size(group)


def dp_group(group):
    """The batch (data-parallel) group: the reference's ``dp_axes``, every
    axis but "model". The port has no model axis yet, so it is the whole
    group; a tensor- or expert-parallel slice carves subgroups here with
    ``torch.distributed.new_group``."""
    return group
