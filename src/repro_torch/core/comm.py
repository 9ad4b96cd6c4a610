"""Collectives over a ``torch.distributed`` group for the multi-rank paths:
the exchange's two all_to_alls, the metric and gradient sums, the row
gathers of a checkpoint, and the pair of autograd functions of the
edge-parallel GIN layer (``CopyToGroup``, ``AllReduceSum``).

``group=None`` is one device: no collective runs. With the ``gloo`` backend
a CUDA tensor is staged explicitly through a pinned host buffer (gloo's
transports move host memory; two ranks that share one card cannot use
NCCL, which refuses two ranks of one communicator on one device). Every
staged transfer is counted in ``STAGED_CALLS`` and ``STAGED_BYTES`` (both
directions), so a run can say what its transport carried. ``nccl`` takes
the CUDA tensors as they are.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

STAGED_CALLS = 0
STAGED_BYTES = 0


def size(group) -> int:
    """Ranks in ``group``; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group``; 0 for no group."""
    return 0 if group is None else dist.get_rank(group)


def transport(group, device) -> str:
    """What carries a collective of tensors on ``device``."""
    if group is None:
        return "none (one device)"
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo, host-staged"
    return backend


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    global STAGED_CALLS, STAGED_BYTES
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STAGED_CALLS += 1
    STAGED_BYTES += x.numel() * x.element_size()
    return host


def _from_host(dst: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    global STAGED_BYTES
    dst.copy_(host)
    STAGED_BYTES += host.numel() * host.element_size()
    return dst


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits over dim 0 (``x.shape[0]`` a multiple of the group's
    size D): chunk j of rank i lands as chunk i of rank j, the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``."""
    x = x.contiguous()
    if x.shape[0] % size(group):
        raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) is not a multiple of {size(group)} ranks")
    if _staged(group, x):
        host = _to_host(x)
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        return _from_host(torch.empty_like(x), recv)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the group; returns ``x``."""
    if group is None:
        return x
    if _staged(group, x):
        host = _to_host(x)
        dist.all_reduce(host, op=op, group=group)
        return _from_host(x, host)
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: [D, *x.shape]."""
    if group is None:
        return x.unsqueeze(0)
    staged = _staged(group, x)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return _from_host(torch.empty(out.shape, dtype=x.dtype, device=x.device), out) if staged else out


def sum_flat(tensors, group) -> list[torch.Tensor]:
    """Each tensor summed over the group (the dense gradients of a
    data-parallel step): one all-reduce of them all, flattened in order."""
    if group is None:
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [x.view_as(t) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def sum_metrics(metrics: Mapping[str, torch.Tensor], group) -> dict:
    """The reference's ``psum`` of a step's counters: one all-reduce of
    every counter, in sorted-name order on every rank, each keeping its
    name and dtype."""
    if group is None:
        return dict(metrics)
    names = sorted(metrics)
    if not names:
        return {}
    vals = [torch.as_tensor(metrics[k]) for k in names]
    flat = all_reduce(torch.stack([v.to(torch.int64).reshape(()) for v in vals]), group)
    return {k: flat[i].to(v.dtype) for i, (k, v) in enumerate(zip(names, vals))}


class AllToAll(torch.autograd.Function):
    """``all_to_all`` with its transpose, the same all_to_all, as the
    backward (the reference gets it by autodiff through ``route_rows``).
    Every rank runs the backward's all_to_all in its own backward pass."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_to_all(g, ctx.group), None


class AllReduceSum(torch.autograd.Function):
    """The sum of every rank's partial ``x`` (an all-reduce) with the
    identity as its backward: the function downstream is replicated, so
    each rank already holds the whole gradient of the sum. The conjugate of
    ``CopyToGroup``; together they make the edge-parallel GIN layer."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class CopyToGroup(torch.autograd.Function):
    """The identity on a replicated tensor that each rank then uses on its
    own slice of the work; its backward all-reduces the gradient, the sum
    of every rank's part of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None
