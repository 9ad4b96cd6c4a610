"""Embedding exchange — dedupe, owner bucketing, owner merge, IDMap probe or
insert, and row routing (port of ``repro/core/exchange.py``), on one device
or over a ``torch.distributed`` group of D ranks (RecIS §2.2.2):

  requester side                         owner side
  --------------                         ----------
  ids (this rank's batch slice)
    → unique, bucket by owner  ──all_to_all──→ merge + unique received ids
                                               → IDMap probe (or insert)
                                               → Blocks row gather
  rows for my requests       ←──all_to_all──   per-request rows
    → back to unique order, expand to per-value rows

Every table is sharded by a hash of the id over all ranks; each rank holds
only its own shard. Both all_to_alls move equal (D, C) buckets
(``core/comm.py``), so a rank with no live ids still sends its PAD
buckets. The reply's all_to_all is an autograd function whose backward is
the same all_to_all of the gradient: the paper's backward all-to-all, which
the reference gets by autodiff. ``ExchangeSpec.group`` None is one device,
where the reply buckets are the request buckets and no collective runs.

Static budgets, as in the reference:
  L  ids per device per step (padded input)
  U  unique ids per device          (requester dedupe budget)
  C  ids per destination device     (send-bucket capacity)
  R  unique received ids per device (owner merge budget)
Overflow at any stage routes to the overflow row and is counted.

Three behaviours of the reference are spelled out here: ``unique`` with a
size keeps the U smallest sorted uniques and pads with PAD while its inverse
may point past U; out-of-range gathers clamp; ``.at[].set(mode="drop")``
drops out-of-range writes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import comm
from repro_torch.core import idmap as idmap_lib
from repro_torch.core.feature_engine import splitmix64, to_signed, umod

PAD = -1
_OWNER_SALT = to_signed(0xA24BAED4963EE407)


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Static budgets and the process group of one embedding dim-group's
    exchange (the group in place of the reference's mesh axes)."""

    n_devices: int         # D
    u_budget: int          # U
    per_dest_cap: int      # C
    recv_budget: int       # R  (≤ n_devices * C)
    # the ranks the table is sharded over (all of them); None: one device
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.recv_budget > self.n_devices * self.per_dest_cap:
            raise ValueError("recv_budget must not exceed n_devices * per_dest_cap")
        if self.group is not None and comm.size(self.group) != self.n_devices:
            raise ValueError(f"n_devices {self.n_devices} != the group's {comm.size(self.group)} ranks")


class Plan(NamedTuple):
    """Integer routing state retained from the forward pass (per device)."""

    inv_u: torch.Tensor      # (L,)   value index   → unique index (may be ≥ U)
    ok_val: torch.Tensor     # (L,)   value survived dedupe budget & not PAD
    owner_u: torch.Tensor    # (U,)   unique index  → owner device (D for PAD)
    pos_u: torch.Tensor      # (U,)   unique index  → slot within owner bucket
    ok_u: torch.Tensor       # (U,)   unique id made it into the send buffer
    inv_r: torch.Tensor      # (D*C,) request slot  → owner-unique index (may be ≥ R)
    ok_r: torch.Tensor       # (D*C,) request slot survived owner merge (and not PAD)
    offsets_r: torch.Tensor  # (R,)   owner-unique index → Blocks row
    valid_r: torch.Tensor    # (R,)   owner-unique id is live (not fill)


def _unique_sized(x: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted uniques cut or PAD-filled to ``size``, and the int32 inverse
    into the full sorted uniques (entries ≥ size where the budget cut)."""
    uniq, inv = torch.unique(x, sorted=True, return_inverse=True)
    if uniq.numel() >= size:
        uniq = uniq[:size]
    else:
        uniq = torch.cat([uniq, uniq.new_full((size - uniq.numel(),), PAD)])
    return uniq, inv.to(torch.int32)


def _owner_of(ids: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Owner shard of an id, from a re-mix independent of the IDMap's slot
    hash; PAD → n_devices."""
    own = umod(splitmix64(ids.to(torch.int64) ^ _OWNER_SALT), n_devices).to(torch.int32)
    return torch.where(ids == PAD, n_devices, own)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def build_send(ids: torch.Tensor, spec: ExchangeSpec) -> tuple[torch.Tensor, Plan, dict]:
    """Requester side: dedupe and bucket by owner. Returns (send_ids[D, C], plan⁰, metrics)."""
    D, U, C = spec.n_devices, spec.u_budget, spec.per_dest_cap
    dev = ids.device
    uniq, inv = _unique_sized(ids, U)
    ok_val = (uniq[inv.clamp(max=U - 1)] == ids) & (ids != PAD)

    owner = _owner_of(uniq, D)
    sowner, order = torch.sort(owner, stable=True)
    start = torch.searchsorted(sowner, torch.arange(D, dtype=sowner.dtype, device=dev))
    pos_sorted = (torch.arange(U, dtype=torch.int32, device=dev)
                  - start[sowner.clamp(0, D - 1)].to(torch.int32))
    ok_sorted = (sowner < D) & (pos_sorted < C)
    dst = torch.where(ok_sorted, sowner.long() * C + pos_sorted, D * C)
    send = torch.full((D * C + 1,), PAD, dtype=torch.int64, device=dev)
    send.index_put_((dst,), uniq[order])
    send = send[: D * C].view(D, C)
    # bucket coordinates back in unique order (order is a permutation)
    owner_u = torch.empty_like(sowner).index_put_((order,), sowner)
    pos_u = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    ok_u = torch.empty_like(ok_sorted).index_put_((order,), ok_sorted)

    R = spec.recv_budget
    plan = Plan(
        inv_u=inv, ok_val=ok_val, owner_u=owner_u, pos_u=pos_u, ok_u=ok_u,
        inv_r=torch.zeros((D * C,), dtype=torch.int32, device=dev),
        ok_r=torch.zeros((D * C,), dtype=torch.bool, device=dev),
        offsets_r=torch.zeros((R,), dtype=torch.int32, device=dev),
        valid_r=torch.zeros((R,), dtype=torch.bool, device=dev),
    )
    metrics = {
        "exch_uniq_overflow": _count((ids != PAD) & ~ok_val),
        "exch_send_overflow": _count((owner < D) & ~ok_u),
    }
    return send, plan, metrics


def owner_merge(recv_ids: torch.Tensor, spec: ExchangeSpec) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Owner side: merge and unique the D*C received ids."""
    flat = recv_ids.reshape(-1)
    R = spec.recv_budget
    uniq_r, inv_r = _unique_sized(flat, R)
    ok_r = (uniq_r[inv_r.clamp(max=R - 1)] == flat) & (flat != PAD)
    return uniq_r, inv_r, ok_r, {"exch_recv_overflow": _count((flat != PAD) & ~ok_r)}


def fetch(
    m: idmap_lib.IDMap,
    b: blocks_lib.Blocks,
    ids: torch.Tensor,
    spec: ExchangeSpec,
    step: torch.Tensor,
    train: bool,
) -> tuple[idmap_lib.IDMap, blocks_lib.Blocks, torch.Tensor, Plan, dict]:
    """Routing, IDMap probe (``train``: insert, and initialise the new rows
    in place) and row gather.

    Returns (idmap, blocks, rows_r [R, dim], plan, metrics); ``rows_r`` is
    the compact per-owner-unique row matrix, the only tensor the
    differentiable phase depends on.
    """
    if spec.group is None and spec.n_devices != 1:
        raise ValueError(f"an exchange over {spec.n_devices} devices needs a process group")
    send, plan, met1 = build_send(ids, spec)
    # rank i's bucket j lands at rank j's row i; one device: recv = send
    recv = send if spec.group is None else comm.all_to_all(send, spec.group)
    uniq_r, inv_r, ok_r, met2 = owner_merge(recv, spec)
    if train:
        m, offsets_r, is_new, met3 = idmap_lib.lookup_or_insert(m, uniq_r, step)
        b = blocks_lib.init_rows(b, offsets_r, uniq_r, is_new)
    else:
        offsets_r = idmap_lib.lookup(m, uniq_r)
        met3 = {}
    # Ids on the overflow row (missing at serve time, or probe or row
    # exhaustion) act as zero embeddings and are excluded from updates.
    valid_r = (uniq_r != PAD) & (offsets_r != idmap_lib.OVERFLOW_ROW)
    rows_r = blocks_lib.gather(b, offsets_r)
    rows_r.mul_(valid_r[:, None])
    plan = plan._replace(inv_r=inv_r, ok_r=ok_r, offsets_r=offsets_r, valid_r=valid_r)
    return m, b, rows_r, plan, {**met1, **met2, **met3}


def route_rows(rows_r: torch.Tensor, plan: Plan, spec: ExchangeSpec) -> torch.Tensor:
    """Owner rows [R, dim] → per-value rows [L, dim], differentiable in
    ``rows_r``. The per-request rows (D*C, dim) go back to their requesters
    through the reply all_to_all, whose backward carries the gradient to
    the owners. Out-of-range plan indices are clamped (the reference's
    gather semantics) and then zeroed by their masks. Masks are applied in
    place to keep the transients single; autograd allows it, since a mask
    product saves only the mask.

    The gathers are ``F.embedding``, whose backward sums duplicate indices
    by sorted segments in parallel. The PAD slots of the send buckets (at
    least three quarters of them on one device) all point at one index, a
    run that an indexing backward would walk serially.
    """
    D, C = spec.n_devices, spec.per_dest_cap
    R, U = rows_r.shape[0], plan.owner_u.shape[0]
    per_req = F.embedding(plan.inv_r.clamp(max=R - 1).long(), rows_r)
    per_req.mul_(plan.ok_r[:, None])
    # one device: the reply buckets are the request buckets
    back = per_req if spec.group is None else comm.AllToAll.apply(per_req, spec.group)
    del per_req
    flat_u = plan.owner_u.clamp(max=D - 1).long() * C + plan.pos_u.clamp(max=C - 1)
    uniq_rows = F.embedding(flat_u, back)
    del back
    uniq_rows.mul_(plan.ok_u[:, None])
    vals = F.embedding(plan.inv_u.clamp(max=U - 1).long(), uniq_rows)
    del uniq_rows
    vals.mul_(plan.ok_val[:, None])
    return vals
