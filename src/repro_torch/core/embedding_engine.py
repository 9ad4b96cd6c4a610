"""Embedding Engine — the RecIS sparse side (port of
``repro/core/embedding_engine.py``): serve and train, on one device or
sharded over the ranks of a ``torch.distributed`` group
(``EngineConfig.group``).

  * Parameter aggregation: every feature with the same embedding dim is one
    merged dim-group table, kept conflict-free by salting
    (``hash_combine(raw_id, table_salt)``).
  * Request merging: one exchange per dim-group for all its features.
  * Two-tier storage per device: IDMap + Blocks, with a leading device axis
    ``[D, ...]`` on every state tensor, as the reference lays it out. Over a
    group of D ranks each rank holds only its own shard, ``[1, ...]``
    (shard_map's local view; ``state_sharding_spec``): ``export_rows``
    exports it, ``import_rows`` keeps the rows this rank owns.
  * Pooling: every sum and mean feature of a dim group in one grouped
    segment-sum launch (its gradient one launch too); none and tile per
    feature through the sequence-tile kernel.
  * Backward update: SparseAdam on the rows the forward fetched, in place.
  * Tiered storage (``EngineConfig.storage``): the device tier becomes a
    row cache over a host-DRAM tier (``storage/tiered.py``); rows move at
    step edges (``storage_prefetch``, ``storage_admit``, ``evict_to_host``),
    and ``export_rows`` / ``import_rows`` see the union of both tiers.
  * Eviction for continuous training: ``evict_local`` discards stale rows
    of one device's state; ``evict_to_host`` does it on the stacked state
    (spilling them to the host tier when there is one).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import comm
from repro_torch.core import exchange
from repro_torch.core import idmap as idmap_lib
from repro_torch.core import write_log
from repro_torch.core.feature_engine import FeatureSpec, _fnv1a64, hash_combine
from repro_torch.io.ragged import Ragged
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.sequence_tile import ops as st_ops
from repro_torch.optim.sparse_adam import SparseAdamConfig, apply_row_updates
from repro_torch.storage.tiered import StorageConfig, TieredEmbeddingStore

PAD = -1


def _stable_salt(name: str) -> int:
    """Deterministic 63-bit salt from a table name (FNV-1a, no Python hash())."""
    return _fnv1a64(name) & 0x7FFFFFFFFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static description of one merged dim-group."""

    dim: int
    features: tuple[FeatureSpec, ...]
    rows_per_shard: int
    map_capacity_per_shard: int
    exchange: exchange.ExchangeSpec

    @property
    def key(self) -> str:
        return f"dim{self.dim}"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_devices: int = 1
    rows_per_shard: int = 1 << 16
    map_capacity_per_shard: int = 1 << 17
    u_budget: int = 4096
    per_dest_cap: int = 256
    recv_budget: int = 8192
    # per-dim overrides: dim -> dict of the five knobs above
    overrides: Mapping[int, Mapping[str, int]] = dataclasses.field(default_factory=dict)
    # tiered storage: non-None turns the device tier into a row cache over a
    # host-DRAM tier; rows_per_shard then bounds the hot rows, not the live
    storage: StorageConfig | None = None
    # the process group the tables are sharded over (n_devices ranks); None:
    # every shard in this process
    group: object = dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How the engine state is laid out over the group: every leaf is
    sharded on its leading device axis (the reference's ``P(mesh_axes)``),
    and this process holds the global shards ``shards`` in that order."""

    shards: tuple[int, ...]
    group: object = dataclasses.field(default=None, compare=False, repr=False)


def _stack(xs: list[torch.Tensor]) -> torch.Tensor:
    return xs[0].unsqueeze(0) if len(xs) == 1 else torch.stack(xs)


class EmbeddingEngine:
    def __init__(self, specs: Sequence[FeatureSpec], cfg: EngineConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        emb_specs = [s for s in specs if s.emb_dim is not None]
        by_dim: dict[int, list[FeatureSpec]] = {}
        for s in emb_specs:
            by_dim.setdefault(s.emb_dim, []).append(s)
        self.groups: dict[str, GroupSpec] = {}
        for dim, feats in sorted(by_dim.items()):
            ov = dict(cfg.overrides.get(dim, {}))
            ex = exchange.ExchangeSpec(
                n_devices=cfg.n_devices,
                u_budget=ov.get("u_budget", cfg.u_budget),
                per_dest_cap=ov.get("per_dest_cap", cfg.per_dest_cap),
                recv_budget=ov.get("recv_budget", cfg.recv_budget),
                group=cfg.group,
            )
            g = GroupSpec(
                dim=dim, features=tuple(feats),
                rows_per_shard=ov.get("rows_per_shard", cfg.rows_per_shard),
                map_capacity_per_shard=ov.get("map_capacity_per_shard", cfg.map_capacity_per_shard),
                exchange=ex,
            )
            self.groups[g.key] = g
        self.salts = {s.name: _stable_salt(s.table_key()) for s in emb_specs}
        # the global shards this process holds: its own rank's over a group
        self.shards = (comm.rank(cfg.group),) if cfg.group is not None else tuple(range(cfg.n_devices))
        self.storage: TieredEmbeddingStore | None = None
        if cfg.storage is not None and cfg.group is not None:
            raise NotImplementedError("tiered storage over several ranks is not ported yet "
                                      "(the store holds every shard in one process; ROADMAP A6b)")
        if cfg.storage is not None:
            self.storage = TieredEmbeddingStore(
                {k: (g.dim, g.rows_per_shard) for k, g in self.groups.items()},
                cfg.n_devices, cfg.storage, self.device)

    # ------------------------------------------------------------------ state
    def init_state(self) -> dict:
        """Every state tensor carries a leading device axis over the shards
        this process holds: [D, ...], or [1, ...] on a rank of a group."""
        state = {}
        for key, g in self.groups.items():
            maps = [idmap_lib.create(g.map_capacity_per_shard, g.rows_per_shard, self.device)
                    for _ in self.shards]
            blks = [blocks_lib.create(g.rows_per_shard, g.dim, self.device) for _ in self.shards]
            state[key] = {"idmap": _stack_maps(maps), "blocks": _stack_blocks(blks)}
        return state

    def state_sharding_spec(self) -> ShardSpec:
        """Every leaf sharded on its leading device axis over the group."""
        return ShardSpec(shards=self.shards, group=self.cfg.group)

    # -------------------------------------------------------------- engine ids
    def engine_ids(self, ids_by_feature: Mapping[str, Ragged]) -> dict[str, torch.Tensor]:
        """Per dim-group: salted, concatenated id vector [L_group]; PAD where
        a value is padding."""
        out = {}
        for key, g in self.groups.items():
            parts = []
            for s in g.features:
                r = ids_by_feature[s.name]
                salt = torch.tensor(self.salts[s.name], dtype=torch.int64, device=r.values.device)
                eng = hash_combine(r.values, salt)
                parts.append(torch.where(r.valid_mask(), eng, PAD))
            out[key] = torch.cat(parts)
        return out

    # ------------------------------------------------------------ fetch (local)
    def fetch_local(self, state_local: dict, ids_by_feature: Mapping[str, Ragged],
                    step: torch.Tensor, train: bool = True):
        """One device's view (leading axis taken). Returns
        (state', rows_r {group: [R, dim]}, plans, metrics)."""
        eng_ids = self.engine_ids(ids_by_feature)
        new_state, rows_r, plans, metrics = {}, {}, {}, {}
        for key, g in self.groups.items():
            m, b, rr, plan, met = exchange.fetch(
                state_local[key]["idmap"], state_local[key]["blocks"], eng_ids[key],
                g.exchange, step, train)
            new_state[key] = {"idmap": m, "blocks": b}
            rows_r[key] = rr
            plans[key] = plan
            for mk, mv in met.items():
                metrics[f"{key}/{mk}"] = mv
            metrics[f"{key}/dev_rows_live"] = m.n_live()
        return new_state, rows_r, plans, metrics

    # ----------------------------------------------------------- activations
    def activations(self, rows_r: Mapping[str, torch.Tensor],
                    plans: Mapping[str, exchange.Plan],
                    ids_by_feature: Mapping[str, Ragged]) -> dict[str, torch.Tensor]:
        """rows_r → per-feature pooled activations. The group's sum and mean
        features pool in one grouped segment sum over the routed rows (one
        launch each way, one use of ``vals`` for autograd); the other
        poolings take their feature's slice through ``_pool``."""
        out = {}
        for key, g in self.groups.items():
            vals = exchange.route_rows(rows_r[key], plans[key], g.exchange)
            spans, ofs = [], 0
            for s in g.features:
                n = ids_by_feature[s.name].nnz_budget
                spans.append((ofs, n))
                ofs += n
            summed = [i for i, s in enumerate(g.features) if s.pooling in ("sum", "mean")]
            pooled = dict(zip(summed, sr_ops.segment_sum_csr_group(
                vals, [ids_by_feature[g.features[i].name].row_splits for i in summed],
                [spans[i][0] for i in summed], [spans[i][1] for i in summed])))
            for i, s in enumerate(g.features):
                r = ids_by_feature[s.name]
                if i in pooled:
                    out[s.name] = _mean(pooled[i], r) if s.pooling == "mean" else pooled[i]
                else:
                    o, n = spans[i]
                    out[s.name] = _pool(vals[o:o + n], r, s)
        return out

    # ----------------------------------------------------------------- update
    def update_local(self, state_local: dict, plans: Mapping[str, exchange.Plan],
                     grads_rows_r: Mapping[str, torch.Tensor], opt: SparseAdamConfig,
                     step: torch.Tensor) -> dict:
        """Apply the compact row gradients with SparseAdam(W): the offsets
        retained from the forward, the rows updated in place."""
        new_state = {}
        for key in self.groups:
            plan = plans[key]
            b = apply_row_updates(opt, state_local[key]["blocks"], plan.offsets_r,
                                  grads_rows_r[key], plan.valid_r, step)
            new_state[key] = {"idmap": state_local[key]["idmap"], "blocks": b}
        return new_state

    # ------------------------------------------------------- export / import
    def export_rows(self, state) -> dict:
        """Stacked state [D, ...] → {group: {ids, emb, slots, last_use}} of all
        live rows, as host numpy: the checkpoint-portable form. With a
        tiered store it is the union of both tiers (the host rows after the
        device's), and each id's access count rides along as ``counts``."""
        out = {}
        for key in self.groups:
            m = state[key]["idmap"].map(lambda x: x.cpu().numpy())
            b = state[key]["blocks"]
            ids, emb, slots, last = [], [], {k: [] for k in b.slots}, []
            for d in range(m.keys.shape[0]):
                occ = m.occupied[d] & (m.offsets[d] != idmap_lib.OVERFLOW_ROW)
                ids.append(m.keys[d][occ])
                offs = torch.as_tensor(m.offsets[d][occ], device=b.emb.device).long()
                emb.append(b.emb[d][offs].cpu().numpy())
                for sk in b.slots:
                    slots[sk].append(b.slots[sk][d][offs].cpu().numpy())
                last.append(m.last_use[d][occ])
            if self.storage is not None:
                h = self.storage.host[key].export()
                ids.append(h["ids"])
                emb.append(h["emb"])
                for sk in b.slots:
                    slots[sk].append(h["slots"][sk])
                last.append(h["last_use"])
            out[key] = {
                "ids": np.concatenate(ids),
                "emb": np.concatenate(emb),
                "slots": {k: np.concatenate(v) for k, v in slots.items()},
                "last_use": np.concatenate(last),
            }
            if self.storage is not None:
                out[key]["counts"] = self.storage.counts[key].get(out[key]["ids"], 1)
        return out

    def import_rows(self, rows: Mapping[str, Mapping]) -> dict:
        """Build state for this engine's device count from exported rows
        (numpy arrays or tensors): re-shard by the exchange's owner function
        and insert per shard, each row keeping its own last_use step. Rows
        are written into the fresh state in place. On a rank of a group only
        the rows this rank owns are kept (an elastic N → M restore).

        With a tiered store, each shard's hottest rows (by last_use, then
        id) fill the device tier up to its capacity and the rest land in the
        host tier, so an export taken at one tier split restores onto any
        other; the access counts come from the export's ``counts``."""
        state = self.init_state()
        D = self.cfg.n_devices
        dev = self.device
        for key, g in self.groups.items():
            if key not in rows:
                continue  # this engine has dims the export lacks
            data = rows[key]
            ids = torch.as_tensor(data["ids"], device=dev)
            if self.storage is not None:
                self.storage.host[key].clear()
                ids_np = ids.cpu().numpy()
                counts = data.get("counts", np.ones(ids_np.shape, np.int64))
                self.storage.load_counts(key, ids_np, _numpy(counts))
            if ids.numel() == 0:
                continue
            owner = exchange._owner_of(ids, D)
            last_use = torch.as_tensor(data["last_use"], device=dev)
            emb = torch.as_tensor(data["emb"], device=dev)
            slots = {k: torch.as_tensor(v, device=dev) for k, v in data["slots"].items()}
            cap = g.rows_per_shard - 1  # row 0 reserved
            maps = []
            for i, d in enumerate(self.shards):
                sel = torch.nonzero(owner == d).squeeze(1)
                m = state[key]["idmap"].map(lambda x: x[i])
                b = state[key]["blocks"].map(lambda x: x[i])  # views: written in place
                if self.storage is not None and sel.numel() > cap:
                    # the hottest rows stay on the device; the tail spills
                    sel_np, last_np = sel.cpu().numpy(), _numpy(data["last_use"])
                    hot = sel_np[np.lexsort((ids_np[sel_np], -last_np[sel_np]))]
                    cold = hot[cap:]
                    self.storage.host[key].put(
                        ids_np[cold], _numpy(data["emb"])[cold],
                        {k: _numpy(v)[cold] for k, v in data["slots"].items()}, last_np[cold])
                    sel = torch.from_numpy(hot[:cap]).to(dev)
                if sel.numel():
                    m, offs, is_new, _ = idmap_lib.lookup_or_insert(m, ids[sel], last_use[sel])
                    src = sel[is_new]
                    dst = offs[is_new].long()
                    b.emb[dst] = emb[src]
                    for k, v in b.slots.items():
                        v[dst] = slots[k][src]
                maps.append(m)
            state[key]["idmap"] = _stack_maps(maps)
        if self.storage is not None:
            self.storage.sync_from_state(state)
        return state

    # ------------------------------------------------------------------ evict
    def evict_local(self, state_local: dict, older_than) -> tuple[dict, dict]:
        """Staleness discard on one device's state. With a tiered store,
        ``evict_to_host`` spills the stale rows to the host tier instead."""
        new_state, metrics = {}, {}
        for key in self.groups:
            m, n = idmap_lib.evict(state_local[key]["idmap"], older_than)
            new_state[key] = {"idmap": m, "blocks": state_local[key]["blocks"]}
            metrics[f"{key}/evicted"] = n
        return new_state, metrics

    # ------------------------------------------- tiered storage (step edges)
    # The host tier is numpy, so host ↔ device row traffic runs at step
    # edges on the stacked state: prefetch fills before the step's insert,
    # admit and evict spill after the update.
    def storage_prefetch(self, state: dict, ids_by_feature: Mapping[str, Ragged], step) -> tuple[dict, dict]:
        """Fill pass: promote this step's host-resident rows to the device
        (and demote policy-chosen victims under capacity pressure) so the
        step meets no overflow. Returns (state, metrics)."""
        self._need_storage()
        eng = {k: v.cpu().numpy() for k, v in self.engine_ids(ids_by_feature).items()}
        return self.storage.prefetch(state, eng, int(step))

    def storage_admit(self, state: dict, step) -> tuple[dict, dict]:
        """Spill pass: demote rows that entered the device tier this step but
        fail the admission policy (e.g. below ``min_count_to_admit``)."""
        self._need_storage()
        return self.storage.post_step(state, int(step))

    def evict_to_host(self, state: dict, older_than) -> tuple[dict, dict]:
        """Staleness pass over the stacked state. A tiered engine spills the
        stale rows device → host (no state is lost); an untiered one
        discards them, as ``evict_local`` does, per shard."""
        if self.storage is not None:
            return self.storage.evict_stale(state, int(older_than))
        new_state, metrics = {}, {}
        for key in self.groups:
            maps, n_total = [], 0
            for i, d in enumerate(self.shards):
                m = state[key]["idmap"].map(lambda x: x[i])
                with write_log.shard_scope(key, d):
                    m, n = idmap_lib.evict(m, int(older_than))
                maps.append(m)
                n_total += int(n)
            new_state[key] = {"idmap": _stack_maps(maps), "blocks": state[key]["blocks"]}
            metrics[f"{key}/evicted"] = n_total
        return new_state, metrics

    def _need_storage(self) -> None:
        if self.storage is None:
            raise ValueError("EngineConfig.storage is not set")


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stack_maps(maps: list[idmap_lib.IDMap]) -> idmap_lib.IDMap:
    return dataclasses.replace(
        maps[0], **{f: _stack([getattr(m, f) for m in maps]) for f in idmap_lib.TENSOR_FIELDS})


def _stack_blocks(blks: list[blocks_lib.Blocks]) -> blocks_lib.Blocks:
    return blocks_lib.Blocks(emb=_stack([b.emb for b in blks]),
                             slots={k: _stack([b.slots[k] for b in blks]) for k in blks[0].slots})


def _mean(pooled: torch.Tensor, r: Ragged) -> torch.Tensor:
    """Sums over the row lengths clamped to at least 1."""
    return pooled / r.row_lengths().to(pooled.dtype).clamp(min=1.0)[:, None]


def _pool(rows: torch.Tensor, r: Ragged, s: FeatureSpec) -> torch.Tensor:
    """Per-feature pooling of per-value rows: sum / mean → (n_rows, dim);
    none → (n_rows, max_len, dim); tile → (n_rows, tile_k * dim); values →
    the rows as they are (CSR order). ``none`` is the reference's
    ``rows[idx] * mask``, the sequence-tile function reshaped, so both go
    through the sequence-tile kernel."""
    if s.pooling == "values":
        return rows
    if s.pooling in ("sum", "mean"):
        pooled = sr_ops.segment_sum_csr(rows, r.row_splits)
        return _mean(pooled, r) if s.pooling == "mean" else pooled
    if s.pooling == "none":
        if s.max_len is None:
            raise ValueError(f"{s.name}: sequence pooling needs max_len")
        return st_ops.sequence_tile(rows, r.row_splits, s.max_len).view(r.n_rows, s.max_len, rows.shape[1])
    if s.pooling == "tile":
        return st_ops.sequence_tile(rows, r.row_splits, s.tile_k or 1)
    raise ValueError(s.pooling)
