"""Embedding Engine — the RecIS sparse side (port of
``repro/core/embedding_engine.py``), single device: serve and train.

  * Parameter aggregation: every feature with the same embedding dim is one
    merged dim-group table, kept conflict-free by salting
    (``hash_combine(raw_id, table_salt)``).
  * Request merging: one exchange per dim-group for all its features.
  * Two-tier storage per device: IDMap + Blocks, with a leading device axis
    ``[D, ...]`` on every state tensor, as the reference lays it out.
  * Pooling per feature through the segment-sum kernel (sum, mean) and the
    sequence-tile kernel (none, tile).
  * Backward update: SparseAdam on the rows the forward fetched, in place.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import exchange
from repro_torch.core import idmap as idmap_lib
from repro_torch.core.feature_engine import FeatureSpec, _fnv1a64, hash_combine
from repro_torch.io.ragged import Ragged
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.kernels.sequence_tile import ops as st_ops
from repro_torch.optim.sparse_adam import SparseAdamConfig, apply_row_updates

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
            )
            g = GroupSpec(
                dim=dim, features=tuple(feats),
                rows_per_shard=ov.get("rows_per_shard", cfg.rows_per_shard),
                map_capacity_per_shard=ov.get("map_capacity_per_shard", cfg.map_capacity_per_shard),
                exchange=ex,
            )
            self.groups[g.key] = g
        self.salts = {s.name: _stable_salt(s.table_key()) for s in emb_specs}

    # ------------------------------------------------------------------ state
    def init_state(self) -> dict:
        """Every state tensor carries a leading device axis [D, ...]."""
        D = self.cfg.n_devices
        state = {}
        for key, g in self.groups.items():
            maps = [idmap_lib.create(g.map_capacity_per_shard, g.rows_per_shard, self.device)
                    for _ in range(D)]
            blks = [blocks_lib.create(g.rows_per_shard, g.dim, self.device) for _ in range(D)]
            state[key] = {"idmap": _stack_maps(maps), "blocks": _stack_blocks(blks)}
        return state

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
        """rows_r → per-feature pooled activations."""
        out = {}
        for key, g in self.groups.items():
            vals = exchange.route_rows(rows_r[key], plans[key], g.exchange)
            ofs = 0
            for s in g.features:
                r = ids_by_feature[s.name]
                rows = vals[ofs: ofs + r.nnz_budget]
                ofs += r.nnz_budget
                out[s.name] = _pool(rows, r, s)
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
        live rows, as host numpy: the checkpoint-portable form."""
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
            out[key] = {
                "ids": np.concatenate(ids),
                "emb": np.concatenate(emb),
                "slots": {k: np.concatenate(v) for k, v in slots.items()},
                "last_use": np.concatenate(last),
            }
        return out

    def import_rows(self, rows: Mapping[str, Mapping]) -> dict:
        """Build state for this engine's device count from exported rows
        (numpy arrays or tensors): re-shard by the exchange's owner function
        and insert per shard, each row keeping its own last_use step. Rows
        are written into the fresh state in place."""
        state = self.init_state()
        D = self.cfg.n_devices
        dev = self.device
        for key, g in self.groups.items():
            if key not in rows:
                continue  # this engine has dims the export lacks
            data = rows[key]
            ids = torch.as_tensor(data["ids"], device=dev)
            if ids.numel() == 0:
                continue
            owner = exchange._owner_of(ids, D)
            last_use = torch.as_tensor(data["last_use"], device=dev)
            emb = torch.as_tensor(data["emb"], device=dev)
            slots = {k: torch.as_tensor(v, device=dev) for k, v in data["slots"].items()}
            maps = []
            for d in range(D):
                sel = torch.nonzero(owner == d).squeeze(1)
                m = state[key]["idmap"].map(lambda x: x[d])
                b = state[key]["blocks"].map(lambda x: x[d])  # views: written in place
                if sel.numel():
                    m, offs, is_new, _ = idmap_lib.lookup_or_insert(m, ids[sel], last_use[sel])
                    src = sel[is_new]
                    dst = offs[is_new].long()
                    b.emb[dst] = emb[src]
                    for k, v in b.slots.items():
                        v[dst] = slots[k][src]
                maps.append(m)
            state[key]["idmap"] = _stack_maps(maps)
        return state


def _stack_maps(maps: list[idmap_lib.IDMap]) -> idmap_lib.IDMap:
    return dataclasses.replace(
        maps[0], **{f: _stack([getattr(m, f) for m in maps]) for f in idmap_lib.TENSOR_FIELDS})


def _stack_blocks(blks: list[blocks_lib.Blocks]) -> blocks_lib.Blocks:
    return blocks_lib.Blocks(emb=_stack([b.emb for b in blks]),
                             slots={k: _stack([b.slots[k] for b in blks]) for k in blks[0].slots})


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
        if s.pooling == "mean":
            cnt = r.row_lengths().to(rows.dtype).clamp(min=1.0)
            pooled = pooled / cnt[:, None]
        return pooled
    if s.pooling == "none":
        if s.max_len is None:
            raise ValueError(f"{s.name}: sequence pooling needs max_len")
        return st_ops.sequence_tile(rows, r.row_splits, s.max_len).view(r.n_rows, s.max_len, rows.shape[1])
    if s.pooling == "tile":
        return st_ops.sequence_tile(rows, r.row_splits, s.tile_k or 1)
    raise ValueError(s.pooling)
