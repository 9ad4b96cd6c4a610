"""Recsys-family cells (port of ``repro/launch/recsys_cell.py``): dlrm-mlperf,
wide-deep, sasrec and mind, on one device or over a ``torch.distributed``
group of D ranks.

One fused transform pass (Feature Engine), one exchange per embedding dim
(Embedding Engine), then the dense model. The serve step is the forward
prefix of the training step; the training step then takes the gradient of
the loss in the dense params and the compact rows ``rows_r``, and applies
AdamW and SparseAdam (with ``CellOptions.train_insert=False`` the train
step probes with ``lookup``: it inserts no id and writes back only the
rows it found). Blocks are updated in place, through views of the
stacked state; the IDMap is new each step. A retrieval cell scores one
user against ``n_candidates`` item rows: two engines, one for the user's
columns (batch 1) and one for the candidates', each sized for the whole
table.

Batch convention: {column: Ragged}. The serve step takes it on the cell's
device; the train step moves it there itself, so a loader's CPU batches
reach the card inside the step (the Trainer's ``device_step`` span), as the
reference's jitted step takes host arrays.

With ``CellOptions.storage`` the engine is tiered: ``storage_device_rows``
sizes the device tier, and the train cell's ``storage_hooks`` move rows
between the tiers at the Trainer's step edges.

Over a group (``build(..., group=...)``) each rank takes ``B // D`` rows of
the global batch (``make_batch`` gives this rank's slice of the reference's
global batch) and holds one shard of every table. The dense side is
data-parallel, as under the reference's GSPMD: every rank's loss is its
share of the global loss (a per-row mean over D, or SASRec's sum over the
global count of valid positions), so the gradients reaching ``rows_r``
through the reply all_to_all and the all-reduced dense gradients are the
global loss's, and AdamW's global-norm clip sees the all-reduced ones. The
step's metrics are summed over the group and the loss is the global one.
The train state's ``state_tree`` then holds the dense side only; the rows
are checkpointed through ``checkpoint/sharded.py`` (a one-device run that
resumes such a checkpoint takes this layout too, ``launch/train.py``). Retrieval and tiered
cells run on one device only.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import comm
from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import Cell, CellOptions, local_view, resolve_device, round_up, stacked
from repro_torch.models.layers import MIXED
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig


# IDMap slots per device-tier row in a tiered cell. The reference gives every
# cell 2 (``map_capacity_per_shard=2 * rows``); a tier runs near full, so the
# map sits at half load, where 32 linear probes lose some inserts at scale
# (a full-width dlrm-mlperf step, up to 10 of its 350,000 ids: ROADMAP §C). At 4
# the load is a quarter and no insert is lost.
TIERED_MAP_FACTOR = 4


def _model_mod(arch_id: str):
    from repro_torch.models.recsys import dlrm, mind, sasrec, wide_deep

    models = {"dlrm-mlperf": dlrm, "mind": mind, "sasrec": sasrec, "wide-deep": wide_deep}
    if arch_id not in models:
        raise NotImplementedError(f"{arch_id}: not a recsys arch; known: {list(models)}")
    return models[arch_id]


def _ids_per_row(s: FeatureSpec) -> int:
    if s.pooling == "none" or s.transform == "raw":
        return s.max_len or 1
    return 1  # single-valued categorical


def _cand_specs(arch_id: str, model_cfg) -> list[FeatureSpec]:
    """Candidate columns for retrieval cells (they share the item tables)."""
    if arch_id == "dlrm-mlperf":
        return [FeatureSpec("cand_items", transform="hash", emb_dim=model_cfg.embed_dim,
                            pooling="values", shared_table="cat_0")]
    if arch_id == "wide-deep":
        return [
            FeatureSpec("cand_items", transform="hash", emb_dim=model_cfg.embed_dim,
                        pooling="values", shared_table="cat_0"),
            FeatureSpec("cand_wide", transform="hash", emb_dim=model_cfg.wide_dim,
                        pooling="values", shared_table="wide_tbl_0"),
        ]
    return [FeatureSpec("cand_items", transform="hash", emb_dim=model_cfg.embed_dim,
                        pooling="values", shared_table="items")]


# Whether a dim group is sized for every table of its dim. The reference
# keys the tables by dim, so Wide & Deep with embed_dim == wide_dim sizes its
# one group for one of its two tables (ROADMAP C7); the parity tests set
# this False to size the groups as the reference does.
SUM_TABLES_OF_A_DIM = True


def _rows_per_dim(arch: ArchConfig) -> dict[int, int]:
    """Global row capacity per dim-group (table sizes from the arch): the
    rows of every table of the group's dim."""
    m = arch.model
    if arch.arch_id == "dlrm-mlperf":
        tables = [(m.embed_dim, m.n_sparse * m.vocab_per_feature)]
    elif arch.arch_id == "wide-deep":
        tables = [(m.embed_dim, m.n_sparse * m.vocab_per_feature),
                  (m.wide_dim, m.n_sparse * m.vocab_per_feature)]
    else:
        tables = [(m.embed_dim, m.vocab)]  # sasrec, mind: one shared item table
    out: dict[int, int] = {}
    for dim, rows in tables:
        out[dim] = out.get(dim, 0) + rows if SUM_TABLES_OF_A_DIM else rows
    return out


@dataclasses.dataclass
class _Plumbing:
    engine: EmbeddingEngine
    fengine: FeatureEngine
    specs: list[FeatureSpec]
    nnz_loc: dict[str, int]
    b_loc: int
    D: int
    device: torch.device
    rank: int = 0

    def make_batch(self, seed: int, vocab: int = 1 << 30) -> dict[str, Ragged]:
        """Synthetic batch (power-law ids): the reference's numpy stream, so
        one seed gives the reference's global batch; over a group, this
        rank's slice of it (its ``b_loc`` rows in CSR form)."""
        r = np.random.default_rng(seed)
        out = {}
        for s in self.specs:
            n = self.nnz_loc[s.name]
            k = _ids_per_row(s)
            if s.transform == "raw":
                vals = r.normal(size=(self.D * n,)).astype(np.float32)
                if s.name == "label":
                    vals = (vals > 0).astype(np.float32)
            else:
                vals = (r.zipf(1.2, size=(self.D * n,)) % vocab).astype(np.int64)
            vals = vals[self.rank * n:(self.rank + 1) * n]  # every device's CSR is local
            splits = np.arange(self.b_loc + 1, dtype=np.int32) * k
            out[s.name] = Ragged(torch.from_numpy(vals).to(self.device),
                                 torch.from_numpy(splits).to(self.device))
        return out

    def prepared(self, batch: Mapping[str, Ragged]):
        """Feature Engine transforms (fused) → ids + dense."""
        return self.fengine.apply(batch)


def _plumbing(arch: ArchConfig, b_loc: int, specs: list[FeatureSpec],
              opts: CellOptions, device: torch.device, group=None) -> _Plumbing:
    D = comm.size(group)
    rows_global = _rows_per_dim(arch)
    by_dim: dict[int, int] = {}
    for s in specs:
        if s.emb_dim is not None:
            by_dim[s.emb_dim] = by_dim.get(s.emb_dim, 0) + b_loc * _ids_per_row(s)
    overrides = {}
    for dim, L in by_dim.items():
        u = max(round_up(L, 8), 16)
        c = max(8, round_up(int(np.ceil(u / D * opts.capacity_slack)), 8))
        r = min(D * c, max(round_up(int(opts.recv_slack * u), 8), 64))
        rows = max(round_up(int(rows_global.get(dim, 1 << 20) * 1.5 / D), 128), 1024)
        slots = 2 * rows
        if opts.storage is not None and opts.storage_device_rows is not None:
            # tiered: rows_per_shard is the device tier's cache size, not the
            # live-row ceiling; the host tier holds the rest
            rows = opts.storage_device_rows
            slots = TIERED_MAP_FACTOR * rows
        overrides[dim] = dict(u_budget=u, per_dest_cap=c, recv_budget=r,
                              rows_per_shard=rows, map_capacity_per_shard=slots)
    eng = EmbeddingEngine(specs, EngineConfig(n_devices=D, overrides=overrides, storage=opts.storage,
                                              group=group), device)
    fe = FeatureEngine(specs, device)
    nnz = {s.name: b_loc * _ids_per_row(s) for s in specs}
    return _Plumbing(engine=eng, fengine=fe, specs=specs, nnz_loc=nnz, b_loc=b_loc, D=D,
                     device=device, rank=comm.rank(group))


def _dense(batch: Mapping[str, Ragged], specs: list[FeatureSpec]) -> dict[str, torch.Tensor]:
    """Raw numeric columns → dense (B, k) fp32 tensors."""
    return {s.name: batch[s.name].values.reshape(-1, s.max_len or 1).to(torch.float32)
            for s in specs if s.transform == "raw"}


def _loss_share(model, dense_model, mcfg, acts, dense, group) -> torch.Tensor:
    """This rank's share of the global loss (the shares sum to it over the
    group). A per-row mean over equal ``b_loc`` is the mean of the ranks'
    means; SASRec divides by the count of valid positions over the whole
    batch, an all-reduce of the detached local counts."""
    D = comm.size(group)
    if D == 1:
        return model.loss(dense_model, mcfg, acts, dense, MIXED)
    if hasattr(model, "loss_count"):
        count = comm.all_reduce(model.loss_count(acts), group)
        return model.loss(dense_model, mcfg, acts, dense, MIXED, denom=torch.clamp(count, min=1.0))
    return model.loss(dense_model, mcfg, acts, dense, MIXED) / D


def build(arch: ArchConfig, shape: ShapeCell, opts: CellOptions = CellOptions(),
          device=None, group=None) -> Cell:
    device = resolve_device(device)
    D = comm.size(group)
    if shape.kind == "retrieval":
        if D > 1:
            raise NotImplementedError("the retrieval cell over several ranks is not ported yet (ROADMAP A6b)")
        return _build_retrieval(arch, shape, opts, device)
    if shape.kind not in ("serve", "train"):
        raise NotImplementedError(f"{shape.kind} cells are not ported yet")
    if shape["batch"] % D:
        raise ValueError(f"batch {shape['batch']} is not a multiple of {D} ranks")
    train = shape.kind == "train"
    model = _model_mod(arch.arch_id)
    mcfg = arch.model
    specs = model.feature_specs(mcfg)
    pl = _plumbing(arch, shape["batch"] // D, specs, opts, device, group)

    def dense_fn(batch):
        return _dense(batch, pl.specs)

    def serve_step(state, batch):
        with torch.inference_mode():
            ids, _ = pl.prepared(batch)
            _, rows_r, plans, met = pl.engine.fetch_local(
                local_view(state["sparse"]), ids, state["step"], train=False)
            met = comm.sum_metrics(met, group)
            acts = pl.engine.activations(rows_r, plans, ids)
            logits = model.apply(state["dense"], mcfg, acts, dense_fn(batch), MIXED)
        return {"logits": logits, **met}

    sopt = SparseAdamConfig(lr=opts.sparse_opt_lr)
    acfg = adamw.AdamWConfig(lr=opts.dense_opt_lr)

    def on_device(batch):
        return {k: Ragged(v.values.to(device), v.row_splits.to(device)) for k, v in batch.items()}

    def train_step(state, batch):
        # no_grad, not inference_mode: the plans and rows are saved for backward
        batch = on_device(batch)
        step = state["step"] + 1
        with torch.no_grad():
            ids, _ = pl.prepared(batch)
            local, rows_r, plans, met = pl.engine.fetch_local(
                local_view(state["sparse"]), ids, step, train=opts.train_insert)
            met = comm.sum_metrics(met, group)
        rows_r = {k: v.requires_grad_() for k, v in rows_r.items()}
        params = dict(state["dense"].named_parameters())
        acts = pl.engine.activations(rows_r, plans, ids)
        loss = _loss_share(model, state["dense"], mcfg, acts, dense_fn(batch), group)
        grads = torch.autograd.grad(loss, [*params.values(), *rows_r.values()])
        del acts
        gdense = comm.sum_flat(grads[:len(params)], group)
        if group is not None:
            loss = comm.all_reduce(loss.detach().clone(), group)
        opt = adamw.update(acfg, params, dict(zip(params, gdense)), state["opt"], step)
        with torch.no_grad():
            local = pl.engine.update_local(local, plans, dict(zip(rows_r, grads[len(params):])),
                                           sopt, step)
        new_state = {"step": step, "dense": state["dense"], "opt": opt,
                     "sparse": stacked(local, state["sparse"])}
        return new_state, {"loss": loss.detach(), **met}

    def init_fn():
        dense = model.init(mcfg, seed=0, device=device)
        st = {"step": torch.zeros((), dtype=torch.int32, device=device), "dense": dense,
              "sparse": pl.engine.init_state()}
        if train:
            st["opt"] = adamw.init(dict(dense.named_parameters()))
        return st

    step_fn = train_step if train else serve_step
    state_tree, load_state_tree = ((convert.train_state_to_tree, convert.train_state_from_tree)
                                   if group is None else (dense_state_tree, load_dense_state_tree))
    cell = Cell(arch=arch, shape=shape, device=device, step_fn=step_fn, init_state=init_fn,
                make_batch=pl.make_batch, ids_fn=lambda batch: pl.prepared(on_device(batch))[0],
                engine=pl.engine, returns_state=train,
                state_tree=state_tree if train else None,
                load_state_tree=load_state_tree if train else None, group=group)
    if train and pl.engine.storage is not None:
        from repro_torch.storage.integration import StorageTrainerHooks

        # step-edge hooks for the Trainer: host <-> device spill and fill
        # around the step, and the host tier in the checkpoint
        cell.storage_hooks = StorageTrainerHooks(
            pl.engine, lambda batch: pl.prepared(on_device(batch))[0], state_key="sparse")
    return cell


def dense_state_tree(state) -> dict:
    """A multi-rank train state's checkpoint tree: step, dense params and
    AdamW moments (the same on every rank), in the reference's layout; the
    rows go in the checkpoint's extra file (``checkpoint/sharded.py``)."""
    return convert.train_state_to_tree({k: v for k, v in state.items() if k != "sparse"})


def load_dense_state_tree(state, tree) -> dict:
    dense = convert.train_state_from_tree({k: v for k, v in state.items() if k != "sparse"}, tree)
    return {**dense, "sparse": state["sparse"]}


def _build_retrieval(arch: ArchConfig, shape: ShapeCell, opts: CellOptions,
                     device: torch.device) -> Cell:
    """One user (batch 1) × ``n_candidates`` candidate rows. The step
    fetches the user's rows from ``engine_user`` and the candidates' from
    ``engine_cand`` (serve fetches: missing ids read as zero rows) and
    returns ``scores`` (n_candidates,) fp32 with both engines' metrics."""
    model = _model_mod(arch.arch_id)
    mcfg = arch.model
    nc = shape["n_candidates"]  # one device: already a multiple of the mesh
    user_specs = [s for s in model.feature_specs(mcfg) if s.name != "label"]
    cand_specs = _cand_specs(arch.arch_id, mcfg)
    pl_u = _plumbing(arch, 1, user_specs, opts, device)
    pl_c = _plumbing(arch, nc, cand_specs, opts, device)

    def step_fn(state, batch):
        ub, cb = batch["user"], batch["cand"]
        with torch.inference_mode():
            ids_u, _ = pl_u.prepared(ub)
            ids_c, _ = pl_c.prepared(cb)
            _, rows_u, plans_u, met_u = pl_u.engine.fetch_local(
                local_view(state["sparse_user"]), ids_u, state["step"], train=False)
            _, rows_c, plans_c, met_c = pl_c.engine.fetch_local(
                local_view(state["sparse_cand"]), ids_c, state["step"], train=False)
            acts_u = pl_u.engine.activations(rows_u, plans_u, ids_u)
            acts_c = pl_c.engine.activations(rows_c, plans_c, ids_c)
            kwargs = {"cand_wide": acts_c["cand_wide"]} if arch.arch_id == "wide-deep" else {}
            scores = model.score_candidates(state["dense"], mcfg, acts_u, _dense(ub, user_specs),
                                            acts_c["cand_items"], prec=MIXED, **kwargs)
        return {"scores": scores, **met_u, **met_c}

    def init_fn():
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "dense": model.init(mcfg, seed=0, device=device),
                "sparse_user": pl_u.engine.init_state(), "sparse_cand": pl_c.engine.init_state()}

    def make_batch(seed: int, vocab: int = 1 << 30):
        return {"user": pl_u.make_batch(seed, vocab), "cand": pl_c.make_batch(seed + 1, vocab)}

    return Cell(arch=arch, shape=shape, device=device, step_fn=step_fn, init_state=init_fn,
                make_batch=make_batch, returns_state=False, engine_user=pl_u.engine, engine_cand=pl_c.engine,
                ids_fn=lambda batch: {"user": pl_u.prepared(batch["user"])[0],
                                      "cand": pl_c.prepared(batch["cand"])[0]})
