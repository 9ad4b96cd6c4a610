"""Recsys-family cells (port of ``repro/launch/recsys_cell.py``), one device.

One fused transform pass (Feature Engine), one exchange per embedding dim
(Embedding Engine), then the dense model. The serve step is the forward
prefix of the training step; the training step then takes the gradient of
the loss in the dense params and the compact rows ``rows_r``, and applies
AdamW and SparseAdam. Blocks are updated in place, through views of the
stacked state; the IDMap is new each step.

Batch convention: {column: Ragged} on the cell's device.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import Cell, CellOptions, local_view, resolve_device, round_up, stacked
from repro_torch.models.layers import MIXED
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig


def _model_mod(arch_id: str):
    if arch_id != "dlrm-mlperf":
        raise NotImplementedError(f"{arch_id}: only dlrm-mlperf is ported")
    from repro_torch.models.recsys import dlrm

    return dlrm


def _ids_per_row(s: FeatureSpec) -> int:
    if s.pooling == "none" or s.transform == "raw":
        return s.max_len or 1
    return 1  # single-valued categorical


def _rows_per_dim(arch: ArchConfig) -> dict[int, int]:
    """Global row capacity per dim-group (table sizes from the arch)."""
    m = arch.model
    return {m.embed_dim: m.n_sparse * m.vocab_per_feature}


@dataclasses.dataclass
class _Plumbing:
    engine: EmbeddingEngine
    fengine: FeatureEngine
    specs: list[FeatureSpec]
    nnz_loc: dict[str, int]
    b_loc: int
    D: int
    device: torch.device

    def make_batch(self, seed: int, vocab: int = 1 << 30) -> dict[str, Ragged]:
        """Synthetic batch (power-law ids): the reference's numpy stream, so
        one seed gives the reference's batch."""
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
            splits = np.tile(np.arange(self.b_loc + 1, dtype=np.int32) * k, self.D)
            out[s.name] = Ragged(torch.from_numpy(vals).to(self.device),
                                 torch.from_numpy(splits).to(self.device))
        return out

    def prepared(self, batch: Mapping[str, Ragged]):
        """Feature Engine transforms (fused) → ids + dense."""
        return self.fengine.apply(batch)


def _plumbing(arch: ArchConfig, b_loc: int, specs: list[FeatureSpec],
              opts: CellOptions, device: torch.device) -> _Plumbing:
    D = 1
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
        overrides[dim] = dict(u_budget=u, per_dest_cap=c, recv_budget=r,
                              rows_per_shard=rows, map_capacity_per_shard=2 * rows)
    eng = EmbeddingEngine(specs, EngineConfig(n_devices=D, overrides=overrides), device)
    fe = FeatureEngine(specs, device)
    nnz = {s.name: b_loc * _ids_per_row(s) for s in specs}
    return _Plumbing(engine=eng, fengine=fe, specs=specs, nnz_loc=nnz, b_loc=b_loc, D=D,
                     device=device)


def build(arch: ArchConfig, shape: ShapeCell, opts: CellOptions = CellOptions(),
          device=None) -> Cell:
    device = resolve_device(device)
    if shape.kind not in ("serve", "train"):
        raise NotImplementedError(f"{shape.kind} cells are not ported yet")
    train = shape.kind == "train"
    model = _model_mod(arch.arch_id)
    mcfg = arch.model
    specs = model.feature_specs(mcfg)
    pl = _plumbing(arch, shape["batch"], specs, opts, device)

    def dense_fn(batch):
        """Raw numeric columns → dense (B, k) fp32 tensors."""
        return {s.name: batch[s.name].values.reshape(-1, s.max_len or 1).to(torch.float32)
                for s in pl.specs if s.transform == "raw"}

    def serve_step(state, batch):
        with torch.inference_mode():
            ids, _ = pl.prepared(batch)
            _, rows_r, plans, met = pl.engine.fetch_local(
                local_view(state["sparse"]), ids, state["step"], train=False)
            acts = pl.engine.activations(rows_r, plans, ids)
            logits = model.apply(state["dense"], mcfg, acts, dense_fn(batch), MIXED)
        return {"logits": logits, **met}

    sopt = SparseAdamConfig(lr=opts.sparse_opt_lr)
    acfg = adamw.AdamWConfig(lr=opts.dense_opt_lr)

    def train_step(state, batch):
        # no_grad, not inference_mode: the plans and rows are saved for backward
        step = state["step"] + 1
        with torch.no_grad():
            ids, _ = pl.prepared(batch)
            local, rows_r, plans, met = pl.engine.fetch_local(
                local_view(state["sparse"]), ids, step, train=True)
        rows_r = {k: v.requires_grad_() for k, v in rows_r.items()}
        params = dict(state["dense"].named_parameters())
        acts = pl.engine.activations(rows_r, plans, ids)
        loss = model.loss(state["dense"], mcfg, acts, dense_fn(batch), MIXED)
        grads = torch.autograd.grad(loss, [*params.values(), *rows_r.values()])
        del acts
        opt = adamw.update(acfg, params, dict(zip(params, grads)), state["opt"], step)
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
    cell = Cell(arch=arch, shape=shape, device=device, step_fn=step_fn, init_state=init_fn,
                make_batch=pl.make_batch, ids_fn=lambda batch: pl.prepared(batch)[0],
                engine=pl.engine)
    return cell
