"""LM-family cells (port of ``repro/launch/lm_cell.py``), one device: the
train cell and the prefill (serve) cell.

The vocab table lives in the Embedding Engine as one ``tokens`` feature
(pooling "values": one row per token); its rows come back through
``route_rows`` as the (B, T, d) token embeddings that the transformer
takes. The train step inserts the batch's new tokens, takes the gradient of
the next-token loss in the dense params and the fetched rows, and applies
AdamW and SparseAdam; it returns the new state and the loss with the
engine's metrics. The prefill step returns fp32 logits of the last position
and the bf16 KV cache, with the engine's metrics. Decode cells are not
ported yet.

Batch convention: (B, T) int32 token ids on the cell's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import exchange
from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import Cell, CellOptions, local_view, resolve_device, round_up, stacked
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import MIXED, dense_apply
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig


def _engine_for(cfg: tfm.TransformerConfig, L: int, opts: CellOptions,
                device) -> tuple[EmbeddingEngine, str]:
    """The reference's budgets on one device: U, C, R from the L tokens of
    a step, two rows per vocab entry."""
    D = 1
    u = max(round_up(L, 8), 16)
    c = max(8, round_up(int(np.ceil(u / D * opts.capacity_slack)), 8))
    r = min(D * c, max(round_up(int(opts.recv_slack * u), 8), 64))
    rows = max(round_up(int(cfg.vocab_size / D * 2.0), 128), 256)
    eng = EmbeddingEngine(
        [FeatureSpec("tokens", transform="mod", vocab_size=cfg.vocab_size,
                     emb_dim=cfg.d_model, pooling="values")],
        EngineConfig(n_devices=D, rows_per_shard=rows, map_capacity_per_shard=2 * rows,
                     u_budget=u, per_dest_cap=c, recv_budget=r),
        device)
    return eng, f"dim{cfg.d_model}"


def _tokens(tokens: torch.Tensor) -> dict[str, Ragged]:
    """(B, T) ids → the engine's input: one row holds all B·T ids (row
    structure is irrelevant for pooling "values")."""
    flat = tokens.reshape(-1).to(torch.int64)
    splits = torch.tensor([0, flat.numel()], dtype=torch.int32, device=flat.device)
    return {"tokens": Ragged(flat, splits)}


def _batch_maker(cfg: tfm.TransformerConfig, B: int, T: int, device):
    def make_batch(seed: int) -> torch.Tensor:
        """The reference's numpy stream: one seed gives the reference's batch."""
        r = np.random.default_rng(seed)
        return torch.from_numpy(r.integers(0, cfg.vocab_size, size=(B, T))).to(torch.int32).to(device)

    return make_batch


def make_train_cell(arch: ArchConfig, shape: ShapeCell, opts: CellOptions,
                    device: torch.device) -> Cell:
    cfg = arch.model
    B, T = shape["global_batch"], shape["seq_len"]
    engine, gkey = _engine_for(cfg, B * T, opts, device)
    espec = engine.groups[gkey].exchange
    sopt = SparseAdamConfig(lr=opts.sparse_opt_lr)
    acfg = adamw.AdamWConfig(lr=opts.dense_opt_lr)

    def init_fn():
        dense = tfm.init(cfg, seed=0, device=device)
        return {"step": torch.zeros((), dtype=torch.int32, device=device), "dense": dense,
                "opt": adamw.init(dict(dense.named_parameters())), "sparse": engine.init_state()}

    def train_step(state, tokens):
        # no_grad, not inference_mode: the plan and rows are saved for backward
        step = state["step"] + 1
        with torch.no_grad():
            local, rows_r, plans, met = engine.fetch_local(
                local_view(state["sparse"]), _tokens(tokens), step, train=True)
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)  # wrap-around, as the reference
        rows = rows_r[gkey].requires_grad_()
        del rows_r
        params = dict(state["dense"].named_parameters())
        x_emb = exchange.route_rows(rows, plans[gkey], espec).view(B, T, cfg.d_model)
        loss = tfm.lm_loss(state["dense"], x_emb, labels, MIXED)
        del x_emb
        grads = torch.autograd.grad(loss, [*params.values(), rows])
        opt = adamw.update(acfg, params, dict(zip(params, grads)), state["opt"], step)
        with torch.no_grad():
            local = engine.update_local(local, plans, {gkey: grads[-1]}, sopt, step)
        new_state = {"step": step, "dense": state["dense"], "opt": opt,
                     "sparse": stacked(local, state["sparse"])}
        return new_state, {"loss": loss.detach(), **met}

    return Cell(arch=arch, shape=shape, device=device, step_fn=train_step, init_state=init_fn,
                make_batch=_batch_maker(cfg, B, T, device), ids_fn=_tokens, engine=engine)


def make_prefill_cell(arch: ArchConfig, shape: ShapeCell, opts: CellOptions,
                      device: torch.device) -> Cell:
    cfg = arch.model  # no remat: the step runs under inference_mode and collects the cache
    B, T = shape["global_batch"], shape["seq_len"]
    engine, gkey = _engine_for(cfg, B * T, opts, device)
    espec = engine.groups[gkey].exchange

    def init_fn():
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "dense": tfm.init(cfg, seed=0, device=device), "sparse": engine.init_state()}

    def serve_step(state, tokens):
        with torch.inference_mode():
            _, rows_r, plans, met = engine.fetch_local(
                local_view(state["sparse"]), _tokens(tokens), state["step"], train=False)
            x_emb = exchange.route_rows(rows_r[gkey], plans[gkey], espec).view(B, T, cfg.d_model)
            del rows_r, plans
            h, (k, v) = tfm.apply(state["dense"], x_emb, MIXED, collect_cache=True)
            logits = dense_apply(state["dense"].head, h[:, -1, :], MIXED).to(torch.float32)
        return {"logits": logits, "cache_k": k.to(torch.bfloat16),
                "cache_v": v.to(torch.bfloat16), **met}

    return Cell(arch=arch, shape=shape, device=device, step_fn=serve_step, init_state=init_fn,
                make_batch=_batch_maker(cfg, B, T, device), ids_fn=_tokens, engine=engine)


def build(arch: ArchConfig, shape: ShapeCell, opts: CellOptions = CellOptions(),
          device=None) -> Cell:
    device = resolve_device(device)
    if shape.kind == "train":
        return make_train_cell(arch, shape, opts, device)
    if shape.kind != "prefill":
        raise NotImplementedError(f"LM {shape.kind} cells are not ported yet")
    return make_prefill_cell(arch, shape, opts, device)
