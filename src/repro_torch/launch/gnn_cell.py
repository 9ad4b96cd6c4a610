"""GNN-family cells (GIN; port of ``repro/launch/gnn_cell.py``), on one
device or over a ``torch.distributed`` group of D ranks.

full_graph  — edge-parallel: node features and labels replicated, the edge
              list (E rounded up to D) sharded, rank r holding edges
              [r E/D, (r+1) E/D); the partial aggregations are all-reduced
              inside the model (``models/gnn.py``), so each rank computes
              the whole loss and the exact whole gradient, and the dense
              update needs no further sum.
minibatch   — sampled subgraphs (fanout 15-10), data-parallel: the seeds
              split over the ranks.
graph_batch — batched small graphs (molecule), data-parallel over the
              batch group (``mesh.dp_group``).

``make_batch(seed)`` draws the reference's numpy streams in its order for
the reference's global batch, so the batches are bit-equal to its; over a
group each rank takes its own slice of it. In the data-parallel cells each
rank's loss is that of its own subgraphs; the step's loss is their mean
over the ranks, and the gradients are summed over the ranks and divided by
D. With ``CellOptions.compress_grads`` the sum is ``adamw.compressed_psum``
of each gradient over D, one leaf at a time in the order of the
reference's tree, each rank carrying its own error-feedback residual
(state ``ef``); on one device too, where the gradient is still quantised
to int8, as the reference does.

The state is ``{"step", "dense": GIN, "opt": {"m", "v"}}`` (plus ``ef``,
this rank's residual of each param, with ``compress_grads``); its
``state_tree`` is the reference's layout, ``ef`` stacked
``[n_shards, ...]`` in rank order (an all-gather over the batch group).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.core import comm
from repro_torch.launch import mesh
from repro_torch.launch.common import Cell, CellOptions, resolve_device, round_up
from repro_torch.models import gnn
from repro_torch.models.gnn import GraphBatch
from repro_torch.models.layers import MIXED
from repro_torch.optim import adamw


def build(arch: ArchConfig, shape: ShapeCell, opts: CellOptions = CellOptions(),
          device=None, group=None) -> Cell:
    device = resolve_device(device)
    cfg = dataclasses.replace(
        arch.model, d_feat=shape["d_feat"], n_classes=shape["n_classes"],
        task="graph" if shape.kind == "graph_batch" else "node")
    acfg = adamw.AdamWConfig(lr=opts.dense_opt_lr)
    if shape.kind == "full_graph":
        return _full_graph_cell(arch, shape, cfg, acfg, device, group)
    if shape.kind in ("minibatch", "graph_batch"):
        return _dp_cell(arch, shape, cfg, acfg, opts, device, mesh.dp_group(group))
    raise NotImplementedError(f"{shape.kind}: not a GNN shape")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _grads(loss: torch.Tensor, params: dict) -> list[torch.Tensor]:
    """d loss / d params; a param the loss does not reach (the graph task's
    ``head``) gets zeros, as the reference's autodiff gives it."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params.values())]


def _init_fn(cfg, device, with_ef: bool = False):
    def init_fn():
        model = gnn.init(cfg, seed=0, device=device)
        params = dict(model.named_parameters())
        st = {"step": torch.zeros((), dtype=torch.int32, device=device), "dense": model,
              "opt": adamw.init(params)}
        if with_ef:
            st["ef"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return st
    return init_fn


def _full_graph_cell(arch, shape, cfg, acfg, device, group) -> Cell:
    D, rank = comm.size(group), comm.rank(group)
    N = shape["n_nodes"]
    E = round_up(shape["n_edges"], D)
    e_loc = E // D

    def step_fn(state, g: GraphBatch):
        g = g.to(device)
        step = state["step"] + 1
        params = dict(state["dense"].named_parameters())
        loss = gnn.loss_fn(state["dense"], cfg, g, MIXED, group)
        grads = _grads(loss, params)
        adamw.update(acfg, params, dict(zip(params, grads)), state["opt"], step)
        return {"step": step, "dense": state["dense"], "opt": state["opt"]}, {"loss": loss.detach()}

    def make_batch(seed: int) -> GraphBatch:
        r = np.random.default_rng(seed)
        ne = shape["n_edges"]
        feats = r.normal(size=(N, cfg.d_feat)).astype(np.float32)
        src = np.pad(r.integers(0, N, ne), (0, E - ne)).astype(np.int32)
        dst = np.pad(r.integers(0, N, ne), (0, E - ne)).astype(np.int32)
        labels = r.integers(0, cfg.n_classes, N).astype(np.int32)
        mine = slice(rank * e_loc, (rank + 1) * e_loc)
        return GraphBatch(
            feats=_tensor(feats, device), edge_src=_tensor(src[mine], device),
            edge_dst=_tensor(dst[mine], device), edge_mask=_tensor(np.arange(E)[mine] < ne, device),
            node_graph=torch.zeros((N,), dtype=torch.int32, device=device),
            node_mask=torch.ones((N,), dtype=torch.bool, device=device), labels=_tensor(labels, device))

    return Cell(arch=arch, shape=shape, device=device, step_fn=step_fn, init_state=_init_fn(cfg, device),
                make_batch=make_batch, ids_fn=None, state_tree=convert.train_state_to_tree,
                load_state_tree=convert.train_state_from_tree, group=group)


def _dp_cell(arch, shape, cfg, acfg, opts: CellOptions, device, dp) -> Cell:
    D, rank = comm.size(dp), comm.rank(dp)
    if shape.kind == "minibatch":
        seeds = shape["batch_nodes"] // D
        f1, f2 = shape["fanout"]
        n_loc = seeds * (1 + f1 + f1 * f2)             # node budget per shard
        e_loc = seeds * (f1 + f1 * f2)                 # edge budget per shard
        graphs_loc = 0                                  # node task
    else:  # molecule: whole graphs per shard
        graphs_loc = shape["batch"] // D
        n_loc = graphs_loc * shape["n_nodes"]
        e_loc = graphs_loc * shape["n_edges"]
    NG = D * n_loc
    compress = opts.compress_grads

    def step_fn(state, g: GraphBatch):
        g = g.to(device)
        step = state["step"] + 1
        model = state["dense"]
        params = dict(model.named_parameters())
        loss = gnn.loss_fn(model, cfg, g, MIXED)
        new_state = {"step": step, "dense": model, "opt": state["opt"]}
        if compress:
            grads = dict(zip(params, _grads(loss, params)))
            paths = convert.tree_paths(model)
            ef = {}
            for k in sorted(paths, key=lambda k: paths[k][0]):  # the reference's tree_flatten order
                grads[k], ef[k] = adamw.compressed_psum(grads[k] / D, dp, state["ef"][k])
            new_state["ef"] = ef
        else:
            grads = dict(zip(params, comm.sum_flat(_grads(loss / D, params), dp)))
        if dp is not None:
            loss = comm.all_reduce(loss.detach().clone(), dp) / D
        adamw.update(acfg, params, grads, state["opt"], step)
        return new_state, {"loss": loss.detach()}

    def make_batch(seed: int) -> GraphBatch:
        r = np.random.default_rng(seed)
        # local subgraphs with LOCAL node indices, concatenated per shard
        src = r.integers(0, n_loc, (D, e_loc)).astype(np.int32)
        dst = r.integers(0, n_loc, (D, e_loc)).astype(np.int32)
        if cfg.task == "graph":
            npg = shape["n_nodes"]
            node_graph = np.tile(np.repeat(np.arange(graphs_loc), npg), D)
            labels = r.integers(0, cfg.n_classes, (D * graphs_loc,))
            lab_loc = graphs_loc
        else:
            node_graph = np.zeros((NG,), np.int32)
            lab = r.integers(0, cfg.n_classes, (D, n_loc))
            labelled = n_loc if shape.kind != "minibatch" else max(1, n_loc // 166)
            labels = np.where(np.arange(n_loc)[None, :] < labelled, lab, -1).reshape(-1)
            lab_loc = n_loc
        feats = r.normal(size=(NG, cfg.d_feat)).astype(np.float32)
        nodes = slice(rank * n_loc, (rank + 1) * n_loc)
        return GraphBatch(
            feats=_tensor(feats[nodes], device), edge_src=_tensor(src[rank], device),
            edge_dst=_tensor(dst[rank], device), edge_mask=torch.ones((e_loc,), dtype=torch.bool, device=device),
            node_graph=_tensor(node_graph[nodes].astype(np.int32), device),
            node_mask=torch.ones((n_loc,), dtype=torch.bool, device=device),
            labels=_tensor(np.asarray(labels)[rank * lab_loc:(rank + 1) * lab_loc].astype(np.int32), device))

    def state_tree(state) -> dict:
        tree = convert.train_state_to_tree(state)
        if "ef" in state:
            local = convert.params_to_tree(state["dense"], state["ef"])
            tree["ef"] = _map(lambda x: comm.all_gather(x.contiguous(), dp), local)
        return tree

    def load_state_tree(state, tree) -> dict:
        out = convert.train_state_from_tree(state, tree)
        if "ef" in state:
            mine = convert.params_from_tree(state["dense"], _map(lambda a: np.asarray(a)[rank], tree["ef"]))
            with torch.no_grad():
                for k, x in mine.items():
                    state["ef"][k].copy_(x)
            out["ef"] = state["ef"]
        return out

    return Cell(arch=arch, shape=shape, device=device, step_fn=step_fn,
                init_state=_init_fn(cfg, device, compress), make_batch=make_batch, ids_fn=None,
                state_tree=state_tree, load_state_tree=load_state_tree, group=dp)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
