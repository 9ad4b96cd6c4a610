"""GIN (Graph Isomorphism Network, arXiv:1810.00826; port of
``repro/models/gnn.py``).

Layer:  h' = MLP_l((1 + eps_l) * h + Σ_{u→v} h_u)

The neighbour sum is the id-form segment sum (``kernels/segment_reduce/
ops.segment_sum``), as the reference's ``use_pallas=True`` path runs it:
the messages ``h[src]`` are gathered in fp32 (bf16 widens exactly), summed
by destination in fp32 and cast back to h's type; the gradient of the sum
is the row gather ``g[dst]`` (the gather kernel on the card). The step's
edges are sorted by destination once (``sort_edges``, a stable sort with
masked edges sent to the spare id ``n_nodes``), so every layer sums the
same function in the same per-segment order without sorting again. The
reference also multiplies each message by its edge mask; a masked edge's
id already drops it from the sum and zeroes its gradient, so the port does
not.

Distribution: with a ``group`` (the edge-parallel full graph), node
features and params are replicated and each rank holds a slice of the
edges; h enters the messages through ``comm.CopyToGroup`` and the partial
sums leave through ``comm.AllReduceSum``, so every rank computes the whole
loss and the exact whole gradient (the reference's psum under
``check_vma=False``). Without a group both are skipped.

Graph-level readout = Σ_l Linear_l(sum-pool(h_l)) (GIN's jumping
knowledge), pooled through the same segment sum in fp32 and cast to h's
type (the reference pools in h's type with ``jax.ops.segment_sum``);
node-level tasks use a head on the final layer.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
from repro_torch.kernels.segment_reduce import ops as sr_ops
from repro_torch.models.layers import MIXED, Precision, dense, dense_apply


class GraphBatch(NamedTuple):
    feats: torch.Tensor       # (N, d_feat) float32
    edge_src: torch.Tensor    # (E,) int32
    edge_dst: torch.Tensor    # (E,) int32
    edge_mask: torch.Tensor   # (E,) bool — padding
    node_graph: torch.Tensor  # (N,) int32 — graph id per node (readout)
    node_mask: torch.Tensor   # (N,) bool
    labels: torch.Tensor      # (n_graphs,) or (N,) int32

    def to(self, device) -> "GraphBatch":
        return GraphBatch(*(x.to(device) for x in self))


@dataclasses.dataclass(frozen=True)
class GINConfig:
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    task: str = "node"  # node | graph
    eps_learnable: bool = True


class GINLayer(nn.Module):
    def __init__(self, d: int, gen: torch.Generator, device=None):
        super().__init__()
        self.mlp1 = dense(d, d, gen, device=device)
        self.mlp2 = dense(d, d, gen, device=device)
        self.eps = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))


class GIN(nn.Module):
    """Parameters under the reference's tree names: ``encoder``,
    ``layer{l}.{mlp1, mlp2, eps}``, ``readout{l}`` (graph task), ``head``."""

    def __init__(self, cfg: GINConfig, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.encoder = dense(cfg.d_feat, cfg.d_hidden, gen, device=device)
        for l in range(cfg.n_layers):
            self.add_module(f"layer{l}", GINLayer(cfg.d_hidden, gen, device))
        if cfg.task == "graph":
            for l in range(cfg.n_layers):
                self.add_module(f"readout{l}", dense(cfg.d_hidden, cfg.n_classes, gen, device=device))
        self.head = dense(cfg.d_hidden, cfg.n_classes, gen, device=device)


def init(cfg: GINConfig, seed: int = 0, device=None) -> GIN:
    return GIN(cfg, seed, device)


def sort_edges(g: GraphBatch, n_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, seg) int32, ordered by a stable sort of the destination ids,
    masked edges at ``n_nodes`` (past every segment, so dropped)."""
    seg = torch.where(g.edge_mask, g.edge_dst, n_nodes).to(torch.int32)
    seg, order = torch.sort(seg, stable=True)
    return g.edge_src.to(torch.int32)[order], seg


def _aggregate(h: torch.Tensor, src: torch.Tensor, seg: torch.Tensor, n_nodes: int,
               group=None) -> torch.Tensor:
    """Σ over this rank's edges u→v of h[u] into row v (ascending ``seg``
    from ``sort_edges``), summed in fp32, in h's type; over a group the sum
    of every rank's edges."""
    if group is not None:
        h = comm.CopyToGroup.apply(h, group)
    msg = torch.index_select(h.to(torch.float32), 0, src)
    agg = sr_ops.segment_sum(msg, seg, n_nodes, sorted_ids=True).to(h.dtype)
    if group is not None:
        agg = comm.AllReduceSum.apply(agg, group)
    return agg


def apply(model: GIN, cfg: GINConfig, g: GraphBatch, prec: Precision = MIXED, group=None) -> torch.Tensor:
    """Returns logits: (N, C) for the node task, (n_graphs, C) for the graph
    task, fp32."""
    n = g.feats.shape[0]
    src, seg = sort_edges(g, n)
    keep = g.node_mask[:, None]
    h = dense_apply(model.encoder, prec.cast(g.feats), prec)
    h = h * keep.to(h.dtype)
    readout = None
    if cfg.task == "graph":
        n_graphs = g.labels.shape[0]
        gid = torch.where(g.node_mask, g.node_graph, n_graphs).to(torch.int32)
    for l in range(cfg.n_layers):
        lp = getattr(model, f"layer{l}")
        agg = _aggregate(h, src, seg, n, group)
        z = (1.0 + lp.eps).to(h.dtype) * h + agg
        z = F.relu(dense_apply(lp.mlp1, z, prec))
        h = F.relu(dense_apply(lp.mlp2, z, prec))
        h = h * keep.to(h.dtype)
        if cfg.task == "graph":
            pooled = sr_ops.segment_sum(h.to(torch.float32), gid, n_graphs).to(h.dtype)
            r = dense_apply(getattr(model, f"readout{l}"), pooled, prec)
            readout = r if readout is None else readout + r
    if cfg.task == "graph":
        return readout.to(torch.float32)
    return dense_apply(model.head, h, prec).to(torch.float32)


def loss_fn(model: GIN, cfg: GINConfig, g: GraphBatch, prec: Precision = MIXED, group=None) -> torch.Tensor:
    """Softmax cross entropy: the node task's mean over live labelled nodes
    (label -1 = unlabelled), the graph task's mean over graphs."""
    logits = apply(model, cfg, g, prec, group)
    labels = g.labels.to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[:, None])[:, 0]
    per = lse - gold
    if cfg.task == "node":
        m = (g.node_mask & (labels >= 0)).to(per.dtype)
        return (per * m).sum() / torch.clamp(m.sum(), min=1.0)
    return per.mean()
