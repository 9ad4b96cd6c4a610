"""GNN neighbor sampler — fanout sampling over host CSR graphs (port of
``repro/io/sampler.py``: numpy only, the same draws in the same order, so a
seed gives the reference's subgraph bit for bit).

The `minibatch_lg` cell (Reddit-scale: 233k nodes / 115M edges, fanout
15-10) needs a *real* neighbor sampler: seeds → layer-1 neighbors (≤15) →
layer-2 neighbors (≤10 each). Sampling is a host-side, IO-shaped operation
(the GNN analogue of ColumnIO batch assembly) and produces fixed-budget
local subgraphs with LOCAL node indices. No cell calls it yet, in either
package: the cells draw their subgraphs in ``make_batch``.

The CSR graph lives in host RAM (numpy); `sample` is vectorized numpy (no
Python per-node loops) so a reader thread can keep up with the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """indptr (N+1,), indices (E,) — standard CSR adjacency (out-edges)."""

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]

    @classmethod
    def random(cls, n_nodes: int, avg_degree: float, seed: int = 0) -> "CSRGraph":
        """Power-law-ish random graph (degree ~ exponential around avg)."""
        r = np.random.default_rng(seed)
        deg = np.minimum(
            r.exponential(avg_degree, n_nodes).astype(np.int64) + 1, n_nodes - 1
        )
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = r.integers(0, n_nodes, int(indptr[-1]), dtype=np.int64)
        return cls(indptr=indptr, indices=indices)


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Fixed-budget local subgraph for one device shard.

    nodes      (n_budget,) GLOBAL node ids (position 0.. = seeds first)
    node_mask  (n_budget,) live nodes
    edge_src   (e_budget,) LOCAL indices into ``nodes``
    edge_dst   (e_budget,) LOCAL indices
    edge_mask  (e_budget,) live edges
    n_seeds    static seed count (first n_seeds node slots)
    """

    nodes: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    n_seeds: int


class NeighborSampler:
    """fanout = (f1, f2, ...) layered uniform neighbor sampling."""

    def __init__(self, graph: CSRGraph, fanout: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanout = tuple(fanout)
        self.r = np.random.default_rng(seed)

    def budgets(self, n_seeds: int) -> tuple[int, int]:
        n = n_seeds
        n_budget, e_budget = n_seeds, 0
        for f in self.fanout:
            e = n * f
            e_budget += e
            n_budget += e
            n = e
        return n_budget, e_budget

    def _sample_neighbors(self, frontier: np.ndarray, f: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized: for each frontier node draw ≤f neighbors (w/ replacement
        when deg>0; empty rows masked). → (src_global, dst_global, mask)."""
        deg = (self.g.indptr[frontier + 1] - self.g.indptr[frontier]).astype(np.int64)
        base = self.g.indptr[frontier]
        # draw f uniform slots per frontier node
        u = self.r.random((frontier.shape[0], f))
        slot = (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbr = self.g.indices[base[:, None] + slot]            # (n, f)
        mask = (deg > 0)[:, None] & np.ones((1, f), bool)
        src = np.repeat(frontier, f).reshape(-1)
        return src, nbr.reshape(-1), mask.reshape(-1)

    def sample(self, seeds: np.ndarray) -> SampledSubgraph:
        n_seeds = seeds.shape[0]
        n_budget, e_budget = self.budgets(n_seeds)
        nodes = np.full((n_budget,), -1, np.int64)
        node_mask = np.zeros((n_budget,), bool)
        nodes[:n_seeds] = seeds
        node_mask[:n_seeds] = True
        esrc = np.zeros((e_budget,), np.int64)
        edst = np.zeros((e_budget,), np.int64)
        emask = np.zeros((e_budget,), bool)

        # local index = position in ``nodes``; duplicates get distinct slots
        # (tree-style sampling — standard GraphSAGE semantics)
        frontier = seeds
        frontier_local = np.arange(n_seeds, dtype=np.int64)
        n_cursor, e_cursor = n_seeds, 0
        for f in self.fanout:
            src_g, dst_g, m = self._sample_neighbors(frontier, f)
            cnt = dst_g.shape[0]
            new_local = n_cursor + np.arange(cnt, dtype=np.int64)
            nodes[n_cursor: n_cursor + cnt] = np.where(m, dst_g, -1)
            node_mask[n_cursor: n_cursor + cnt] = m
            # message direction: neighbor → seed (dst aggregates from src)
            esrc[e_cursor: e_cursor + cnt] = new_local
            edst[e_cursor: e_cursor + cnt] = np.repeat(frontier_local, f)
            emask[e_cursor: e_cursor + cnt] = m
            frontier = np.where(m, dst_g, 0)
            frontier_local = new_local
            n_cursor += cnt
            e_cursor += cnt
        return SampledSubgraph(
            nodes=nodes, node_mask=node_mask,
            edge_src=esrc, edge_dst=edst, edge_mask=emask, n_seeds=n_seeds,
        )
