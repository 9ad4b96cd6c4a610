"""Synthetic sample generators → ColumnIO tables (substrate for examples,
benchmarks and the E2E tests; the paper trains from production DFS tables,
we generate statistically-similar ones).

Feature statistics follow the paper's workloads:
  * categorical ids ~ Zipf(α) — the power-law that makes hash-sharding's
    Law-of-Large-Numbers balancing non-trivial (hot ids exist);
  * multi-valued / sequence columns with geometric length distributions
    (MSE: 13 behavior sequences; LMA: lifelong sequences up to 100k);
  * float columns for bucketize / raw paths.

Port of ``repro/io/datagen.py``: the same recipes and draws, so the same
seed writes the same table files in both packages.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Sequence

import numpy as np

from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.io.columnio import BatchSpec, ColumnSchema, ColumnWriter


@dataclasses.dataclass(frozen=True)
class ColumnGen:
    """Generation recipe for one column."""

    name: str
    kind: str = "zipf"        # zipf | float | seq_zipf | label
    vocab: int = 1 << 30
    alpha: float = 1.2
    mean_len: float = 1.0     # >1 → multi-valued (geometric)
    max_len: int = 64


def gen_for_specs(specs: Sequence[FeatureSpec], seq_mean_len: float = 8.0) -> list[ColumnGen]:
    """Derive generation recipes from a model's FeatureSpecs."""
    out = []
    for s in specs:
        if s.transform == "cross":
            continue  # produced by the Feature Engine, not stored
        if s.name == "label":
            out.append(ColumnGen(s.name, kind="label"))
        elif s.transform in ("raw", "bucketize"):
            ml = s.max_len or 1
            out.append(ColumnGen(s.name, kind="float", mean_len=ml, max_len=ml))
        elif s.pooling in ("none", "tile") or (s.max_len or 1) > 1:
            out.append(ColumnGen(s.name, kind="seq_zipf",
                                 mean_len=seq_mean_len, max_len=s.max_len or 64))
        else:
            out.append(ColumnGen(s.name, kind="zipf"))
    return out


def _zipf(r: np.random.Generator, alpha: float, vocab: int, n: int) -> np.ndarray:
    return (r.zipf(alpha, size=n) % vocab).astype(np.int64)


def write_table(
    directory: str | pathlib.Path,
    gens: Sequence[ColumnGen],
    n_rows: int,
    rows_per_group: int = 4096,
    n_parts: int = 2,
    seed: int = 0,
) -> pathlib.Path:
    """Write a synthetic ColumnIO table; returns the table directory."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    r = np.random.default_rng(seed)
    schema = []
    for g in gens:
        dt = "float32" if g.kind in ("float", "label") else "int64"
        schema.append(ColumnSchema(g.name, dtype=dt, ragged=True))
    rows_per_part = -(-n_rows // n_parts)
    written = 0
    for pi in range(n_parts):
        with ColumnWriter(directory / f"part-{pi:05d}.col", schema) as w:
            part_rows = min(rows_per_part, n_rows - written)
            for s in range(0, part_rows, rows_per_group):
                gr = min(rows_per_group, part_rows - s)
                cols = {}
                for g in gens:
                    if g.kind == "label":
                        cols[g.name] = [[float(x)] for x in r.integers(0, 2, gr)]
                    elif g.kind == "float":
                        k = int(g.mean_len)
                        cols[g.name] = r.normal(size=(gr, k)).astype(np.float32).tolist()
                    elif g.kind == "seq_zipf":
                        lens = np.minimum(
                            r.geometric(1.0 / max(g.mean_len, 1.0), gr), g.max_len)
                        cols[g.name] = [
                            _zipf(r, g.alpha, g.vocab, int(l)).tolist() for l in lens
                        ]
                    else:  # zipf single-valued
                        cols[g.name] = [[int(x)] for x in _zipf(r, g.alpha, g.vocab, gr)]
                w.write_group(cols)
            written += part_rows
    return directory


def batch_spec_for(specs: Sequence[FeatureSpec], batch_rows: int,
                   seq_budget_mult: float = 2.0) -> BatchSpec:
    """Static nnz budgets per column (DESIGN.md assumption (b))."""
    budget = {}
    for s in specs:
        if s.transform == "cross":
            continue
        k = s.max_len or 1
        if s.pooling in ("none", "tile") or k > 1:
            budget[s.name] = int(batch_rows * max(k, 1) / seq_budget_mult) or batch_rows
        else:
            budget[s.name] = batch_rows
    return BatchSpec(batch_rows=batch_rows, nnz_budget=budget)
