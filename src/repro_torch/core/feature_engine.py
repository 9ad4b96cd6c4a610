"""Feature Engine — fused feature transforms (port of
``repro/core/feature_engine.py``).

Columns are grouped by transform kind, their CSR value buffers concatenated
with a per-value column id, and one vectorised op handles each group.

Every 64-bit hash here is bit-exact with the reference's uint64 arithmetic
while staying in signed int64, because PyTorch has no uint64 ``+``, ``>>`` or
``%``: int64 ``+`` and ``*`` wrap mod 2^64 exactly as uint64 does, ``^`` is
bitwise, the logical right shift is an arithmetic shift with the sign-filled
bits masked off, and an unsigned remainder is built from 32-bit halves
(``umod``). Ids stay signed int64, which is also the order the reference's
``unique`` sorts them in.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.io.ragged import PAD_ID, Ragged
from repro_torch.kernels.fused_transform import ops as ft_ops
from repro_torch.kernels.fused_transform.ref import offset_index

_U64 = 1 << 64


def to_signed(x: int) -> int:
    """A 64-bit unsigned constant as the int64 with the same bits."""
    x %= _U64
    return x - _U64 if x >= 1 << 63 else x


_SPLITMIX_C1 = to_signed(0x9E3779B97F4A7C15)
_SPLITMIX_C2 = to_signed(0xBF58476D1CE4E5B9)
_SPLITMIX_C3 = to_signed(0x94D049BB133111EB)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Stateless 64-bit mixer (Steele et al.), on int64 bit patterns."""
    z = x.to(torch.int64) + _SPLITMIX_C1
    z = (z ^ _srl(z, 30)) * _SPLITMIX_C2
    z = (z ^ _srl(z, 27)) * _SPLITMIX_C3
    return z ^ _srl(z, 31)


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combine of two id tensors (or an id tensor and a salt)."""
    return splitmix64(a.to(torch.int64) ^ (splitmix64(b) + _SPLITMIX_C1))


def umod(z: torch.Tensor, m: int) -> torch.Tensor:
    """``z % m`` with ``z`` read as uint64, for 0 < m < 2^31. Returns int64.

    From the 32-bit halves: ((hi % m) * (2^32 % m) + lo) % m, where every
    intermediate stays below 2^63.
    """
    if not 0 < m < 1 << 31:
        raise ValueError(f"umod needs 0 < m < 2^31, got {m}")
    hi = _srl(z, 32)
    lo = z & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def _fnv1a64(name: str) -> int:
    """64-bit FNV-1a of a string (restart/process independent)."""
    h = 1469598103934665603
    for ch in name.encode():
        h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv1a(name: str) -> int:
    """Deterministic 31-bit string hash (restart/process independent)."""
    return _fnv1a64(name) & 0x7FFFFFFF


POOLINGS = ("sum", "mean", "none", "tile", "values")


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """One input column and how it becomes a model input."""

    name: str
    transform: str = "hash"          # hash | mod | bucketize | raw | cross
    emb_dim: int | None = None        # None => raw numeric (dense side)
    pooling: str = "sum"              # sum | mean | none (sequence) | tile | values
    tile_k: int = 0                   # for pooling == "tile"
    vocab_size: int | None = None     # for mod
    boundaries: tuple[float, ...] = ()  # for bucketize
    salt: int = 0                     # for hash
    cross_of: tuple[str, str] | None = None  # for cross
    max_len: int | None = None        # sequence truncation
    shared_table: str | None = None   # share embedding rows with another column

    def table_key(self) -> str:
        return self.shared_table or self.name

    def __post_init__(self):
        if self.pooling not in POOLINGS:
            raise ValueError(f"{self.name}: unknown pooling {self.pooling!r}")
        if self.transform == "mod" and not self.vocab_size:
            raise ValueError(f"{self.name}: mod needs vocab_size")
        if self.transform == "bucketize" and not self.boundaries:
            raise ValueError(f"{self.name}: bucketize needs boundaries")
        if self.transform == "cross" and self.cross_of is None:
            raise ValueError(f"{self.name}: cross needs cross_of")


def _jnp_take(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``table[i]`` as the reference's ``jnp`` indexing reads it: a negative
    index counts from the end once, then the index is clamped into the
    table, so no column id raises."""
    return table[offset_index(i.long(), table.shape[0] - 1)]


def fused_hash(values: torch.Tensor, column_ids: torch.Tensor, salts: torch.Tensor) -> torch.Tensor:
    """All hash columns in one op: ids ^= per-column salt, then mix."""
    return splitmix64(values.to(torch.int64) ^ _jnp_take(salts, column_ids))


def fused_mod(values: torch.Tensor, column_ids: torch.Tensor, vocab_sizes: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.int64)
    m = _jnp_take(vocab_sizes, column_ids).to(torch.int64)
    return torch.where(m > 0, v.abs() % m.clamp(min=1), v)


def fused_bucketize(
    values: torch.Tensor,
    column_ids: torch.Tensor,
    boundaries: torch.Tensor,
    boundary_offsets: torch.Tensor,
) -> torch.Tensor:
    """All bucketize columns in one op: a branch-free, fixed-trip binary
    search of each value over its own column's slice of ``boundaries``
    (``boundary_offsets[c]:boundary_offsets[c+1]``). Bins are right-open.

    The reference's plain version, kept for the tests: it reads the offsets
    on the host. ``FeatureEngine`` runs the fused_transform kernel's op.
    The offsets are read as ``jnp`` reads them (``_jnp_take``)."""
    starts = _jnp_take(boundary_offsets, column_ids)
    ends = _jnp_take(boundary_offsets, column_ids.long() + 1)
    widths = np.diff(boundary_offsets.cpu().numpy())
    max_w = int(widths.max()) if widths.size else 1
    n_steps = int(np.ceil(np.log2(max(max_w, 2))) + 1)
    lo, hi = starts, ends
    v = values.to(torch.float32)
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(0, boundaries.shape[0] - 1)
        go_right = (mid < hi) & (v >= boundaries[mid_c])
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.where(mid < hi, mid, hi))
    return (lo - starts).to(torch.int64)


class FeatureEngine:
    """Groups FeatureSpecs by transform type and applies fused ops.

    ``apply`` maps {name: Ragged} → ({name: Ragged} ids ready for embedding
    lookup, {name: dense float tensor} for raw numerics).
    """

    def __init__(self, specs: Sequence[FeatureSpec], device: torch.device | str):
        self.specs = list(specs)
        self.by_name = {s.name: s for s in self.specs}
        if len(self.by_name) != len(self.specs):
            raise ValueError("duplicate feature names")
        self.device = torch.device(device)
        self.groups: dict[str, list[FeatureSpec]] = {}
        for s in self.specs:
            self.groups.setdefault(s.transform, []).append(s)
        # Salts key on table_key() so columns sharing a table map raw ids
        # identically, through a deterministic string hash.
        salt_in = [to_signed(_fnv1a(s.table_key()) + s.salt)
                   for s in self.groups.get("hash", [])] or [0]
        salts = torch.tensor(salt_in, dtype=torch.int64)
        if self.groups.get("hash"):
            salts = splitmix64(salts)
        self._hash_salts = salts.to(self.device)
        mod_specs = self.groups.get("mod", [])
        self._vocab_sizes = torch.tensor([s.vocab_size for s in mod_specs] or [1],
                                         dtype=torch.int64, device=self.device)
        bnds, offs = [], [0]
        for s in self.groups.get("bucketize", []):
            bnds.extend(s.boundaries)
            offs.append(len(bnds))
        self._boundaries = torch.tensor(bnds or [0.0], dtype=torch.float32, device=self.device)
        self._boundary_offsets = torch.tensor(offs, dtype=torch.int32, device=self.device)
        # per fused group, its last column-id tensor and the (budgets, device) it was built for
        self._column_ids: dict[str, tuple[tuple, torch.Tensor]] = {}

    def apply(self, batch: Mapping[str, Ragged]) -> tuple[dict[str, Ragged], dict[str, torch.Tensor]]:
        id_out: dict[str, Ragged] = {}
        dense_out: dict[str, torch.Tensor] = {}
        fused_ops = (
            ("hash", lambda v, c: fused_hash(v, c, self._hash_salts)),
            ("mod", lambda v, c: fused_mod(v, c, self._vocab_sizes)),
            ("bucketize", lambda v, c: ft_ops.fused_bucketize(
                v, c, self._boundaries, self._boundary_offsets)),
        )
        for kind, fused in fused_ops:
            specs = self.groups.get(kind, [])
            if not specs:
                continue
            cols = [self._maybe_truncate(batch[s.name], s) for s in specs]
            vals = torch.cat([c.values for c in cols])
            flat = fused(vals, self._group_column_ids(kind, cols, vals.device))
            ofs = 0
            for s, c in zip(specs, cols):
                id_out[s.name] = Ragged(flat[ofs: ofs + c.nnz_budget], c.row_splits)
                ofs += c.nnz_budget
        for s in self.groups.get("raw", []):
            r = self._maybe_truncate(batch[s.name], s)
            dense, _ = r.to_padded(s.max_len or 1, pad_value=0.0)
            dense_out[s.name] = dense.to(torch.float32)
        for s in self.groups.get("cross", []):
            a, b = s.cross_of
            ra = id_out[a] if a in id_out else batch[a]
            rb = id_out[b] if b in id_out else batch[b]
            id_out[s.name] = self._cross(ra, rb, s)
        return id_out, dense_out

    def _cross(self, a: Ragged, b: Ragged, s: FeatureSpec) -> Ragged:
        """Per-row cartesian hash-combine, densified at (ka, kb) caps, as
        the reference computes it (its final gather, by the uncompacted
        mask, included)."""
        ka = kb = min(s.max_len or 8, 8)
        da, ma = a.to_padded(ka, pad_value=0)
        db, mb = b.to_padded(kb, pad_value=0)
        crossed = hash_combine(da[:, :, None], db[:, None, :])
        mask = (ma[:, :, None] & mb[:, None, :]).reshape(a.n_rows, -1)
        flat = torch.where(mask, crossed.reshape(a.n_rows, -1), PAD_ID)
        # compact each row's valid entries to the left so CSR is tight
        invalid = (~mask).to(torch.uint8)
        flat = torch.gather(flat, 1, torch.argsort(invalid, dim=1, stable=True))
        lens = mask.sum(dim=1, dtype=torch.int32)
        splits = torch.cat([torch.zeros((1,), dtype=torch.int32, device=lens.device),
                            torch.cumsum(lens, 0, dtype=torch.int32)])
        gorder = torch.argsort(invalid.reshape(-1), stable=True)
        return Ragged(flat.reshape(-1)[gorder], splits)

    def _group_column_ids(self, kind: str, cols: list[Ragged], device: torch.device) -> torch.Tensor:
        """The group's (N,) int32 column ids, column i's ``nnz_budget``
        entries holding i: built once for a group's budgets and device and
        kept, since a batch's budgets are fixed (no rebuild a call)."""
        key = (tuple(c.nnz_budget for c in cols), device)
        cached = self._column_ids.get(kind)
        if cached is None or cached[0] != key:
            ids = torch.cat([torch.full((n,), i, dtype=torch.int32, device=device) for i, n in enumerate(key[0])])
            cached = self._column_ids[kind] = (key, ids)
        return cached[1]

    def _maybe_truncate(self, r: Ragged, s: FeatureSpec) -> Ragged:
        if s.max_len is not None and s.transform != "raw" and s.pooling == "none":
            return r.truncate(s.max_len)
        return r
