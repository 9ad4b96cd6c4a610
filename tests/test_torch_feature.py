"""Parity of the PyTorch port's hashing, Feature Engine and Ragged helpers
with the JAX package: every integer output bit-equal, on the same numpy
inputs (int64 edge values included)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding_engine as j_engine
from repro.core import exchange as j_exchange
from repro.core import feature_engine as j_fe
from repro.core import idmap as j_idmap
from repro.io import ragged as j_ragged
from repro_torch.core import embedding_engine as t_engine
from repro_torch.core import exchange as t_exchange
from repro_torch.core import feature_engine as t_fe
from repro_torch.core import idmap as t_idmap
from repro_torch.io import ragged as t_ragged


I64 = np.iinfo(np.int64)


def _ids(seed: int, n: int = 4096) -> np.ndarray:
    r = np.random.default_rng(seed)
    edge = np.array([0, -1, 1, I64.min, I64.max, I64.min + 1, I64.max - 1,
                     2**32, 2**32 - 1, -(2**32), 2**63 - 2**31], dtype=np.int64)
    return np.concatenate([edge, r.integers(I64.min, I64.max, size=n, dtype=np.int64),
                           -r.integers(0, 1000, size=64, dtype=np.int64)])


def _u64_bits(x) -> np.ndarray:
    """A JAX uint64/int64 result as int64 bit patterns."""
    return np.asarray(x).astype(np.uint64).view(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_splitmix64_and_hash_combine_bit_equal(seed):
    x = _ids(seed)
    y = np.roll(x, 7)
    np.testing.assert_array_equal(
        t_fe.splitmix64(torch.from_numpy(x)).numpy(), _u64_bits(j_fe.splitmix64(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_fe.hash_combine(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        _u64_bits(j_fe.hash_combine(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("m", [1, 2, 3, 7, 1000, 78_080, 19_500_032, 2**31 - 1])
def test_unsigned_mod_matches_uint64(m):
    x = _ids(3)
    want = (x.view(np.uint64) % np.uint64(m)).astype(np.int64)
    np.testing.assert_array_equal(t_fe.umod(torch.from_numpy(x), m).numpy(), want)


def test_home_slot_and_owner_bit_equal():
    x = _ids(4)
    for cap in (64, 1000, 78_080):
        np.testing.assert_array_equal(
            t_idmap._home(torch.from_numpy(x), cap).numpy(),
            np.asarray(j_idmap._home(jnp.asarray(x), cap)))
    for d in (1, 4, 8):
        np.testing.assert_array_equal(
            t_exchange._owner_of(torch.from_numpy(x), d).numpy(),
            np.asarray(j_exchange._owner_of(jnp.asarray(x), d)))


@pytest.mark.parametrize("name", ["", "cat_0", "cat_25", "items", "wide_tbl_0", "ünïcode"])
def test_string_hashes_equal(name):
    assert t_fe._fnv1a(name) == j_fe._fnv1a(name)
    assert t_engine._stable_salt(name) == j_engine._stable_salt(name)


def test_fused_hash_and_mod_bit_equal():
    x = _ids(5)
    r = np.random.default_rng(5)
    cids = r.integers(0, 3, size=x.size).astype(np.int32)
    salts = np.array([0, 12345, I64.min], dtype=np.int64)
    vocab = np.array([1, 97, 4_000_000], dtype=np.int64)
    got = t_fe.fused_hash(torch.from_numpy(x), torch.from_numpy(cids), torch.from_numpy(salts))
    want = j_fe.fused_hash(jnp.asarray(x), jnp.asarray(cids), jnp.asarray(salts.view(np.uint64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = t_fe.fused_mod(torch.from_numpy(x), torch.from_numpy(cids), torch.from_numpy(vocab))
    want = j_fe.fused_mod(jnp.asarray(x), jnp.asarray(cids), jnp.asarray(vocab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_bucketize_bit_equal_on_boundaries():
    bounds = [[-1.0, 0.0, 0.5, 2.0], [10.0], [-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0]]
    flat = np.array(sum(bounds, []), dtype=np.float32)
    offs = np.cumsum([0] + [len(b) for b in bounds]).astype(np.int32)
    r = np.random.default_rng(6)
    cids = r.integers(0, 3, size=600).astype(np.int32)
    vals = r.normal(scale=3.0, size=600).astype(np.float32)
    vals[::5] = flat[offs[cids[::5]]]  # exactly on each column's first boundary
    vals[1::7] = np.array([-np.inf, np.inf, 3.0, -3.0, 10.0])[np.arange(vals[1::7].size) % 5]
    got = t_fe.fused_bucketize(torch.from_numpy(vals), torch.from_numpy(cids),
                               torch.from_numpy(flat), torch.from_numpy(offs))
    want = j_fe.fused_bucketize(jnp.asarray(vals), jnp.asarray(cids),
                                jnp.asarray(flat), jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _specs(mod):
    return [
        mod.FeatureSpec("a", transform="hash", emb_dim=8),
        mod.FeatureSpec("b", transform="hash", emb_dim=8, salt=99, shared_table="a"),
        mod.FeatureSpec("c", transform="hash", emb_dim=4, salt=7),
        mod.FeatureSpec("m", transform="mod", emb_dim=8, vocab_size=1000),
        mod.FeatureSpec("q", transform="bucketize", emb_dim=4, boundaries=(0.0, 1.0, 2.5)),
        mod.FeatureSpec("p", transform="bucketize", emb_dim=4, boundaries=(-5.0,)),
        mod.FeatureSpec("x", transform="raw", max_len=3),
    ]


def test_feature_engine_apply_bit_equal():
    r = np.random.default_rng(7)
    pool = _ids(8)
    rows = 9
    jbatch, tbatch = {}, {}
    for s in _specs(j_fe):
        k = s.max_len or 2
        lens = r.integers(0, k + 1, size=rows)
        if s.transform in ("bucketize", "raw"):
            vals = [r.normal(scale=3.0, size=n).astype(np.float32) for n in lens]
            budget, dtype = int(lens.sum()) + 3, jnp.float32
        else:
            vals = [r.choice(pool, size=n) for n in lens]
            budget, dtype = int(lens.sum()) + 3, jnp.int64
        jr = j_ragged.Ragged.from_lists(vals, nnz_budget=budget, dtype=dtype)
        jbatch[s.name] = jr
        tbatch[s.name] = t_ragged.Ragged(torch.from_numpy(np.array(jr.values)),
                                         torch.from_numpy(np.array(jr.row_splits)))
    j_ids, j_dense = j_fe.FeatureEngine(_specs(j_fe)).apply(jbatch)
    t_ids, t_dense = t_fe.FeatureEngine(_specs(t_fe), "cpu").apply(tbatch)
    assert set(t_ids) == set(j_ids) and set(t_dense) == set(j_dense)
    for k in j_ids:
        np.testing.assert_array_equal(t_ids[k].values.numpy(), np.asarray(j_ids[k].values))
        np.testing.assert_array_equal(t_ids[k].row_splits.numpy(), np.asarray(j_ids[k].row_splits))
    for k in j_dense:
        np.testing.assert_array_equal(t_dense[k].numpy(), np.asarray(j_dense[k]))


def test_bucketize_goes_through_the_fused_transform_op(monkeypatch):
    """The bucketize group runs ``ft_ops.fused_bucketize``, once for all its
    columns (on a CUDA tensor the kernel, on the CPU its plain version), and
    off the CPU and the card it raises instead of searching in plain code.
    The meta device stands in for a device without the kernel."""
    from repro_torch.kernels.fused_transform import ops as ft_ops

    calls = []
    real = ft_ops.fused_bucketize

    def spy(values, *args):
        calls.append(values.shape[0])
        return real(values, *args)

    monkeypatch.setattr(ft_ops, "fused_bucketize", spy)
    specs = [s for s in _specs(t_fe) if s.transform in ("hash", "bucketize")]
    r = np.random.default_rng(9)
    batch = {s.name: t_ragged.Ragged(
        torch.from_numpy(r.normal(size=4).astype(np.float32) if s.transform == "bucketize"
                         else r.integers(0, 100, size=4)),
        torch.tensor([0, 1, 4], dtype=torch.int32)) for s in specs}
    ids, _ = t_fe.FeatureEngine(specs, "cpu").apply(batch)
    assert calls == [8]  # the two bucketize columns' budgets, one call
    for s in specs:
        if s.transform == "bucketize":
            want = np.searchsorted(np.float32(s.boundaries), batch[s.name].values.numpy(), side="right")
            np.testing.assert_array_equal(ids[s.name].values.numpy(), want)
    meta = {k: t_ragged.Ragged(v.values.to("meta"), v.row_splits.to("meta")) for k, v in batch.items()}
    with pytest.raises(ValueError, match="fused_bucketize"):
        t_fe.FeatureEngine(specs, "meta").apply(meta)


def test_feature_engine_truncates_sequences_bit_equal():
    """Bucketize and sequence columns (pooling none, max_len) through both
    engines: rows longer than max_len cut, the CSR recompacted, bit-equal."""
    r = np.random.default_rng(10)
    specs = {m: [m.FeatureSpec("s", transform="hash", emb_dim=8, pooling="none", max_len=3),
                 m.FeatureSpec("t", transform="hash", emb_dim=8, pooling="none", max_len=1, salt=5),
                 m.FeatureSpec("q", transform="bucketize", emb_dim=8, boundaries=(-1.0, 0.0, 0.5)),
                 m.FeatureSpec("x", transform="raw", max_len=2)] for m in (j_fe, t_fe)}
    jbatch, tbatch = {}, {}
    for s in specs[j_fe]:
        lens = r.integers(0, 6, size=7)
        if s.transform in ("bucketize", "raw"):
            vals, dtype = [r.normal(size=n).astype(np.float32) for n in lens], jnp.float32
        else:
            vals, dtype = [r.integers(0, 1 << 40, size=n) for n in lens], jnp.int64
        jr = j_ragged.Ragged.from_lists(vals, nnz_budget=int(lens.sum()) + 2, dtype=dtype)
        jbatch[s.name] = jr
        tbatch[s.name] = t_ragged.Ragged(torch.from_numpy(np.array(jr.values)),
                                         torch.from_numpy(np.array(jr.row_splits)))
    j_ids, j_dense = j_fe.FeatureEngine(specs[j_fe]).apply(jbatch)
    t_ids, t_dense = t_fe.FeatureEngine(specs[t_fe], "cpu").apply(tbatch)
    for k in j_ids:
        np.testing.assert_array_equal(t_ids[k].values.numpy(), np.asarray(j_ids[k].values), err_msg=k)
        np.testing.assert_array_equal(t_ids[k].row_splits.numpy(), np.asarray(j_ids[k].row_splits), err_msg=k)
    assert int(t_ids["s"].row_lengths().max()) <= 3 and int(t_ids["t"].row_lengths().max()) <= 1
    np.testing.assert_array_equal(t_dense["x"].numpy(), np.asarray(j_dense["x"]))


@pytest.mark.parametrize("lens,budget,max_len", [
    ([2, 0, 3, 1], 9, 2), ([0, 0], 1, 1), ([4, 4, 4], 12, 3), ([1], 5, 4), ([6, 1, 5], 12, 2),
])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_ragged_truncate_equal(lens, budget, max_len, kind):
    r = np.random.default_rng(sum(lens) + budget + max_len)
    if kind == "int":
        rows, dtype = [r.integers(-50, 50, size=n) for n in lens], jnp.int64
    else:
        rows, dtype = [r.normal(size=n).astype(np.float32) for n in lens], jnp.float32
    jr = j_ragged.Ragged.from_lists(rows, nnz_budget=budget, dtype=dtype)
    tr = t_ragged.Ragged(torch.from_numpy(np.array(jr.values)), torch.from_numpy(np.array(jr.row_splits)))
    jt, tt = jr.truncate(max_len), tr.truncate(max_len)
    assert tt.values.dtype == tr.values.dtype and tt.row_splits.dtype == tr.row_splits.dtype
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(tt.row_splits.numpy(), np.asarray(jt.row_splits))


@pytest.mark.parametrize("lens,budget", [
    ([2, 0, 3, 1], 9), ([2, 0, 3, 1], 4), ([5, 5], 3), ([0, 0], None), ([1, 2], None), ([3, 3, 3], 7),
])
@pytest.mark.parametrize("kind,dtype", [("int", "int64"), ("float", "float32"), ("int", "float32"),
                                        ("float", "int64")])
def test_ragged_from_lists_equal(lens, budget, kind, dtype):
    """Whole tail rows dropped first, then a partial row; the padding follows
    the rows' own type (-1 after integers, 0 after floats or no values)."""
    r = np.random.default_rng(sum(lens) + (budget or 0))
    rows = [r.integers(-50, 50, size=n) if kind == "int" else r.normal(size=n) for n in lens]
    jr = j_ragged.Ragged.from_lists(rows, nnz_budget=budget, dtype=getattr(jnp, dtype))
    tr = t_ragged.Ragged.from_lists(rows, nnz_budget=budget, dtype=getattr(torch, dtype))
    assert tr.values.dtype == getattr(torch, dtype) and tr.row_splits.dtype == torch.int32
    np.testing.assert_array_equal(tr.values.numpy(), np.asarray(jr.values))
    np.testing.assert_array_equal(tr.row_splits.numpy(), np.asarray(jr.row_splits))


def test_concat_ragged_equal():
    r = np.random.default_rng(13)
    cols = [j_ragged.Ragged.from_lists([r.integers(0, 9, size=n) for n in lens], nnz_budget=b)
            for lens, b in (([1, 2], 4), ([0, 3, 1], 6), ([2], 2))]
    want = j_ragged.concat_ragged(cols)
    got = t_ragged.concat_ragged([t_ragged.Ragged(torch.from_numpy(np.array(c.values)),
                                                  torch.from_numpy(np.array(c.row_splits))) for c in cols])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("lens,budget", [([2, 0, 3, 1], 9), ([0, 0], 1), ([4, 4, 4], 12), ([1], 5)])
def test_ragged_helpers_equal(lens, budget):
    r = np.random.default_rng(sum(lens) + budget)
    rows = [r.integers(-50, 50, size=n) for n in lens]
    jr = j_ragged.Ragged.from_lists(rows, nnz_budget=budget)
    tr = t_ragged.Ragged(torch.from_numpy(np.array(jr.values)),
                         torch.from_numpy(np.array(jr.row_splits)))
    assert (tr.n_rows, tr.nnz_budget) == (jr.n_rows, jr.nnz_budget)
    np.testing.assert_array_equal(tr.row_lengths().numpy(), np.asarray(jr.row_lengths()))
    np.testing.assert_array_equal(tr.segment_ids().numpy(), np.asarray(jr.segment_ids()))
    np.testing.assert_array_equal(tr.valid_mask().numpy(), np.asarray(jr.valid_mask()))
    for max_len in (1, 3):
        t_out, t_mask = tr.to_padded(max_len, pad_value=-7)
        j_out, j_mask = jr.to_padded(max_len, pad_value=-7)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    x = r.normal(size=(len(lens), 3)).astype(np.float32)
    td, jd = t_ragged.Ragged.dense(torch.from_numpy(x)), j_ragged.Ragged.dense(jnp.asarray(x))
    np.testing.assert_array_equal(td.values.numpy(), np.asarray(jd.values))
    np.testing.assert_array_equal(td.row_splits.numpy(), np.asarray(jd.row_splits))


def test_apply_reuses_each_groups_column_ids(monkeypatch):
    """Each fused group's column-id tensor is built once for its budgets
    and device and reused by the next ``apply`` with the same budgets (the
    outputs equal); other budgets build it anew."""
    from repro_torch.kernels.fused_transform import ops as ft_ops

    seen = []
    real = ft_ops.fused_bucketize

    def spy(values, column_ids, *args):
        seen.append(column_ids)
        return real(values, column_ids, *args)

    monkeypatch.setattr(ft_ops, "fused_bucketize", spy)
    specs = [s for s in _specs(t_fe) if s.transform in ("hash", "bucketize")]
    eng = t_fe.FeatureEngine(specs, "cpu")

    def batch(seed, budget):
        r = np.random.default_rng(seed)
        return {s.name: t_ragged.Ragged(
            torch.from_numpy(r.normal(size=budget).astype(np.float32) if s.transform == "bucketize"
                             else r.integers(0, 100, size=budget)),
            torch.tensor([0, 1, budget - 1], dtype=torch.int32)) for s in specs}

    first, _ = eng.apply(batch(0, 5))
    hash_ids = eng._column_ids["hash"][1]
    again, _ = eng.apply(batch(0, 5))
    other, _ = eng.apply(batch(1, 5))
    assert seen[0] is seen[1] is seen[2] and eng._column_ids["hash"][1] is hash_ids
    assert torch.equal(seen[0], torch.tensor([0] * 5 + [1] * 5, dtype=torch.int32))
    for k in first:
        assert torch.equal(first[k].values, again[k].values)
    assert any(not torch.equal(first[k].values, other[k].values) for k in first)
    eng.apply(batch(0, 7))
    assert seen[3] is not seen[0] and torch.equal(seen[3], torch.tensor([0] * 7 + [1] * 7, dtype=torch.int32))
    assert eng._column_ids["hash"][1] is not hash_ids
