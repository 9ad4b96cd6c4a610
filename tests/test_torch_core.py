"""Parity of the PyTorch port's IDMap, exchange and Embedding Engine
export/import with the JAX package: states, offsets and plans bit-equal,
gathered rows equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as j_blocks
from repro.core import embedding_engine as j_engine
from repro.core import exchange as j_exchange
from repro.core import idmap as j_idmap
from repro.core.feature_engine import FeatureSpec as JSpec
from repro_torch.core import blocks as t_blocks
from repro_torch.core import embedding_engine as t_engine
from repro_torch.core import exchange as t_exchange
from repro_torch.core import idmap as t_idmap
from repro_torch.core.feature_engine import FeatureSpec as TSpec


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _ids(r, n: int, n_pad: int, pool: int = 1 << 62) -> np.ndarray:
    """n unique ids (signed, from a seed) followed by n_pad PAD entries, shuffled."""
    ids = np.unique(r.integers(-pool, pool, size=4 * n, dtype=np.int64))[:n]
    ids = np.concatenate([ids, np.full(n_pad, -1, np.int64)])
    return r.permutation(ids)


def _assert_map_equal(tm: t_idmap.IDMap, jm) -> None:
    for f in t_idmap.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)


@pytest.mark.parametrize("cap,n_rows,max_probes", [(64, 40, 4), (64, 1000, 8), (257, 100, 32)])
def test_idmap_insert_and_lookup_bit_equal(cap, n_rows, max_probes):
    """Tiny capacities force long probe chains, probe overflow and row
    overflow; three rounds re-probe old ids beside new ones and PAD."""
    r = np.random.default_rng(cap + n_rows)
    jm = j_idmap.create(cap, n_rows, max_probes=max_probes)
    tm = t_idmap.create(cap, n_rows, "cpu", max_probes=max_probes)
    seen = np.zeros(0, np.int64)
    for step in range(3):
        fresh = _ids(r, 30, 5)
        ids = r.permutation(np.concatenate([fresh, seen[:10]]))
        jm, j_off, j_new, j_met = j_idmap.lookup_or_insert(jm, jnp.asarray(ids), jnp.int32(step + 1))
        tm, t_off, t_new, t_met = t_idmap.lookup_or_insert(tm, _t(ids), step + 1)
        np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
        np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
        assert {k: int(v) for k, v in t_met.items()} == {k: int(v) for k, v in j_met.items()}
        _assert_map_equal(tm, jm)
        probe = np.concatenate([ids, _ids(r, 8, 2)])
        np.testing.assert_array_equal(t_idmap.lookup(tm, _t(probe)).numpy(),
                                      np.asarray(j_idmap.lookup(jm, jnp.asarray(probe))))
        seen = np.concatenate([seen, fresh[fresh != -1]])


def test_idmap_overflows_are_exercised():
    """The parity above covers both overflow kinds: check they really occur."""
    r = np.random.default_rng(1)
    tm = t_idmap.create(64, 40, "cpu", max_probes=4)
    tm, _, _, met = t_idmap.lookup_or_insert(tm, _t(_ids(r, 60, 4)), 1)
    assert int(met["idmap_probe_overflow"]) > 0 and int(met["idmap_row_overflow"]) > 0


def _spec_pair(D, U, C, R):
    return (j_exchange.ExchangeSpec(axes=("data",), n_devices=D, u_budget=U, per_dest_cap=C,
                                    recv_budget=R),
            t_exchange.ExchangeSpec(n_devices=D, u_budget=U, per_dest_cap=C, recv_budget=R))


@pytest.mark.parametrize("D,U,C,R,L,n_uniq", [
    (4, 64, 32, 64, 80, 40),     # fits
    (4, 24, 32, 64, 80, 40),     # dedupe budget truncates
    (4, 64, 6, 24, 80, 40),      # send buckets overflow
    (1, 16, 8, 8, 40, 30),       # both, one device
])
def test_build_send_plan_bit_equal(D, U, C, R, L, n_uniq):
    r = np.random.default_rng(L + U + C)
    uniq = _ids(r, n_uniq, 0)
    ids = r.choice(uniq, size=L)
    ids[r.random(L) < 0.15] = -1
    js, ts = _spec_pair(D, U, C, R)
    j_send, j_plan, j_met = j_exchange.build_send(jnp.asarray(ids), js)
    t_send, t_plan, t_met = t_exchange.build_send(_t(ids), ts)
    np.testing.assert_array_equal(t_send.numpy(), np.asarray(j_send))
    for f in t_exchange.Plan._fields:
        np.testing.assert_array_equal(getattr(t_plan, f).numpy(), np.asarray(getattr(j_plan, f)),
                                      err_msg=f)
    assert {k: int(v) for k, v in t_met.items()} == {k: int(v) for k, v in j_met.items()}
    # requester-side merge of what this device would receive back
    recv = np.asarray(j_send)
    j_u, j_inv, j_ok, j_m2 = j_exchange.owner_merge(jnp.asarray(recv), js)
    t_u, t_inv, t_ok, t_m2 = t_exchange.owner_merge(_t(recv), ts)
    for a, b in ((t_u, j_u), (t_inv, j_inv), (t_ok, j_ok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t_m2["exch_recv_overflow"]) == int(j_m2["exch_recv_overflow"])


def test_owner_merge_truncates_bit_equal():
    r = np.random.default_rng(3)
    recv = _ids(r, 50, 14).reshape(4, 16)
    js, ts = _spec_pair(4, 64, 16, 32)
    j_u, j_inv, j_ok, j_m = j_exchange.owner_merge(jnp.asarray(recv), js)
    t_u, t_inv, t_ok, t_m = t_exchange.owner_merge(_t(recv), ts)
    for a, b in ((t_u, j_u), (t_inv, j_inv), (t_ok, j_ok)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(t_m["exch_recv_overflow"]) == int(j_m["exch_recv_overflow"]) > 0


@pytest.mark.parametrize("U,C,R", [(64, 256, 128), (24, 32, 16)])
def test_fetch_and_route_rows_equal(U, C, R):
    """Serve-path fetch on one device: plan, rows_r and routed rows equal,
    with some ids never inserted (they read as zeros)."""
    r = np.random.default_rng(U)
    dim, n_rows, cap = 8, 64, 128
    known = _ids(r, 40, 0)
    unknown = _ids(r, 10, 0)
    ids = r.choice(np.concatenate([known, unknown]), size=90)
    ids[r.random(90) < 0.1] = -1
    emb = r.normal(size=(n_rows, dim)).astype(np.float32)

    jm, _, _, _ = j_idmap.lookup_or_insert(j_idmap.create(cap, n_rows), jnp.asarray(known), jnp.int32(1))
    jb = j_blocks.Blocks(emb=jnp.asarray(emb), slots={})
    tm, _, _, _ = t_idmap.lookup_or_insert(t_idmap.create(cap, n_rows, "cpu"), _t(known), 1)
    tb = t_blocks.Blocks(emb=_t(emb), slots={})
    js, ts = _spec_pair(1, U, C, R)
    _, _, j_rows, j_plan, j_met = j_exchange.fetch(jm, jb, jnp.asarray(ids), js, jnp.int32(2), False)
    _, _, t_rows, t_plan, t_met = t_exchange.fetch(tm, tb, _t(ids), ts, torch.tensor(2), False)
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    for f in t_exchange.Plan._fields:
        np.testing.assert_array_equal(getattr(t_plan, f).numpy(), np.asarray(getattr(j_plan, f)),
                                      err_msg=f)
    assert {k: int(v) for k, v in t_met.items()} == {k: int(v) for k, v in j_met.items()}
    np.testing.assert_array_equal(t_exchange.route_rows(t_rows, t_plan, ts).numpy(),
                                  np.asarray(j_exchange.route_rows(j_rows, j_plan, js)))


def _engines(dim=8):
    kw = dict(rows_per_shard=256, map_capacity_per_shard=512, u_budget=64, per_dest_cap=256,
              recv_budget=128)
    feats = [("f0", None), ("f1", "f0"), ("f2", None)]
    j = j_engine.EmbeddingEngine(
        [JSpec(n, emb_dim=dim, shared_table=s) for n, s in feats],
        j_engine.EngineConfig(mesh_axes=("data",), n_devices=1, **kw))
    t = t_engine.EmbeddingEngine(
        [TSpec(n, emb_dim=dim, shared_table=s) for n, s in feats],
        t_engine.EngineConfig(n_devices=1, **kw), "cpu")
    return j, t


def test_import_export_round_trip_equal():
    r = np.random.default_rng(11)
    n, dim = 150, 8
    ids = _ids(r, n, 0)
    rows = {"dim8": {
        "ids": ids,
        "emb": r.normal(size=(n, dim)).astype(np.float32),
        "slots": {"m": r.normal(size=(n, dim)).astype(np.float32),
                  "v": r.random(size=(n, dim)).astype(np.float32)},
        "last_use": r.integers(0, 100, size=n).astype(np.int32),
    }}
    je, te = _engines()
    j_state = je.import_rows(rows)
    t_state = te.import_rows(rows)
    _assert_map_equal(t_state["dim8"]["idmap"], j_state["dim8"]["idmap"])
    np.testing.assert_array_equal(t_state["dim8"]["blocks"].emb.numpy(),
                                  np.asarray(j_state["dim8"]["blocks"].emb))
    j_out, t_out = je.export_rows(j_state)["dim8"], te.export_rows(t_state)["dim8"]
    for k in ("ids", "emb", "last_use"):
        np.testing.assert_array_equal(t_out[k], j_out[k], err_msg=k)
    for k in ("m", "v"):
        np.testing.assert_array_equal(t_out["slots"][k], j_out["slots"][k], err_msg=k)
    order = np.argsort(t_out["ids"])
    src = np.argsort(ids)
    np.testing.assert_array_equal(t_out["emb"][order], rows["dim8"]["emb"][src])


def test_engine_ids_and_salts_equal():
    import repro.io.ragged as j_ragged
    from repro_torch.io.ragged import Ragged

    r = np.random.default_rng(12)
    je, te = _engines()
    assert te.salts == {k: int(v) for k, v in je.salts.items()}
    j_batch, t_batch = {}, {}
    for name in ("f0", "f1", "f2"):
        jr = j_ragged.Ragged.from_lists([_ids(r, k, 0) for k in (1, 0, 2, 1)], nnz_budget=6)
        j_batch[name] = jr
        t_batch[name] = Ragged(_t(jr.values), _t(jr.row_splits))
    np.testing.assert_array_equal(te.engine_ids(t_batch)["dim8"].numpy(),
                                  np.asarray(je.engine_ids(j_batch)["dim8"]))


@pytest.mark.parametrize("pooling,k", [("none", 8), ("none", 3), ("tile", 4), ("tile", 1), ("tile", 0)])
@pytest.mark.parametrize("split_dtype", [np.int32, np.int64])
def test_pool_sequence_and_tile_equal(pooling, k, split_dtype):
    """``_pool``'s none and tile branches (the sequence-tile op) against the
    reference's ``rows[idx] * mask`` in fp32, and their gradients against
    jax.vjp of it: empty rows, rows longer than k, a padding tail. Exact
    (torch.equal semantics: the reference's masked slots may hold -0.0)."""
    import jax
    import repro.io.ragged as j_ragged
    from repro_torch.io.ragged import Ragged

    r = np.random.default_rng(k + (pooling == "tile"))
    n_rows, dim, budget = 12, 8, 60
    lens = r.integers(0, 7, size=n_rows)
    lens[::4] = 0
    splits = np.minimum(np.concatenate([[0], np.cumsum(lens)]), budget - 5).astype(split_dtype)
    rows = r.normal(size=(budget, dim)).astype(np.float32)
    g_shape = (n_rows, k, dim) if pooling == "none" else (n_rows, max(k, 1) * dim)
    g = r.normal(size=g_shape).astype(np.float32)
    kw = dict(max_len=k) if pooling == "none" else dict(tile_k=k)
    jspec = JSpec("s", emb_dim=dim, pooling=pooling, **kw)
    tspec = TSpec("s", emb_dim=dim, pooling=pooling, **kw)
    jr = j_ragged.Ragged(jnp.zeros(budget, jnp.int64), jnp.asarray(splits))
    want, vjp = jax.vjp(lambda x: j_engine._pool(x, jr, jspec), jnp.asarray(rows))
    (want_g,) = vjp(jnp.asarray(g))
    tr = Ragged(torch.zeros(budget, dtype=torch.int64), _t(splits))
    x = _t(rows).requires_grad_()
    got = t_engine._pool(x, tr, tspec)
    (got_g,) = torch.autograd.grad(got, x, _t(g))
    assert got.shape == want.shape
    assert torch.equal(got.detach(), _t(want)) and torch.equal(got_g, _t(want_g))
    assert got_g[int(splits[-1]):].abs().sum() == 0
