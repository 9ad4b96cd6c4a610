"""The port's eviction and tiered-storage paths against the JAX package on
the CPU: IDMap ``remove`` and ``evict``, the Blocks tier-move ops, the host
tier, the cache policies, the write-observation seam, and the engine-level
tiered loop of tests/test_storage.py under each policy. Integers (IDMap
fields, offsets, counters, mirrors) are compared bit for bit, and so is every
float a tier move or the host tier produces: a move copies, it computes
nothing. Rows that SparseAdam updated are held to tests/test_torch_optim.py's
rtol of 1e-6 (the two frameworks round its fused arithmetic apart by an ulp
now and then); the port against itself, tiered against all-device, is bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as j_blocks
from repro.core import idmap as j_idmap
from repro.core import write_log as j_wlog
from repro.core.embedding_engine import EmbeddingEngine as JEngine, EngineConfig as JConfig
from repro.core.feature_engine import FeatureSpec as JSpec
from repro.io.ragged import Ragged as JRagged
from repro.optim.sparse_adam import SparseAdamConfig as JSopt
from repro.storage import HostStore as JHost, StorageConfig as JStorage
from repro.storage import policies as j_pol
from repro_torch.core import blocks as t_blocks
from repro_torch.core import idmap as t_idmap
from repro_torch.core import write_log as t_wlog
from repro_torch.core.embedding_engine import EmbeddingEngine as TEngine, EngineConfig as TConfig
from repro_torch.core.feature_engine import FeatureSpec as TSpec
from repro_torch.io.ragged import Ragged as TRagged
from repro_torch.launch.common import local_view, stacked
from repro_torch.optim.sparse_adam import SparseAdamConfig as TSopt
from repro_torch.storage import HostStore as THost, StorageConfig as TStorage
from repro_torch.storage import policies as t_pol


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _ids(r, n: int) -> np.ndarray:
    return np.unique(r.integers(-(1 << 62), 1 << 62, size=4 * n, dtype=np.int64))[:n]


def _maps_equal(tm, jm) -> None:
    for f in t_idmap.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)


def _filled_maps(seed: int, cap: int, n_rows: int, n: int):
    """Both packages' maps after two inserts with per-id last-use steps, and
    the ids inserted (the second insert overflows the rows when n_rows is
    small)."""
    r = np.random.default_rng(seed)
    ids = _ids(r, n)
    jm, tm = j_idmap.create(cap, n_rows), t_idmap.create(cap, n_rows, "cpu")
    for part in (ids[: n // 2], ids[n // 2:]):
        steps = r.integers(1, 20, part.size).astype(np.int32)
        jm, _, _, _ = j_idmap.lookup_or_insert(jm, jnp.asarray(part), jnp.asarray(steps))
        tm, _, _, _ = t_idmap.lookup_or_insert(tm, _t(part), _t(steps))
    _maps_equal(tm, jm)
    return jm, tm, ids, r


# ------------------------------------------------------------------- idmap

@pytest.mark.parametrize("cap,n_rows,n", [(256, 512, 150), (64, 512, 60), (512, 1024, 400)])
def test_remove_bit_equal(cap, n_rows, n):
    """Ids present, missing and PAD; the freed rows pushed in cumsum order,
    then a reinsertion that takes them back off the stack."""
    jm, tm, ids, r = _filled_maps(cap + n, cap, n_rows, n)
    gone = np.concatenate([r.choice(ids, n // 3, replace=False), _ids(r, 5), [-1, -1]])
    r.shuffle(gone)
    jm, j_offs, j_ok = j_idmap.remove(jm, jnp.asarray(gone))
    tm, t_offs, t_ok = t_idmap.remove(tm, _t(gone))
    _maps_equal(tm, jm)
    np.testing.assert_array_equal(t_offs.numpy(), np.asarray(j_offs))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert int(t_ok.sum()) > 0
    back = np.concatenate([gone[: gone.size // 2], _ids(r, 10)])
    jm, j_o, j_new, j_met = j_idmap.lookup_or_insert(jm, jnp.asarray(back), jnp.int32(30))
    tm, t_o, t_new, t_met = t_idmap.lookup_or_insert(tm, _t(back), 30)
    _maps_equal(tm, jm)
    np.testing.assert_array_equal(t_o.numpy(), np.asarray(j_o))
    assert {k: int(v) for k, v in t_met.items()} == {k: int(v) for k, v in j_met.items()}


def test_remove_never_frees_the_overflow_row():
    """Ids whose insert found no row sit on OVERFLOW_ROW: removing them
    clears their slots, and row 0 stays off the free stack (both packages)."""
    jm, tm, ids, _ = _filled_maps(5, 256, 40, 100)
    on_overflow = t_idmap.lookup(tm, _t(ids)).numpy() == t_idmap.OVERFLOW_ROW
    assert on_overflow.sum() > 10
    jm, _, j_ok = j_idmap.remove(jm, jnp.asarray(ids))
    tm, _, t_ok = t_idmap.remove(tm, _t(ids))
    _maps_equal(tm, jm)
    np.testing.assert_array_equal(t_ok.numpy(), ~on_overflow)
    assert not tm.occupied.any()
    assert (tm.free_stack[: int(tm.free_size)] != t_idmap.OVERFLOW_ROW).all()


@pytest.mark.parametrize("older_than", [0, 5, 10, 20, 100])
@pytest.mark.parametrize("cap,n_rows,n", [(256, 512, 150), (512, 1024, 400)])
def test_evict_bit_equal(cap, n_rows, n, older_than):
    jm, tm, ids, _ = _filled_maps(older_than + n, cap, n_rows, n)
    jm, j_n = j_idmap.evict(jm, jnp.int32(older_than))
    tm, t_n = t_idmap.evict(tm, older_than)
    _maps_equal(tm, jm)
    assert int(t_n) == int(j_n)
    assert (older_than in (0,)) == (int(t_n) == 0)


def test_evict_keeps_the_overflow_row_off_the_free_stack():
    """The one place the port leaves the reference (ROADMAP §C): the
    reference's evict pushes the OVERFLOW_ROW offset of a slot whose insert
    found no row, so a later insert is handed row 0 as a real row. The port
    clears and counts such a slot, and pushes only real rows."""
    jm, tm, ids, _ = _filled_maps(3, 64, 4, 8)  # 3 usable rows: 5 ids land on row 0
    jm, j_n = j_idmap.evict(jm, jnp.int32(100))
    tm, t_n = t_idmap.evict(tm, 100)
    assert int(t_n) == int(j_n) == 8
    np.testing.assert_array_equal(tm.occupied.numpy(), np.asarray(jm.occupied))
    j_stack = np.asarray(jm.free_stack)[: int(jm.free_size)]
    t_stack = tm.free_stack[: int(tm.free_size)].numpy()
    assert int(jm.free_size) == 8 and (j_stack == t_idmap.OVERFLOW_ROW).sum() == 5
    np.testing.assert_array_equal(t_stack, j_stack[j_stack != t_idmap.OVERFLOW_ROW])
    _, offs, is_new, _ = t_idmap.lookup_or_insert(tm, _t(_ids(np.random.default_rng(9), 3)), 101)
    assert is_new.all() and (offs != t_idmap.OVERFLOW_ROW).all()


# ------------------------------------------------------------------ blocks

def _blocks_pair(r, n_rows: int, dim: int):
    emb = r.normal(size=(n_rows, dim)).astype(np.float32)
    slots = {k: r.normal(size=(n_rows, dim)).astype(np.float32) for k in ("m", "v")}
    jb = j_blocks.Blocks(emb=jnp.asarray(emb), slots={k: jnp.asarray(v) for k, v in slots.items()})
    stacked_b = t_blocks.Blocks(emb=_t(emb)[None], slots={k: _t(v)[None] for k, v in slots.items()})
    return jb, stacked_b


def _blocks_equal(tb, jb) -> None:
    np.testing.assert_array_equal(tb.emb.numpy(), np.asarray(jb.emb))
    for k in jb.slots:
        np.testing.assert_array_equal(tb.slots[k].numpy(), np.asarray(jb.slots[k]), err_msg=k)


@pytest.mark.parametrize("dim,k", [(4, 1), (8, 40), (16, 100)])
def test_gather_write_clear_rows_bit_equal(dim, k):
    """The tier-move row ops on a view of the stacked state, written in
    place; offsets unique with OVERFLOW_ROW among them, masks mixed."""
    r = np.random.default_rng(dim + k)
    n_rows = 128
    jb, st = _blocks_pair(r, n_rows, dim)
    tb = st.map(lambda x: x[0])
    offs = r.permutation(n_rows)[:k].astype(np.int32)
    mask = r.random(k) < 0.7
    j_emb, j_slots = j_blocks.gather_with_slots(jb, jnp.asarray(offs))
    t_emb, t_slots = t_blocks.gather_with_slots(tb, _t(offs))
    np.testing.assert_array_equal(t_emb.numpy(), np.asarray(j_emb))
    for s in ("m", "v"):
        np.testing.assert_array_equal(t_slots[s].numpy(), np.asarray(j_slots[s]))
    new = {s: r.normal(size=(k, dim)).astype(np.float32) for s in ("e", "m", "v")}
    jb = j_blocks.write_rows(jb, jnp.asarray(offs), jnp.asarray(new["e"]),
                             {s: jnp.asarray(new[s]) for s in ("m", "v")}, jnp.asarray(mask))
    out = t_blocks.write_rows(tb, _t(offs), _t(new["e"]), {s: _t(new[s]) for s in ("m", "v")}, _t(mask))
    assert out.emb.data_ptr() == st.emb.data_ptr()
    _blocks_equal(st.map(lambda x: x[0]), jb)
    clear = r.random(k) < 0.5
    jb = j_blocks.clear_rows(jb, jnp.asarray(offs), jnp.asarray(clear))
    t_blocks.clear_rows(tb, _t(offs), _t(clear))
    _blocks_equal(st.map(lambda x: x[0]), jb)
    masked_off = offs[~(mask | clear)]
    assert masked_off.size == 0 or not (st.emb[0, masked_off] == 0).all()


# -------------------------------------------------------------- host store

def _host_ops(seed: int, init_cap: int, waste: float):
    """One random sequence of upserts (fresh, existing, repeated ids),
    removals and pops, applied to both host stores, checked after each."""
    r = np.random.default_rng(seed)
    j, t = JHost(3, init_capacity=init_cap, compact_waste=waste), THost(3, init_capacity=init_cap,
                                                                         compact_waste=waste)
    universe = _ids(r, 400)
    for it in range(40):
        op = r.integers(0, 3)
        ids = r.choice(universe, r.integers(1, 60))
        if op == 0:
            n = ids.size
            emb = r.normal(size=(n, 3)).astype(np.float32)
            slots = {k: r.normal(size=(n, 3)).astype(np.float32) for k in ("m", "v")}
            lu = r.integers(0, 100, n).astype(np.int32)
            j.put(ids, emb, slots, lu)
            t.put(ids, emb, slots, lu)
        elif op == 1:
            assert t.remove(ids) == j.remove(ids)
        else:
            jo, to = j.pop(ids), t.pop(ids)
            np.testing.assert_array_equal(to[0], jo[0])
            np.testing.assert_array_equal(to[1], jo[1])
            for k in ("m", "v"):
                np.testing.assert_array_equal(to[2][k], jo[2][k])
            np.testing.assert_array_equal(to[3], jo[3])
        yield it, j, t, universe


@pytest.mark.parametrize("seed,init_cap,waste", [(0, 16, 0.5), (1, 4, 0.1), (2, 1024, 0.5), (3, 8, 0.0)])
def test_host_store_bit_equal(seed, init_cap, waste):
    for _, j, t, universe in _host_ops(seed, init_cap, waste):
        assert (t.capacity, t.top, t.n_dead, t.n_rows, t.nbytes) == (j.capacity, j.top, j.n_dead, j.n_rows, j.nbytes)
        np.testing.assert_array_equal(t.contains(universe), j.contains(universe))
        je, te = j.export(), t.export()
        for k in ("ids", "emb", "last_use"):
            np.testing.assert_array_equal(te[k], je[k], err_msg=k)
        for k in ("m", "v"):
            np.testing.assert_array_equal(te["slots"][k], je["slots"][k])
        found, emb, slots, lu = t.get(universe)
        jf, jemb, jslots, jlu = j.get(universe)
        np.testing.assert_array_equal(found, jf)
        assert emb.dtype == jemb.dtype
        np.testing.assert_array_equal(emb, jemb)
        np.testing.assert_array_equal(lu, jlu)
    t.compact()
    j.compact()
    np.testing.assert_array_equal(t.export()["ids"], j.export()["ids"])
    t2, j2 = THost(3), JHost(3)
    t2.load(t.export())
    j2.load(j.export())
    assert (t2.capacity, t2.top, t2.n_rows) == (j2.capacity, j2.top, j2.n_rows)
    np.testing.assert_array_equal(t2.export()["emb"], j2.export()["emb"])


# ----------------------------------------------------------------- policies

@pytest.mark.parametrize("spec", ["lru", "lfu", "freq:2", "freq:3:lfu", "freq"])
def test_policies_equal(spec):
    """Victims in the same order (ties broken alike) and the same admission."""
    r = np.random.default_rng(len(spec))
    jp, tp = j_pol.make_policy(spec), t_pol.make_policy(spec)
    assert tp.name == jp.name
    for _ in range(20):
        n = int(r.integers(1, 300))
        ids = _ids(r, n)
        lu = r.integers(0, 6, n).astype(np.int32)  # many ties
        cnt = r.integers(0, 4, n).astype(np.int64)
        k = int(r.integers(0, n + 2))
        np.testing.assert_array_equal(tp.select_victims(ids, lu, cnt, k), jp.select_victims(ids, lu, cnt, k))
        np.testing.assert_array_equal(tp.admit(cnt), jp.admit(cnt))
    with pytest.raises(ValueError):
        t_pol.make_policy("arc")


# ------------------------------------------------------- write observation

class _Recorder:
    def __init__(self):
        self.events = []

    def mark(self, group, ids):
        self.events.append(("mark", group, np.asarray(ids).tolist()))

    def mark_dead(self, group, ids):
        self.events.append(("dead", group, np.asarray(ids).tolist()))

    def count_written(self, group, n):
        self.events.append(("written", group, int(n)))


class _Untouchable:
    """Raises on any read, as a device tensor's host copy would cost."""

    def __getattr__(self, name):
        raise AssertionError(f"read .{name}")

    def __array__(self, *a, **k):
        raise AssertionError("read as an array")


def _reference_filter(events: list) -> list:
    """The port's events as the reference records them: it keeps only ids
    >= 0 (C4, ROADMAP §C), and a mark left with no id is not sent."""
    out = []
    for kind, g, x in events:
        if kind in ("mark", "dead"):
            x = [i for i in x if i >= 0]
            if not x:
                continue
        out.append((kind, g, x))
    return out


def test_write_log_notes_equal():
    """Each note with an observer and a shard scope: the port keeps every id
    but PAD, the reference only ids >= 0, which also drops the negative half
    of the engine ids (C4, ROADMAP §C, repaired in the port)."""
    ids = np.array([5, -1, -7, 9, 3], np.int64)
    flags = np.array([True, True, True, False, True])
    out = []
    for wl, conv in ((j_wlog, jnp.asarray), (t_wlog, _t)):
        rec = _Recorder()
        prev = wl.set_observer(rec)
        try:
            with wl.shard_scope("dim8", 1):
                wl.note_insert(conv(ids), conv(flags))
                wl.note_remove(conv(ids), conv(~flags))
                wl.note_evict(conv(ids))
                wl.note_rows_written(conv(flags))
        finally:
            wl.set_observer(prev)
        out.append(rec.events)
    assert out[0][0] == ("mark", "dim8", [5, 3])
    assert out[1][0] == ("mark", "dim8", [5, -7, 3])
    assert out[1][2] == ("dead", "dim8", [5, -7, 9, 3])
    assert _reference_filter(out[1]) == out[0]


def test_write_log_without_observer_touches_nothing():
    assert t_wlog.get_observer() is None
    x = _Untouchable()
    for fn, args in ((t_wlog.note_insert, (x, x)), (t_wlog.note_remove, (x, x)),
                     (t_wlog.note_evict, (x,)), (t_wlog.note_rows_written, (x,))):
        fn(*args)
        with t_wlog.shard_scope("dim4"):
            fn(*args)
    prev = t_wlog.set_observer(_Recorder())
    try:
        t_wlog.note_insert(x, x)  # no shard scope: not attributed, not read
    finally:
        t_wlog.set_observer(prev)


# -------------------------------------------------- engine-level tiered loop

SOPT = dict(lr=0.1)


def _engines(rows=8, policy=None, n_devices=1):
    kw = dict(n_devices=n_devices, rows_per_shard=rows, map_capacity_per_shard=128, u_budget=16,
              per_dest_cap=16, recv_budget=16)
    je = JEngine([JSpec("f", transform="hash", emb_dim=4, pooling="sum")], JConfig(
        mesh_axes=(), storage=JStorage(policy=policy) if policy else None, **kw))
    te = TEngine([TSpec("f", transform="hash", emb_dim=4, pooling="sum")], TConfig(
        storage=TStorage(policy=policy) if policy else None, **kw), "cpu")
    return je, te


def _j_step(eng, state, ids_list, i, tiered=True):
    """tests/test_storage.py's single-shard step with value-dependent grads."""
    ids = {"f": JRagged.from_lists([list(ids_list)], nnz_budget=8)}
    met = {}
    if tiered:
        state, met = eng.storage_prefetch(state, ids, i)
    stl = jax.tree.map(lambda x: x[0], state)
    stl, rows, plans, fmet = eng.fetch_local(stl, ids, jnp.int32(i))
    stl = eng.update_local(stl, plans, {k: rows[k] * 0.5 for k in rows}, JSopt(**SOPT), jnp.int32(i))
    state = jax.tree.map(lambda S, L: S.at[0].set(L), state, stl)
    if tiered:
        state, amet = eng.storage_admit(state, i)
        met.update(amet)
    return state, met, {k: int(v) for k, v in fmet.items()}


def _t_step(eng, state, ids_list, i, tiered=True):
    ids = {"f": TRagged.from_lists([list(ids_list)], nnz_budget=8)}
    met = {}
    if tiered:
        state, met = eng.storage_prefetch(state, ids, i)
    stl, rows, plans, fmet = eng.fetch_local(local_view(state), ids, torch.tensor(i, dtype=torch.int32))
    stl = eng.update_local(stl, plans, {k: rows[k] * 0.5 for k in rows}, TSopt(**SOPT),
                           torch.tensor(i, dtype=torch.int32))
    state = stacked(stl, state)
    if tiered:
        state, amet = eng.storage_admit(state, i)
        met.update(amet)
    return state, met, {k: int(v) for k, v in fmet.items()}


RTOL = 1e-6  # SparseAdam's rows, with atol 1e-7, as tests/test_torch_optim.py holds them


def _exports_equal(te, ts, je, js) -> None:
    """The union exports, in their order (device rows, then host rows in
    arena order): ids, last use and counts bit-equal, the trained rows
    within RTOL."""
    a, b = te.export_rows(ts)["dim4"], je.export_rows(js)["dim4"]
    assert a.keys() == b.keys()
    for k in ("ids", "last_use", "counts"):
        if k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y, k in [(a["emb"], b["emb"], "emb")] + [(a["slots"][k], b["slots"][k], k) for k in ("m", "v")]:
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-7, err_msg=k)


def _stores_equal(t, j) -> None:
    """The stores' mirrors, host tiers and lifetime totals."""
    assert t.totals == j.totals
    for g in j.resident:
        for d, res in enumerate(j.resident[g]):
            keys, lus = t.resident[g][d].in_order()
            assert keys.tolist() == list(res) and lus.tolist() == list(res.values())
        keys, cnt = t.counts[g].in_order()
        assert keys.tolist() == list(j.counts[g]) and cnt.tolist() == list(j.counts[g].values())
        assert (t.host[g].capacity, t.host[g].top, t.host[g].n_dead) == \
               (j.host[g].capacity, j.host[g].top, j.host[g].n_dead)


@pytest.mark.parametrize("policy,rows,universe,seed", [
    ("lru", 8, 20, 0), ("lfu", 8, 20, 1), ("freq:2", 8, 20, 2),
    ("lru", 6, 40, 3), ("lfu", 12, 60, 4), ("freq:2:lfu", 6, 30, 5)])
def test_tiered_loop_bit_equal(policy, rows, universe, seed):
    """Heavy churn through a device tier far below the working set: every
    ``storage/*`` count and gauge per step, the fetch metrics, the IDMap,
    the mirrors, and the union export bit-equal to the reference's."""
    je, te = _engines(rows, policy)
    js, ts = je.init_state(), te.init_state()
    r = np.random.default_rng(seed)
    for i in range(1, 15):
        batch = r.integers(0, universe, 5)
        js, jm, jf = _j_step(je, js, batch, i)
        ts, tm, tf = _t_step(te, ts, batch, i)
        assert tm == jm, f"step {i}"
        assert tf == jf and tf["dim4/idmap_row_overflow"] == 0
        _maps_equal(ts["dim4"]["idmap"], js["dim4"]["idmap"])
        _stores_equal(te.storage, je.storage)
    assert te.storage.totals["demoted"] > 0 and te.storage.totals["promoted"] > 0
    _exports_equal(te, ts, je, js)


def test_tiered_matches_all_device_bit_for_bit():
    """The reference's own contract, on the port: a tier far below the
    working set trains exactly as an all-device engine does."""
    _, ctl = _engines(64)
    _, tier = _engines(8, "lru")
    sc, st = ctl.init_state(), tier.init_state()
    r = np.random.default_rng(0)
    for i in range(1, 15):
        batch = r.integers(0, 20, 5)
        sc, _, _ = _t_step(ctl, sc, batch, i, tiered=False)
        st, _, _ = _t_step(tier, st, batch, i)
    a, b = ctl.export_rows(sc)["dim4"], tier.export_rows(st)["dim4"]
    oa, ob = np.argsort(a["ids"]), np.argsort(b["ids"])
    np.testing.assert_array_equal(a["ids"][oa], b["ids"][ob])
    np.testing.assert_array_equal(a["emb"][oa], b["emb"][ob])
    for k in ("m", "v"):
        np.testing.assert_array_equal(a["slots"][k][oa], b["slots"][k][ob])


def test_write_log_marks_equal():
    """With an observer installed, the tier moves report the same marks and
    row-write counts in the same order as the reference's, the negative ids
    kept (C4)."""
    events = []
    for wl, eng_pair_idx, step in ((j_wlog, 0, _j_step), (t_wlog, 1, _t_step)):
        eng = _engines(6, "freq:2")[eng_pair_idx]
        rec = _Recorder()
        prev = wl.set_observer(rec)
        try:
            state = eng.init_state()
            r = np.random.default_rng(7)
            for i in range(1, 10):
                state, _, _ = step(eng, state, r.integers(0, 25, 5), i)
            state, _ = eng.evict_to_host(state, 8)
        finally:
            wl.set_observer(prev)
        events.append(rec.events)
    assert _reference_filter(events[1]) == events[0]
    assert any(i < 0 for e in events[1] if e[0] == "mark" for i in e[2])
    assert {e[0] for e in events[1]} == {"mark", "written"}


@pytest.mark.parametrize("policy,older_than", [(None, 7), ("lru", 8)])
def test_evict_to_host_equal(policy, older_than):
    """With a store the stale rows spill (the union export keeps them);
    without one they are discarded per shard under shard_scope."""
    je, te = _engines(8 if policy else 64, policy)
    js, ts = je.init_state(), te.init_state()
    r = np.random.default_rng(11)
    for i in range(1, 9):
        batch = r.integers(0, 12, 5)
        js, _, _ = _j_step(je, js, batch, i, tiered=policy is not None)
        ts, _, _ = _t_step(te, ts, batch, i, tiered=policy is not None)
    recs = []
    for wl in (j_wlog, t_wlog):
        recs.append(_Recorder())
        wl.set_observer(recs[-1])
    try:
        js, jm = je.evict_to_host(js, older_than)
        ts, tm = te.evict_to_host(ts, older_than)
    finally:
        j_wlog.set_observer(None)
        t_wlog.set_observer(None)
    assert {k: int(v) for k, v in tm.items()} == {k: int(v) for k, v in jm.items()}
    assert tm["spilled_stale" if policy else "dim4/evicted"] > 0
    _maps_equal(ts["dim4"]["idmap"], js["dim4"]["idmap"])
    _exports_equal(te, ts, je, js)
    assert _reference_filter(recs[1].events) == recs[0].events
    assert any(i < 0 for e in recs[1].events if e[0] in ("mark", "dead") for i in e[2])
    js, jmet, _ = _j_step(je, js, [1, 2, 3, 4, 5], 9, tiered=policy is not None)
    ts, tmet, _ = _t_step(te, ts, [1, 2, 3, 4, 5], 9, tiered=policy is not None)
    assert tmet == jmet
    _exports_equal(te, ts, je, js)


def test_evict_local_equal():
    je, te = _engines(64)
    js, ts = je.init_state(), te.init_state()
    r = np.random.default_rng(12)
    for i in range(1, 9):
        batch = r.integers(0, 30, 5)
        js, _, _ = _j_step(je, js, batch, i, tiered=False)
        ts, _, _ = _t_step(te, ts, batch, i, tiered=False)
    jl, jm = je.evict_local(jax.tree.map(lambda x: x[0], js), jnp.int32(5))
    tl, tm = te.evict_local(local_view(ts), 5)
    assert int(tm["dim4/evicted"]) == int(jm["dim4/evicted"]) > 0
    _maps_equal(tl["dim4"]["idmap"], jl["dim4"]["idmap"])


def test_checkpoint_payload_and_restore_equal():
    je, te = _engines(8, "lfu")
    js, ts = je.init_state(), te.init_state()
    r = np.random.default_rng(13)
    for i in range(1, 12):
        batch = r.integers(0, 24, 5)
        js, _, _ = _j_step(je, js, batch, i)
        ts, _, _ = _t_step(te, ts, batch, i)
    jp, tp = je.storage.checkpoint_payload(), te.storage.checkpoint_payload()
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype, k
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert tp["dim4/host/ids"].size > 0
    # restore the reference's payload into fresh stores beside the same state
    je2, te2 = _engines(8, "lfu")
    je2.storage.restore_payload(jp)
    je2.storage.sync_from_state(js)
    te2.storage.restore_payload(jp)
    te2.storage.sync_from_state(ts)
    _stores_equal(te2.storage, je2.storage)
    _exports_equal(te2, ts, je2, js)
    batch = r.integers(0, 24, 5)
    js, jm, _ = _j_step(je2, js, batch, 12)
    ts, tm, _ = _t_step(te2, ts, batch, 12)
    assert tm == jm
    _exports_equal(te2, ts, je2, js)


@pytest.mark.parametrize("policy,n_devices", [("lru", 1), ("lfu", 2)])
def test_import_union_export_across_tiers_equal(policy, n_devices):
    """The reference's union export (both tiers, with counts) imported into
    an engine whose device tier is too small: the hottest rows stay on the
    device, the rest land on the host, and every shard's IDMap, Blocks,
    mirror and host tier is the reference's."""
    je, _ = _engines(8, "lru")
    js = je.init_state()
    r = np.random.default_rng(14)
    for i in range(1, 12):
        js, _, _ = _j_step(je, js, r.integers(0, 20, 5), i)
    rows = je.export_rows(js)
    assert je.storage.host_rows() > 0 and "counts" in rows["dim4"]
    je2, te2 = _engines(8, policy, n_devices)
    js2, ts2 = je2.import_rows(rows), te2.import_rows(rows)
    _maps_equal(ts2["dim4"]["idmap"], js2["dim4"]["idmap"])
    _blocks_equal(ts2["dim4"]["blocks"], js2["dim4"]["blocks"])  # an import only copies
    _stores_equal(te2.storage, je2.storage)
    _exports_equal(te2, ts2, je2, js2)
    assert te2.storage.host_rows() > 0


def test_state_on_another_device_raises():
    """The device tier stays where the store is: a state elsewhere raises,
    nothing moves it."""
    _, te = _engines(8, "lru")
    state = te.init_state()
    state["dim4"]["blocks"] = state["dim4"]["blocks"].map(lambda x: x.to("meta"))
    with pytest.raises(ValueError, match="engine state is on meta"):
        te.storage_prefetch(state, {"f": TRagged.from_lists([[1, 2]], nnz_budget=8)}, 1)
