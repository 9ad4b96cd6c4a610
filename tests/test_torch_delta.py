"""The port's incremental checkpoints and crash recovery (``repro_torch.ft``:
dirty, hooks, delta, recovery) against the JAX package's (``repro.ft``) on
the CPU, on the same numpy inputs: the tracker's drains and counters, the
batch marks of ``FTTrainerHooks``, chains written from the same imported
rows, marks and discards (byte-identical file for file), each package
recovering the other's chain, chain replay, the base / delta / compaction
policy, the crash matrix and the five-fault schedule on the port's twin of
``tests/ft_harness.py``, elastic recovery, the write_log seam's fault C4
(the reference drops the negative half of the engine ids, so an evicted
negative id comes back after its recovery; the port keeps every id but
PAD), and the feature cross and ``Ragged.live_nnz``."""
import numpy as np
import pytest
import torch

from ft_harness import FakeTrainer as JFake, batch_ids, build_engine as j_build_engine
from repro import ft as j_ft
from repro import obs as j_obs
from repro.core import write_log as j_wlog
from repro.core.embedding_engine import EmbeddingEngine as JEngine, EngineConfig as JConfig
from repro.core.feature_engine import FeatureEngine as JFeatures, FeatureSpec as JSpec
from repro.ft import manifest as j_man, recovery as j_rec
from repro.io.ragged import Ragged as JRagged
from repro_torch import ft as t_ft
from repro_torch import obs as t_obs
from repro_torch.core import write_log as t_wlog
from repro_torch.core.embedding_engine import EmbeddingEngine as TEngine, EngineConfig as TConfig
from repro_torch.core.feature_engine import FeatureEngine as TFeatures, FeatureSpec as TSpec
from repro_torch.ft import manifest as t_man, recovery as t_rec
from repro_torch.io.ragged import Ragged as TRagged
from repro_torch.launch.common import local_view, stacked
from repro_torch.optim.sparse_adam import SparseAdamConfig as TSopt
from repro_torch.storage import StorageConfig as TStorage
from repro.storage import StorageConfig as JStorage

GROUP = "dim4"
PAD = -1


@pytest.fixture(autouse=True)
def _observers():
    """Delta mode installs a process-wide write_log observer: restore both
    packages' after each test."""
    prev = j_wlog.get_observer(), t_wlog.get_observer()
    yield
    j_wlog.set_observer(prev[0])
    t_wlog.set_observer(prev[1])


def _io(man):
    io = man.FileIO()
    io.durable = False  # tests live in tmpdirs; skip fsync for speed
    return io


# ------------------------------------------------- the port's twin harness

def t_build_engine(n_devices=1, rows_per_shard=128, policy=None):
    """``ft_harness.build_engine``'s twin (the same sizes)."""
    specs = [TSpec("f", transform="hash", emb_dim=4, pooling="sum")]
    return TEngine(specs, TConfig(
        n_devices=n_devices, rows_per_shard=rows_per_shard, map_capacity_per_shard=2 * rows_per_shard,
        u_budget=32, per_dest_cap=32, recv_budget=32,
        storage=TStorage(policy=policy) if policy else None), "cpu")


class TFake:
    """``ft_harness.FakeTrainer``'s twin: an eager single-shard train loop
    whose batch ids are a pure function of the step, marking them through
    ``FTTrainerHooks.pre_step``."""

    def __init__(self, engine, tracker=None):
        self.engine = engine
        self.tracker = tracker
        self.hooks = t_ft.FTTrainerHooks(engine, lambda batch: batch, state_key=None)
        if tracker is not None:
            self.hooks.attach_tracker(tracker)
        self.state = engine.init_state()
        self.opt = TSopt(lr=0.1)
        self.step = 0

    def train_step(self):
        self.step += 1
        ids = {"f": TRagged.from_lists([batch_ids(self.step)], nnz_budget=8)}
        self.hooks.pre_step(self.state, ids, self.step)
        step = torch.tensor(self.step, dtype=torch.int32)
        stl, rows_r, plans, _ = self.engine.fetch_local(local_view(self.state), ids, step)
        stl = self.engine.update_local(stl, plans, {k: torch.ones_like(v) for k, v in rows_r.items()},
                                       self.opt, step)
        self.state = stacked(stl, self.state)

    def full_state(self):
        return {"sparse": self.state,
                "dense": {"w": np.full((3,), float(self.step), np.float32)},
                "step": np.int64(self.step)}

    def adopt(self, res):
        self.state = res.state["sparse"]
        self.step = res.step


def rows_equal(a, b):
    """Bit-exact export equality, order-insensitive (sorted by id)."""
    assert set(a) == set(b)
    for g in a:
        ra, rb = a[g], b[g]
        oa, ob = np.argsort(ra["ids"]), np.argsort(rb["ids"])
        np.testing.assert_array_equal(ra["ids"][oa], rb["ids"][ob])
        for k in ("emb", "last_use", "counts"):
            if k in ra or k in rb:
                np.testing.assert_array_equal(ra[k][oa], rb[k][ob], err_msg=k)
        assert set(ra["slots"]) == set(rb["slots"])
        for k in ra["slots"]:
            np.testing.assert_array_equal(ra["slots"][k][oa], rb["slots"][k][ob], err_msg=k)


def t_reference_run(total_steps: int) -> dict:
    tr = TFake(t_build_engine())
    snaps = {0: tr.engine.export_rows(tr.state)}
    for _ in range(total_steps):
        tr.train_step()
        snaps[tr.step] = tr.engine.export_rows(tr.state)
    return snaps


def t_run_chaos(directory, io, total_steps=12, save_every=2, *, max_chain_depth=2, n_shards=2, ref=None,
                max_sessions=32):
    """``ft_harness.run_chaos``'s twin: restart after every injected crash
    with a fresh engine, tracker and checkpointer; every recovery bit-equal
    to ``ref`` at its step."""
    recovered, attempts = [], []
    for _ in range(max_sessions):
        tracker = t_ft.DirtyTracker(registry=t_obs.MetricsRegistry())
        tr = TFake(t_build_engine(), tracker)
        ck = t_ft.DeltaCheckpointer(directory, tr.engine, tracker, n_shards=n_shards,
                                    max_chain_depth=max_chain_depth, compact_dirty_fraction=2.0,
                                    registry=t_obs.MetricsRegistry(), io=io)
        if ck.has_chain():
            res = ck.recover(like_state=tr.full_state())
            tr.adopt(res)
            recovered.append(res.step)
            if ref is not None:
                rows_equal(tr.engine.export_rows(tr.state), ref[res.step])
                np.testing.assert_array_equal(res.state["dense"]["w"], np.full((3,), float(res.step), np.float32))
                assert int(res.state["step"]) == res.step
        try:
            for s in range(tr.step + 1, total_steps + 1):
                tr.train_step()
                if s % save_every == 0:
                    compacting = ck.has_chain() and ck.chain[-1].chain_depth + 1 > max_chain_depth
                    try:
                        ck.save(tr.full_state(), s)
                        attempts.append((s, "ok", compacting))
                    except t_ft.InjectedCrash:
                        attempts.append((s, "crashed", compacting))
                        raise
            return recovered, attempts, tr
        except t_ft.InjectedCrash:
            continue
    raise AssertionError("chaos run did not converge within max_sessions")


# --------------------------------------------------------------- the tracker

def _drained(iv) -> tuple:
    return ({g: v.tolist() for g, v in iv.dirty.items()}, {g: v.tolist() for g, v in iv.dead.items()})


_METRICS = ("ckpt/rows_marked_dirty", "ckpt/rows_written", "ckpt/dirty_pending")


@pytest.mark.parametrize("seed", range(6))
def test_dirty_tracker_equal(seed):
    """Seeded sequences of mark, mark_dead, count_written, drain and
    merge_back (of any earlier drain): equal drains, pending counts and
    metrics after every operation."""
    r = np.random.default_rng(seed)
    regs = (j_obs.MetricsRegistry(), t_obs.MetricsRegistry())
    trackers = (j_ft.DirtyTracker(registry=regs[0]), t_ft.DirtyTracker(registry=regs[1]))
    drained: list = [[], []]
    for _ in range(120):
        op = r.choice(["mark", "mark", "dead", "written", "drain", "merge"])
        g = f"g{r.integers(2)}"
        ids = r.integers(-40, 40, r.integers(0, 12))
        n = int(r.integers(0, 5))
        pick = int(r.integers(0, 1 << 30))
        for i, t in enumerate(trackers):
            if op == "mark":
                t.mark(g, ids)
            elif op == "dead":
                t.mark_dead(g, ids)
            elif op == "written":
                t.count_written(g, n)
            elif op == "drain":
                drained[i].append(t.drain())
            elif drained[i]:
                t.merge_back(drained[i][pick % len(drained[i])])
        assert trackers[1].pending() == trackers[0].pending()
        for name in _METRICS:
            assert regs[1].get(name).value == regs[0].get(name).value, (op, name)
    drained[0].append(trackers[0].drain())
    drained[1].append(trackers[1].drain())
    assert [_drained(iv) for iv in drained[1]] == [_drained(iv) for iv in drained[0]]
    assert any(iv.n_dirty() and iv.n_dead() for iv in drained[1])
    for iv in drained[1]:
        for v in (*iv.dirty.values(), *iv.dead.values()):
            assert v.dtype == np.int64


def test_write_log_seam_marks_equal_but_c4():
    """The seam's notes into each package's tracker: the port's marks are
    the reference's plus the negative ids (C4), PAD dropped by both."""
    ids = np.array([5, PAD, -7, 9, 3, -2], np.int64)
    flags = np.array([True, True, True, False, True, True])
    drains = []
    for wl, ft, obs in ((j_wlog, j_ft, j_obs), (t_wlog, t_ft, t_obs)):
        tracker = ft.DirtyTracker(registry=obs.MetricsRegistry())
        wl.set_observer(tracker)
        with wl.shard_scope(GROUP):
            wl.note_insert(ids, flags)
            wl.note_evict(np.array([11, -13, PAD], np.int64))
            wl.note_remove(np.array([9, -9], np.int64), np.array([True, True]))
        drains.append(_drained(tracker.drain()))
    j, t = drains
    assert j == ({GROUP: [3, 5, 9]}, {GROUP: [11]})
    assert t == ({GROUP: [-9, -7, -2, 3, 5, 9]}, {GROUP: [-13, 11]})


def test_hooks_mark_the_reference_batch_ids():
    """``FTTrainerHooks.pre_step``: the batch's unique non-PAD engine ids,
    bit for bit the reference's ``np.unique``."""
    je, te = j_build_engine(), t_build_engine()
    drains = []
    for eng, ft, obs, rag in ((je, j_ft, j_obs, JRagged), (te, t_ft, t_obs, TRagged)):
        tracker = ft.DirtyTracker(registry=obs.MetricsRegistry())
        hooks = ft.FTTrainerHooks(eng, lambda batch: batch, state_key=None)
        hooks.attach_tracker(tracker)
        for step in (1, 2, 3):
            hooks.pre_step(None, {"f": rag.from_lists([batch_ids(step), [7, 7]], nnz_budget=16)}, step)
        drains.append(_drained(tracker.drain()))
    assert drains[1] == drains[0]
    assert any(i < 0 for i in drains[1][0][GROUP]) and PAD not in drains[1][0][GROUP]


# -------------------------------------------------- frames written alike

def _engines(policy, rows=64):
    kw = dict(n_devices=1, rows_per_shard=rows, map_capacity_per_shard=2 * rows, u_budget=32, per_dest_cap=32,
              recv_budget=32)
    je = JEngine([JSpec("f", transform="hash", emb_dim=4, pooling="sum")],
                 JConfig(mesh_axes=(), storage=JStorage(policy=policy) if policy else None, **kw))
    return je, t_build_engine(rows_per_shard=rows, policy=policy)


def _seeded_rows(r, n: int) -> dict:
    ids = np.unique(r.integers(-(1 << 62), 1 << 62, size=2 * n, dtype=np.int64))[:n]
    r.shuffle(ids)
    return {GROUP: {"ids": ids, "emb": r.normal(size=(n, 4)).astype(np.float32),
                    "slots": {"m": r.normal(size=(n, 4)).astype(np.float32),
                              "v": r.random(size=(n, 4)).astype(np.float32)},
                    "last_use": r.integers(0, 40, n).astype(np.int32)}}


def _write_chains(tmp_path, policy):
    """Both packages import the same rows, mark the same dirty and dead ids
    (absent ones among them), discard (or, tiered, spill) the same stale
    rows with their own ``evict_to_host``, and save the same sequence: a
    base, two deltas, a compaction base, a delta. No arithmetic runs."""
    r = np.random.default_rng(5)
    rows = _seeded_rows(r, 90)
    engines = _engines(policy)
    out = []
    for eng, ft, obs in zip(engines, (j_ft, t_ft), (j_obs, t_obs)):
        d = tmp_path / type(eng).__module__.split(".")[0]
        tracker = ft.DirtyTracker(registry=obs.MetricsRegistry())
        ck = ft.DeltaCheckpointer(d, eng, tracker, n_shards=2, max_chain_depth=2, compact_dirty_fraction=2.0,
                                  registry=obs.MetricsRegistry(), io=_io(j_man if ft is j_ft else t_man))
        state = eng.import_rows(rows)
        exports, kinds = [], []
        rr = np.random.default_rng(9)
        for save in range(1, 6):
            live = rows[GROUP]["ids"]
            tracker.mark(GROUP, np.concatenate([rr.choice(live, 12, replace=False), rr.integers(0, 1 << 40, 3)]))
            if save == 3:
                ex = eng.export_rows(state)[GROUP]
                stale = ex["ids"][ex["last_use"] < 6]
                assert stale.size and (stale < 0).any()
                state, _ = eng.evict_to_host(state, 6)  # no observer: the marks are the test's
                (tracker.mark if policy else tracker.mark_dead)(GROUP, stale)
            if save == 4:
                tracker.mark_dead(GROUP, np.array([-5, 17], np.int64))  # never live
            full = {"sparse": state, "dense": {"w": np.full((3,), float(save), np.float32)},
                    "step": np.int64(save)}
            kinds.append(ck.save(full, 10 * save, cursor={"part": 0, "group": save, "batch": 2}).kind)
            exports.append(eng.export_rows(state))
        out.append((d, exports, kinds))
    return engines, out


@pytest.mark.parametrize("policy", [None, "lru"])
def test_chains_byte_identical_and_recover_across_packages(tmp_path, policy):
    engines, ((jd, jx, jk), (td, tx, tk)) = _write_chains(tmp_path, policy)
    assert tk == jk == ["base", "delta", "delta", "base", "delta"]
    names = sorted(p.name for p in jd.iterdir())
    assert sorted(p.name for p in td.iterdir()) == names
    assert any(n.startswith(t_man.FRAME_PREFIX) for n in names) and t_man.HEAD_NAME in names
    for n in names:
        assert (td / n).read_bytes() == (jd / n).read_bytes(), n
    rows_equal(tx[-1], jx[-1])
    if policy:
        assert engines[1].storage.host_rows() > 0
    # each package recovers the other's chain, bit-equal to the writer
    like = {"dense": {"w": np.zeros((3,), np.float32)}, "step": np.int64(0), "sparse": None}
    for (src, want), (eng, ft, obs) in (((jd, jx[-1]), (_engines(policy)[1], t_ft, t_obs)),
                                        ((td, tx[-1]), (_engines(policy)[0], j_ft, j_obs))):
        ck = ft.DeltaCheckpointer(src, eng, ft.DirtyTracker(registry=obs.MetricsRegistry()),
                                  registry=obs.MetricsRegistry())
        res = ck.recover(like_state=like)
        assert res.step == 50 and res.cursor == {"part": 0, "group": 5, "batch": 2}
        np.testing.assert_array_equal(res.state["dense"]["w"], np.full((3,), 5.0, np.float32))
        rows_equal(eng.export_rows(res.state["sparse"]), want)


# ----------------------------------------------------------------- replay

def _commit(man, d, io, seq, step, kind, tensors, parent=None, parent_sha=None, depth=0):
    name = f"{man.FRAME_PREFIX}{seq:08d}_0of1.safetensors"
    nbytes, digest = io.write_frame(d / name, tensors)
    m = man.Manifest(seq=seq, step=step, kind=kind, frames=[{"file": name, "nbytes": nbytes, "sha256": digest}],
                     parent=parent, parent_sha256=parent_sha, chain_depth=depth)
    return m, man.commit(d, m, io)


def _rows(ids, val):
    ids = np.asarray(ids, np.int64)
    n = ids.size
    return {"g/ids": ids, "g/emb": np.full((n, 2), val, np.float32),
            "g/slots/m": np.full((n, 2), val + 0.5, np.float32),
            "g/last_use": np.full((n,), int(val), np.int32), "__dense__/w": np.array([val], np.float32)}


def _chain4(d):
    """base{1,2,3,-4}@1 → delta{1@2, dead 2, -4} → delta{2@3} (resurrect)
    → delta{5@4, -4@4, dead 3, 9 (never live)}."""
    io = _io(t_man)
    t2 = _rows([1], 2.0)
    t2["g/dead"] = np.array([2, -4], np.int64)
    t4 = _rows([5, -4], 4.0)
    t4["g/dead"] = np.array([3, 9], np.int64)
    m1, s1 = _commit(t_man, d, io, 1, 10, "base", _rows([3, 1, -4, 2], 1.0))
    m2, s2 = _commit(t_man, d, io, 2, 20, "delta", t2, m1.name, s1, 1)
    m3, s3 = _commit(t_man, d, io, 3, 30, "delta", _rows([2], 3.0), m2.name, s2, 2)
    _commit(t_man, d, io, 4, 40, "delta", t4, m3.name, s3, 3)
    return t_man.load_chain(d)


WANT_PREFIX = {1: ([-4, 1, 2, 3], [1, 1, 1, 1], [1.0]), 2: ([1, 3], [2, 1], [2.0]),
               3: ([1, 2, 3], [2, 3, 1], [3.0]), 4: ([-4, 1, 2, 5], [4, 2, 3, 4], [4.0])}


@pytest.mark.parametrize("k", sorted(WANT_PREFIX))
def test_replay_tombstones_overwrites_resurrection_any_prefix(tmp_path, k):
    """The reference's ``TestReplay`` cases on a four-save chain: replaying
    ``chain[:k]`` gives the state at save k, in both packages alike."""
    chain = _chain4(tmp_path)
    rows, dense, n_files = t_rec.replay_rows(tmp_path, chain[:k])
    jrows, jdense, jn = j_rec.replay_rows(tmp_path, j_man.load_chain(tmp_path)[:k])
    ids, val, w = WANT_PREFIX[k]
    g = rows["g"]
    np.testing.assert_array_equal(g["ids"], ids)
    np.testing.assert_array_equal(g["emb"][:, 0], np.asarray(val, np.float32))
    np.testing.assert_array_equal(g["slots"]["m"][:, 0], np.asarray(val, np.float32) + 0.5)
    np.testing.assert_array_equal(g["last_use"], val)
    np.testing.assert_array_equal(dense["w"], w)
    assert n_files == jn == k
    jg = jrows["g"]
    for key in ("ids", "emb", "last_use"):
        assert g[key].dtype == jg[key].dtype
        np.testing.assert_array_equal(g[key], jg[key])
    np.testing.assert_array_equal(g["slots"]["m"], jg["slots"]["m"])
    np.testing.assert_array_equal(dense["w"], jdense["w"])


# ----------------------------------------------------------------- policy

def _policy_kinds(ft, obs, fake, engine, tmp_path, remark_all: bool, **kw):
    tracker = ft.DirtyTracker(registry=obs.MetricsRegistry())
    tr = fake(engine, tracker)
    ck = ft.DeltaCheckpointer(tmp_path, engine, tracker, registry=obs.MetricsRegistry(),
                              io=_io(j_man if ft is j_ft else t_man), **kw)
    kinds = []
    for s in range(1, 9):
        tr.train_step()
        if s == 7 and remark_all:  # touch every live row: a delta would cost a base
            tracker.mark(GROUP, engine.export_rows(tr.state)[GROUP]["ids"])
        if s % 2 == 0 or s == 7:
            man = ck.save(tr.full_state(), s)
            kinds.append((man.kind, man.chain_depth, man.extra["n_dirty"]))
    return kinds


@pytest.mark.parametrize("kw,remark_all", [(dict(max_chain_depth=2, compact_dirty_fraction=2.0), False),
                                           (dict(compact_dirty_fraction=0.5), True),
                                           (dict(compact_dirty_fraction=0.3), False)])
def test_policy_chooses_alike(tmp_path, kw, remark_all):
    """Base, delta and compaction chosen alike at ``max_chain_depth`` and at
    ``compact_dirty_fraction``, with the same dirty counts."""
    j = _policy_kinds(j_ft, j_obs, JFake, j_build_engine(), tmp_path / "j", remark_all, **kw)
    t = _policy_kinds(t_ft, t_obs, TFake, t_build_engine(), tmp_path / "t", remark_all, **kw)
    assert t == j
    kinds = [k for k, _, _ in t]
    assert kinds[0] == "base" and "delta" in kinds and kinds.count("base") >= 2


# ------------------------------------------------ crash matrix on the twin

CASES = [("crash@frame:3", 1), ("torn@frame:3", 2), ("crash@manifest:2", 1), ("crash@head:2", 2)]


@pytest.fixture(scope="module")
def t_ref():
    return t_reference_run(12)


@pytest.mark.parametrize("spec,d_recover", CASES)
def test_single_fault_recovers_bit_identical(tmp_path, t_ref, spec, d_recover):
    """``tests/test_robustness.py``'s single-fault matrix on the port: each
    fault lands during save@4, recovery falls back to save@2 bit-equal to the
    uninterrupted run, the restarted run converges to it, and the chain
    recovers onto another device count."""
    total = 8
    io = t_ft.ChaosIO(t_ft.ChaosSchedule.parse(spec))
    recovered, attempts, tr = t_run_chaos(tmp_path, io, total_steps=total, save_every=2, ref=t_ref)
    assert [str(e) for e in io.fired] == [spec]
    assert recovered == [2]
    assert [(s, st) for s, st, _ in attempts if st == "crashed"] == [(4, "crashed")]
    rows_equal(tr.engine.export_rows(tr.state), t_ref[total])
    e2 = t_build_engine(n_devices=d_recover)
    ck2 = t_ft.DeltaCheckpointer(tmp_path, e2, t_ft.DirtyTracker(registry=t_obs.MetricsRegistry()),
                                 registry=t_obs.MetricsRegistry())
    res = ck2.recover(like_state=TFake(e2).full_state())
    assert res.step == total
    rows_equal(e2.export_rows(res.state["sparse"]), t_ref[total])


def test_five_fault_schedule_recovers_bit_identical_everywhere(tmp_path, t_ref):
    spec = "crash@head:1,crash@frame:5,torn@frame:9,crash@manifest:4,crash@frame:17"
    total = 12
    io = t_ft.ChaosIO(t_ft.ChaosSchedule.parse(spec))
    recovered, attempts, tr = t_run_chaos(tmp_path, io, total_steps=total, save_every=2, ref=t_ref)
    assert sorted(str(e) for e in io.fired) == sorted(spec.split(","))
    assert recovered == [2, 4, 6, 6, 10]
    crashed = [(s, comp) for s, status, comp in attempts if status == "crashed"]
    assert crashed == [(2, False), (6, False), (8, True), (8, True), (12, False)]
    assert io.fired[2].action == "torn" and crashed[2][1]
    rows_equal(tr.engine.export_rows(tr.state), t_ref[total])
    for n_dev in (1, 2):
        e2 = t_build_engine(n_devices=n_dev)
        ck2 = t_ft.DeltaCheckpointer(tmp_path, e2, t_ft.DirtyTracker(registry=t_obs.MetricsRegistry()),
                                     registry=t_obs.MetricsRegistry())
        res = ck2.recover(like_state=TFake(e2).full_state())
        assert res.step == total
        rows_equal(e2.export_rows(res.state["sparse"]), t_ref[total])


def test_failed_save_merges_back_and_resume_is_idempotent(tmp_path):
    io = t_ft.ChaosIO(t_ft.ChaosSchedule.parse("crash@frame:1"))
    tracker = t_ft.DirtyTracker(registry=t_obs.MetricsRegistry())
    tr = TFake(t_build_engine(), tracker)
    ck = t_ft.DeltaCheckpointer(tmp_path, tr.engine, tracker, registry=t_obs.MetricsRegistry(), io=io)
    tr.train_step()
    before = tracker.pending()
    assert before > 0
    with pytest.raises(t_ft.InjectedCrash):
        ck.save(tr.full_state(), 1)
    assert tracker.pending() == before
    assert ck.save(tr.full_state(), 1).kind == "base" and tracker.pending() == 0
    e2 = t_build_engine()
    ck2 = t_ft.DeltaCheckpointer(tmp_path, e2, t_ft.DirtyTracker(registry=t_obs.MetricsRegistry()),
                                 registry=t_obs.MetricsRegistry())
    a, b = (ck2.recover(like_state=TFake(e2).full_state()) for _ in range(2))
    assert a.step == b.step == 1
    rows_equal(e2.export_rows(a.state["sparse"]), tr.engine.export_rows(tr.state))
    rows_equal(e2.export_rows(b.state["sparse"]), tr.engine.export_rows(tr.state))


# --------------------------------------------------------------------- C4

def test_c4_evicted_negative_id_stays_dead_in_the_port(tmp_path):
    """C4's smallest input: a base, then a plain engine's ``evict_to_host``
    discards a negative id, then a delta. The reference's tombstone filter
    drops the id, so its recovery brings the row back; the port's keeps it
    dead."""
    rows = {GROUP: {"ids": np.array([5, -7, 3], np.int64), "emb": np.ones((3, 4), np.float32),
                    "slots": {"m": np.zeros((3, 4), np.float32), "v": np.zeros((3, 4), np.float32)},
                    "last_use": np.array([10, 1, 10], np.int32)}}
    recovered = {}
    for name, eng, ft, obs, wl, mk in (("j", j_build_engine(), j_ft, j_obs, j_wlog, j_build_engine),
                                       ("t", t_build_engine(), t_ft, t_obs, t_wlog, t_build_engine)):
        d = tmp_path / name
        tracker = ft.DirtyTracker(registry=obs.MetricsRegistry())
        wl.set_observer(tracker)
        ck = ft.DeltaCheckpointer(d, eng, tracker, registry=obs.MetricsRegistry(), compact_dirty_fraction=2.0)
        state = eng.import_rows(rows)
        ck.save({"sparse": state, "step": np.int64(1)}, 1)
        state, met = eng.evict_to_host(state, 5)
        assert int(met[f"{GROUP}/evicted"]) == 1
        man = ck.save({"sparse": state, "step": np.int64(2)}, 2)
        assert man.kind == "delta"
        writer = sorted(eng.export_rows(state)[GROUP]["ids"].tolist())
        e2 = mk()
        res = ft.DeltaCheckpointer(d, e2, ft.DirtyTracker(registry=obs.MetricsRegistry()),
                                   registry=obs.MetricsRegistry()).recover(like_state={"step": np.int64(0)})
        recovered[name] = (writer, sorted(e2.export_rows(res.state["sparse"])[GROUP]["ids"].tolist()),
                           man.extra["n_dead"])
    assert recovered["j"] == ([3, 5], [-7, 3, 5], 0)  # the reference resurrects -7
    assert recovered["t"] == ([3, 5], [3, 5], 1)


# ------------------------------------------------------- cross, live_nnz

@pytest.mark.parametrize("seed,max_len", [(0, 3), (1, None), (2, 1)])
def test_cross_and_live_nnz_equal(seed, max_len):
    r = np.random.default_rng(seed)
    rows_a = [list(r.integers(-50, 50, r.integers(0, 5))) for _ in range(9)]
    rows_b = [list(r.integers(-50, 50, r.integers(0, 4))) for _ in range(9)]
    js = [JSpec("a", emb_dim=4), JSpec("b", emb_dim=4),
          JSpec("x", transform="cross", cross_of=("a", "b"), emb_dim=4, max_len=max_len)]
    ts = [TSpec("a", emb_dim=4), TSpec("b", emb_dim=4),
          TSpec("x", transform="cross", cross_of=("a", "b"), emb_dim=4, max_len=max_len)]
    jo, _ = JFeatures(js).apply({"a": JRagged.from_lists(rows_a, nnz_budget=40),
                                 "b": JRagged.from_lists(rows_b, nnz_budget=40)})
    to, _ = TFeatures(ts, "cpu").apply({"a": TRagged.from_lists(rows_a, nnz_budget=40),
                                        "b": TRagged.from_lists(rows_b, nnz_budget=40)})
    for k in ("a", "b", "x"):
        np.testing.assert_array_equal(to[k].values.numpy(), np.asarray(jo[k].values), err_msg=k)
        np.testing.assert_array_equal(to[k].row_splits.numpy(), np.asarray(jo[k].row_splits), err_msg=k)
        assert int(to[k].live_nnz()) == int(jo[k].live_nnz())
    assert int(to["x"].live_nnz()) > 0
