"""The port's chaos harness and manifest chain (``repro_torch.ft``) against
the JAX package's (``repro.ft``) on the CPU: the same schedules parse and
seed alike and fire in the same order, ``ChaosIO`` counts and injects,
manifests serialise to the same bytes, a chain committed by either package
loads in the other, and GC keeps the same files."""
import dataclasses
import os
import signal

import numpy as np
import pytest

from repro.checkpoint import safetensors_io as j_st
from repro.ft import chaos as j_chaos, manifest as j_man
from repro_torch.checkpoint import safetensors_io as t_st
from repro_torch.ft import chaos as t_chaos, manifest as t_man

SPEC = "crash@frame:3,torn@frame:5,crash@manifest:2,crash@head:1,crash@step:4,sigterm@step:7"


@pytest.mark.parametrize("spec", [SPEC, "sigterm@step:2", " crash@step:12 , ,torn@frame:1"])
def test_parse_equal(spec):
    j, t = j_chaos.ChaosSchedule.parse(spec), t_chaos.ChaosSchedule.parse(spec)
    assert str(t) == str(j)
    assert [dataclasses.astuple(e) for e in t.events] == [dataclasses.astuple(e) for e in j.events]
    assert [str(e) for e in t.io_events()] == [str(e) for e in j.io_events()]
    assert [str(e) for e in t.step_events()] == [str(e) for e in j.step_events()]


@pytest.mark.parametrize("bad", ["torn@manifest:1", "sigterm@frame:1", "explode@frame:1", "crash@disk:1",
                                 "crash@frame:0", "crash@frame", "frame:1"])
def test_invalid_events_rejected_by_both(bad):
    for chaos in (j_chaos, t_chaos):
        with pytest.raises(ValueError):
            chaos.ChaosSchedule.parse(bad)


def test_seeded_equal():
    for seed in range(40):
        for n_events, max_count in ((5, 8), (9, 3)):
            assert str(t_chaos.ChaosSchedule.seeded(seed, n_events, max_count)) == \
                str(j_chaos.ChaosSchedule.seeded(seed, n_events, max_count))
    assert str(t_chaos.ChaosSchedule.seeded(7)) != str(t_chaos.ChaosSchedule.seeded(8))


def _fire(chaos, spec, steps):
    """Drive ``StepChaos`` over ``steps`` (some repeated); record what fired
    at each step: a crash, a SIGTERM through ``os.kill``, or nothing."""
    sc = chaos.StepChaos(chaos.ChaosSchedule.parse(spec))
    out = []
    for step in steps:
        try:
            sc.on_step(step)
            out.append((step, None))
        except chaos.InjectedCrash as e:
            out.append((step, str(e)))
    return out, [str(e) for e in sc.fired]


def test_step_chaos_fires_in_the_same_order(monkeypatch):
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    steps = [1, 2, 3, 4, 4, 5, 6, 7, 7, 8, 12, 12]
    spec = "crash@step:4,sigterm@step:7,crash@step:12,crash@frame:1"
    j = _fire(j_chaos, spec, steps)
    n_j = len(kills)
    t = _fire(t_chaos, spec, steps)
    assert t == j
    assert kills == [(os.getpid(), signal.SIGTERM)] * 2 and n_j == 1
    assert t[1] == ["crash@step:4", "sigterm@step:7", "crash@step:12"]


def test_chaos_io_counts_and_injects(tmp_path):
    io = t_chaos.ChaosIO(t_chaos.ChaosSchedule.parse("crash@frame:2,torn@frame:3,crash@manifest:1,crash@head:2"))
    t = {"x": np.zeros(64, np.float32)}
    io.write_frame(tmp_path / "a.st", t)
    with pytest.raises(t_chaos.InjectedCrash):
        io.write_frame(tmp_path / "b.st", t)       # crash: no file
    assert not (tmp_path / "b.st").exists()
    with pytest.raises(t_chaos.InjectedCrash):
        io.write_frame(tmp_path / "c.st", t)       # torn: half the bytes at the final path
    torn = (tmp_path / "c.st").read_bytes()
    assert 0 < len(torn) < len((tmp_path / "a.st").read_bytes())
    with pytest.raises(Exception):
        t_st.load_file(tmp_path / "c.st")
    io.write_frame(tmp_path / "d.st", t)
    with pytest.raises(t_chaos.InjectedCrash):
        io.write_manifest(tmp_path / "m.json", b"{}")
    io.write_head(tmp_path / "HEAD", "x")
    with pytest.raises(t_chaos.InjectedCrash):
        io.write_head(tmp_path / "HEAD", "y")
    assert io.counts == {"frame": 4, "manifest": 1, "head": 2}
    assert [str(e) for e in io.fired] == ["crash@frame:2", "torn@frame:3", "crash@manifest:1", "crash@head:2"]
    assert (tmp_path / "HEAD").read_text() == "x"
    assert j_st.load_file(tmp_path / "d.st")["x"].shape == (64,)


def _fields(m) -> dict:
    return dataclasses.asdict(m)


MANIFESTS = [
    dict(seq=1, step=10, kind="base", frames=[{"file": "f1", "nbytes": 8, "sha256": "ab"}], parent=None,
         parent_sha256=None, chain_depth=0, cursor={"part": 1, "group": 2, "batch": 3}),
    dict(seq=12, step=240, kind="delta", frames=[], parent="ft_manifest_00000011.json", parent_sha256="0" * 64,
         chain_depth=3, cursor=None, extra={"note": "ünïcode", "n": [1, 2.5]}),
]


@pytest.mark.parametrize("kw", MANIFESTS)
def test_manifest_bytes_equal(kw):
    data = t_man.Manifest(**kw).to_bytes()
    assert data == j_man.Manifest(**kw).to_bytes()
    assert t_man.Manifest(**kw).name == j_man.Manifest(**kw).name
    assert _fields(j_man.Manifest.from_bytes(data)) == _fields(t_man.Manifest.from_bytes(data)) == \
        _fields(t_man.Manifest(**kw))


def _io(man):
    io = man.FileIO()
    io.durable = False
    return io


def _chain(man, d, torn_last: bool = False):
    """Two chains (base, delta; base, delta) committed with ``man``'s
    functions, plus garbage: an orphan frame and a staging remnant."""
    io = _io(man)
    r = np.random.default_rng(0)
    parent = parent_sha = None
    for seq, kind, depth in ((1, "base", 0), (2, "delta", 1), (3, "base", 0), (4, "delta", 1)):
        name = f"{man.FRAME_PREFIX}{seq:08d}_0of1.safetensors"
        nbytes, digest = io.write_frame(d / name, {"rows": r.normal(size=(4, 3)).astype(np.float32),
                                                    "ids": np.arange(seq, seq + 4, dtype=np.int64)},
                                        {"step": str(10 * seq)})
        m = man.Manifest(seq=seq, step=10 * seq, kind=kind, frames=[{"file": name, "nbytes": nbytes,
                                                                     "sha256": digest}],
                         parent=parent, parent_sha256=parent_sha, chain_depth=depth,
                         cursor={"part": 0, "group": seq, "batch": 0})
        parent, parent_sha = m.name, man.commit(d, m, io)
    if torn_last:
        frame = d / f"{man.FRAME_PREFIX}{4:08d}_0of1.safetensors"
        frame.write_bytes(frame.read_bytes()[:10])
    (d / f"{man.FRAME_PREFIX}00000099_0of1.safetensors").write_bytes(b"torn leftover")
    (d / "x.tmp").write_bytes(b"staging remnant")
    return d


@pytest.mark.parametrize("torn_last", [False, True])
def test_chains_load_across_packages(tmp_path, torn_last):
    jd, td = (tmp_path / "j").resolve(), (tmp_path / "t").resolve()
    jd.mkdir()
    td.mkdir()
    _chain(j_man, jd, torn_last)
    _chain(t_man, td, torn_last)
    # the same commits give the same files, byte for byte
    assert sorted(p.name for p in jd.iterdir()) == sorted(p.name for p in td.iterdir())
    for p in jd.iterdir():
        assert (td / p.name).read_bytes() == p.read_bytes(), p.name
    for d in (jd, td):
        j_chain, t_chain = j_man.load_chain(d), t_man.load_chain(d)
        assert [_fields(m) for m in t_chain] == [_fields(m) for m in j_chain]
        assert [m.seq for m in t_chain] == ([3] if torn_last else [3, 4])
    frame = t_man.load_chain(jd)[-1].frames[0]["file"]
    np.testing.assert_array_equal(t_st.load_file(jd / frame)["ids"], j_st.load_file(jd / frame)["ids"])


@pytest.mark.parametrize("keep_chains", [1, 2])
def test_gc_keeps_the_same_files(tmp_path, keep_chains):
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir()
    td.mkdir()
    _chain(j_man, jd)
    _chain(t_man, td)
    j_del = j_man.gc(jd, _io(j_man), keep_chains=keep_chains)
    t_del = t_man.gc(td, _io(t_man), keep_chains=keep_chains)
    assert t_del == j_del and "x.tmp" in t_del
    assert sorted(p.name for p in td.iterdir()) == sorted(p.name for p in jd.iterdir())
    assert t_man.load_chain(td)[-1].step == 40


def test_gc_without_a_loadable_chain_deletes_nothing(tmp_path):
    _chain(t_man, tmp_path)
    for seq in (1, 3):
        frame = tmp_path / f"{t_man.FRAME_PREFIX}{seq:08d}_0of1.safetensors"
        frame.write_bytes(frame.read_bytes()[:8])
    before = sorted(p.name for p in tmp_path.iterdir())
    assert t_man.load_chain(tmp_path) is None is j_man.load_chain(tmp_path)
    assert t_man.gc(tmp_path, _io(t_man)) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == before
