"""The port's train driver (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``) on the CPU: the same flags over six
dlrm-mlperf smoke steps give the same integer metrics and losses within the
MIXED tolerance, from the same dense weights (the twin's DLRM init is given
the reference's) and with the reference's ``small_mesh`` built by
``make_test_mesh`` (on this JAX, ``jax.make_mesh`` gives explicit axes, on
which the reference cell's step does not trace); neither patch changes a
file of either package. An injected
crash exits 42 and a resume repeats the uninterrupted run; a SIGTERM ends
the run preempted with a checkpoint; the ColumnIO path runs under the
autoscaler; a checkpoint of either package's driver holds the same state
names and the twin resumes from the reference's; with ``--ckpt-mode delta``
(both cells' MIXED set to FP32) both drivers write the same manifests and
frames, and each resumes from the other's chain; a missing card raises."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import write_log as j_wlog
from repro.launch import recsys_cell as j_recsys
from repro.launch import train as j_train
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro.models.recsys import dlrm as j_dlrm
from repro_torch import obs as t_obs
from repro_torch.checkpoint import saver as t_saver
from repro_torch.convert import params_from_tree
from repro_torch.core import write_log as t_wlog
from repro_torch.ft import manifest as t_man, recovery as t_rec
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.launch import train as t_train
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import dlrm as t_dlrm

STEPS, BATCH = 6, 32
# the MIXED tolerance of the loss in tests/test_torch_train.py (_atol): a
# mean near log 2, 2e-2 allows a few bf16 ulps of the logits
LOSS_ATOL = 2e-2
SRC = str(Path(__file__).resolve().parents[1] / "src")
FLAGS = ["--arch", "dlrm-mlperf", "--batch", str(BATCH), "--log-every", "1"]


def _records(path) -> dict:
    return {r["step"]: r["metrics"] for r in t_obs.read_jsonl(path) if r.get("type") == "step" and "metrics" in r}


_t_init = t_dlrm.init


def _init_like_reference(cfg, seed=0, device=None):
    """The twin's DLRM with the reference's initial dense params."""
    model = _t_init(cfg, seed, device)
    params = jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(seed), cfg))
    model.load_state_dict(params_from_tree(model, params))
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference main() and one twin main() with the same flags; the
    twin's DLRM starts from the reference's initial dense params."""
    d = tmp_path_factory.mktemp("train")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    try:
        assert j_train.main(FLAGS + ["--steps", str(STEPS), "--telemetry", str(d / "j.jsonl"),
                                     "--ckpt-dir", str(d / "jck")]) == 0
    finally:
        mp.undo()
    mp.setattr(t_dlrm, "init", _init_like_reference)
    try:
        assert t_train.main(FLAGS + ["--steps", str(STEPS), "--device", "cpu",
                                     "--telemetry", str(d / "t.jsonl"), "--ckpt-dir", str(d / "tck")]) == 0
    finally:
        mp.undo()
    return _records(d / "j.jsonl"), _records(d / "t.jsonl"), d


def test_main_matches_the_reference(runs):
    j, t, _ = runs
    assert sorted(t) == sorted(j) == list(range(1, STEPS + 1))
    for step in j:
        ints = {k: int(v) for k, v in j[step].items() if k != "loss"}
        assert {k: int(v) for k, v in t[step].items() if k != "loss"} == ints, step
        np.testing.assert_allclose(t[step]["loss"], j[step]["loss"], rtol=0, atol=LOSS_ATOL, err_msg=str(step))
    assert sum(j[s]["dim16/idmap_inserted"] for s in j) > 0
    assert all(np.isfinite(t[s]["loss"]) for s in t)


def test_checkpoints_cross_the_packages(runs, tmp_path):
    """The twin's checkpoint has the reference's state leaf names, and the
    twin resumes from the reference's checkpoint (its JAX state)."""
    *_, d = runs
    names = {n for n in t_saver.leaf_names(d / "jck", STEPS) if n.startswith("state/")}
    assert {n for n in t_saver.leaf_names(d / "tck", STEPS) if n.startswith("state/")} == names
    assert {"state/dense/bot/l0/w", "state/opt/m/top/l2/b", "state/sparse/dim16/idmap/0", "state/step"} <= names
    shutil.copytree(d / "jck", tmp_path / "ck")
    res, _ = t_train.run(t_train.build_parser().parse_args(
        FLAGS + ["--device", "cpu", "--steps", str(STEPS + 2), "--ckpt-dir", str(tmp_path / "ck"), "--resume",
                 "--telemetry", str(tmp_path / "t.jsonl")]), t_train.get_config("dlrm-mlperf", smoke=True))
    assert res.resumed_from == STEPS and res.steps_run == 2
    assert int(res.state["step"]) == STEPS + 2
    assert all(np.isfinite(m["loss"]) for m in _records(tmp_path / "t.jsonl").values())


def _cli(*args, cwd):
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *FLAGS, "--device", "cpu", *args],
                         cwd=cwd, env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=300)
    return out


def test_crash_exits_42_and_the_resume_repeats_the_run(tmp_path):
    full = _cli("--steps", "6", "--telemetry", str(tmp_path / "full.jsonl"), cwd=tmp_path)
    assert full.returncode == 0, full.stderr
    crash = _cli("--steps", "6", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
                 "--chaos-schedule", "crash@step:4", "--telemetry", str(tmp_path / "a.jsonl"), cwd=tmp_path)
    assert crash.returncode == t_train.CHAOS_EXIT == 42, crash.stderr
    assert "CHAOS: chaos: crash@step:4" in crash.stdout
    resumed = _cli("--steps", "6", "--ckpt-dir", str(tmp_path / "ck"), "--resume",
                   "--telemetry", str(tmp_path / "b.jsonl"), cwd=tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    # the save of step 3 waits for the save of step 2, so step 2 is committed
    start = int(resumed.stdout.split("resumed from step ")[1].split()[0])
    assert start in (2, 3)
    want, got = _records(tmp_path / "full.jsonl"), _records(tmp_path / "b.jsonl")
    assert sorted(got) == list(range(start + 1, 7))
    assert [got[s]["loss"] for s in got] == [want[s]["loss"] for s in got]
    assert sorted(_records(tmp_path / "a.jsonl")) == [1, 2, 3]


def test_sigterm_ends_preempted_with_a_checkpoint(tmp_path):
    out = _cli("--steps", "6", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "100",
               "--chaos-schedule", "sigterm@step:3", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "ran 3 steps, PREEMPTED" in out.stdout
    assert t_saver.latest_step(tmp_path / "ck") == 3


def test_data_dir_runs_under_the_autoscaler(tmp_path):
    res, ctl = t_train.run(t_train.build_parser().parse_args(
        FLAGS + ["--device", "cpu", "--steps", "8", "--data-dir", str(tmp_path / "tbl"), "--data-rows", "1024",
                 "--io-threads", "1", "--autoscale", "--ckpt-dir", str(tmp_path / "ck"),
                 "--telemetry", str(tmp_path / "t.jsonl")]),
        t_train.get_config("dlrm-mlperf", smoke=True))
    assert res.steps_run == 8 and not res.preempted
    assert ctl is not None and ctl.loader.n_readers >= 1
    assert ctl.registry.get("autoscale/readers").value == ctl.loader.n_readers
    assert sorted(_records(tmp_path / "t.jsonl")) == list(range(1, 9))
    assert len(list((tmp_path / "tbl").glob("part-*.col"))) == 4
    # the checkpoint holds the loader's consumer-side position
    assert {"cursor/part", "cursor/group", "cursor/batch"} <= set(t_saver.leaf_names(tmp_path / "ck", 8))


def test_delta_checkpoints_raise_naming_a4(tmp_path):
    """Delta mode is ported (ROADMAP A4): as in the reference, it needs a
    checkpoint directory, and writes a manifest chain there."""
    with pytest.raises(ValueError, match="--ckpt-mode delta requires --ckpt-dir"):
        t_train.main(FLAGS + ["--device", "cpu", "--ckpt-mode", "delta"])
    try:
        assert t_train.main(FLAGS + ["--device", "cpu", "--steps", "2", "--ckpt-mode", "delta",
                                     "--ckpt-every", "1", "--ckpt-dir", str(tmp_path)]) == 0
    finally:
        t_wlog.set_observer(None)
    # step 2 dirties over half the live rows: a compaction base, then the
    # run's final save, an empty delta
    assert [(m.step, m.kind) for m in t_man.load_chain(tmp_path)] == [(2, "base"), (2, "delta")]


# ------------------------------------------------------- delta checkpoints

DELTA_FLAGS = FLAGS + ["--steps", str(STEPS), "--ckpt-mode", "delta", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def delta_runs(tmp_path_factory):
    """Both drivers with ``--ckpt-mode delta``, saving every 2 steps, both
    cells' MIXED set to FP32 (the smoke train step is then held to 1e-5),
    the twin from the reference's dense params. Delta mode installs a
    process-wide write_log observer in each package: restored after."""
    d = tmp_path_factory.mktemp("delta")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    mp.setattr(j_recsys, "MIXED", j_layers.FP32)
    mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    mp.setattr(t_dlrm, "init", _init_like_reference)
    try:
        assert j_train.main(DELTA_FLAGS + ["--telemetry", str(d / "j.jsonl"), "--ckpt-dir", str(d / "jck")]) == 0
        assert t_train.main(DELTA_FLAGS + ["--device", "cpu", "--telemetry", str(d / "t.jsonl"),
                                           "--ckpt-dir", str(d / "tck")]) == 0
    finally:
        mp.undo()
        j_wlog.set_observer(None)
        t_wlog.set_observer(None)
    return d


def _chain_summary(directory) -> list:
    return [(m.step, m.kind, m.chain_depth, m.extra["n_dirty"], m.extra["n_dead"])
            for m in t_man.load_chain(directory)]


def test_delta_manifests_equal(delta_runs):
    """The same sequence of saves, with equal dirty and dead counts: the
    newest chain is step 4's base (a compaction: step 3 and 4 dirtied over
    half the live rows), a delta and the run's final save (an empty delta
    at the last step); the FP32 losses within 1e-5."""
    d = delta_runs
    want = _chain_summary(d / "jck")
    assert _chain_summary(d / "tck") == want
    assert [(s, k) for s, k, *_ in want] == [(4, "base"), (6, "delta"), (6, "delta")]
    assert want[1][3] > 0 and want[-1][3] == 0
    j, t = _records(d / "j.jsonl"), _records(d / "t.jsonl")
    assert sorted(t) == sorted(j) == list(range(1, STEPS + 1))
    for step in j:
        np.testing.assert_allclose(t[step]["loss"], j[step]["loss"], rtol=1e-5, err_msg=str(step))


def _group(key: str) -> str:
    """The tensor group a frame float is held within (tests/test_torch_train.py's
    groups): the dense params, each AdamW moment, the rows, each slot."""
    return "/".join(key.split("/")[:3 if key.startswith("__dense__/opt/") else 2])


def test_delta_frames_equal(delta_runs):
    """Frame for frame: the same tensor names, integers bit-equal, floats
    within 1e-5 of their group's largest magnitude (the FP32 smoke train
    step's tolerance)."""
    d = delta_runs
    for jm, tm in zip(t_man.load_chain(d / "jck"), t_man.load_chain(d / "tck"), strict=True):
        jf, tf = t_rec._read_manifest_tensors(d / "jck", jm), t_rec._read_manifest_tensors(d / "tck", tm)
        assert sorted(tf) == sorted(jf)
        assert {"dim16/ids", "dim16/emb", "dim16/slots/m", "__dense__/step", "__dense__/dense/bot/l0/w"} <= set(tf)
        scale: dict = {}
        for k, w in jf.items():
            if w.size and not np.issubdtype(w.dtype, np.integer):
                scale[_group(k)] = max(scale.get(_group(k), 0.0), float(np.abs(w).max()))
        for k, w in jf.items():
            assert tf[k].dtype == w.dtype and tf[k].shape == w.shape, k
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(tf[k], w, err_msg=k)
            else:
                np.testing.assert_allclose(tf[k], w, rtol=0, atol=1e-5 * max(scale.get(_group(k), 0.0), 1e-30),
                                           err_msg=k)


def test_delta_chains_resume_across_packages(delta_runs, tmp_path, capsys):
    """The twin resumes from the reference's chain and the reference from
    the twin's, each at the chain's last step."""
    d = delta_runs
    for src in ("jck", "tck"):
        shutil.copytree(d / src, tmp_path / src)
    more = FLAGS + ["--steps", str(STEPS + 2), "--ckpt-mode", "delta", "--ckpt-every", "2", "--resume"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    try:
        res, _ = t_train.run(t_train.build_parser().parse_args(
            more + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "jck"), "--telemetry", str(tmp_path / "t.jsonl")]),
            t_train.get_config("dlrm-mlperf", smoke=True))
        assert j_train.main(more + ["--ckpt-dir", str(tmp_path / "tck"), "--telemetry", str(tmp_path / "j.jsonl")]) == 0
    finally:
        mp.undo()
        j_wlog.set_observer(None)
        t_wlog.set_observer(None)
    assert res.resumed_from == STEPS and res.steps_run == 2 and int(res.state["step"]) == STEPS + 2
    assert f"resumed from step {STEPS}" in capsys.readouterr().out
    for f in ("t.jsonl", "j.jsonl"):
        got = _records(tmp_path / f)
        assert sorted(got) == [STEPS + 1, STEPS + 2] and all(np.isfinite(m["loss"]) for m in got.values())
    for src in ("jck", "tck"):
        assert t_man.load_chain(tmp_path / src)[-1].step == STEPS + 2


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(FLAGS + ["--steps", "1"])


@pytest.mark.parametrize("arch", ["wide-deep", "sasrec"])
def test_other_recsys_archs_train_from_a_table_as_the_reference(arch, tmp_path):
    """``--arch wide-deep`` and ``--arch sasrec`` over a ColumnIO table
    (synthesized by the reference's driver from ``datagen.gen_for_specs``:
    SASRec's item columns are ``seq_zipf`` sequences) through one loader
    thread, the twin's model started from the reference's initial dense
    params: the same integer metrics and losses within the MIXED tolerance
    (3e-2 for SASRec's per-position BCE, near 1.4: a few bf16 ulps), a
    checkpoint under the reference's state names."""
    from repro.models.recsys import sasrec as j_sasrec, wide_deep as j_wd
    from repro_torch.convert import params_from_tree
    from repro_torch.models.recsys import sasrec as t_sasrec, wide_deep as t_wd

    jm, tm = {"wide-deep": (j_wd, t_wd), "sasrec": (j_sasrec, t_sasrec)}[arch]
    t_init = tm.init

    def init_like_reference(cfg, seed=0, device=None):
        model = t_init(cfg, seed, device)
        jcfg = type(j_train.get_config(arch, smoke=True).model)(**vars(cfg))
        model.load_state_dict(params_from_tree(model, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jcfg))))
        return model

    steps = 4
    flags = ["--arch", arch, "--batch", "32", "--log-every", "1", "--steps", str(steps),
             "--data-dir", str(tmp_path / "table"), "--data-rows", "512", "--io-threads", "1"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    try:
        assert j_train.main(flags + ["--telemetry", str(tmp_path / "j.jsonl")]) == 0
    finally:
        mp.undo()
    mp.setattr(tm, "init", init_like_reference)
    try:
        assert t_train.main(flags + ["--device", "cpu", "--telemetry", str(tmp_path / "t.jsonl"),
                                     "--ckpt-dir", str(tmp_path / "tck")]) == 0
    finally:
        mp.undo()
    j, t = _records(tmp_path / "j.jsonl"), _records(tmp_path / "t.jsonl")
    assert sorted(t) == sorted(j) == list(range(1, steps + 1))
    for step in j:
        assert {k: int(v) for k, v in t[step].items() if k != "loss"} == \
               {k: int(v) for k, v in j[step].items() if k != "loss"}, step
        np.testing.assert_allclose(t[step]["loss"], j[step]["loss"], rtol=0, atol=3e-2, err_msg=str(step))
        assert all(v == 0 for k, v in t[step].items() if "overflow" in k)
    assert sum(v for s in t for k, v in t[s].items() if k.endswith("idmap_inserted")) > 0
    want = {"wide-deep": {"state/dense/bias", "state/dense/wide_proj/w"},
            "sasrec": {"state/dense/pos_emb", "state/dense/block0/ln1/scale", "state/opt/v/final_ln/bias"}}[arch]
    assert want <= set(t_saver.leaf_names(tmp_path / "tck", steps))
