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
names and the twin resumes from the reference's; delta checkpoints and a
missing card raise."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as j_train
from repro.launch.mesh import make_test_mesh
from repro.models.recsys import dlrm as j_dlrm
from repro_torch import obs as t_obs
from repro_torch.checkpoint import saver as t_saver
from repro_torch.convert import dense_from_numpy
from repro_torch.launch import train as t_train
from repro_torch.models.recsys import dlrm as t_dlrm

STEPS, BATCH = 6, 32
# the MIXED tolerance of the loss in tests/test_torch_train.py (_atol): a
# mean near log 2, 2e-2 allows a few bf16 ulps of the logits
LOSS_ATOL = 2e-2
SRC = str(Path(__file__).resolve().parents[1] / "src")
FLAGS = ["--arch", "dlrm-mlperf", "--batch", str(BATCH), "--log-every", "1"]


def _records(path) -> dict:
    return {r["step"]: r["metrics"] for r in t_obs.read_jsonl(path) if r.get("type") == "step" and "metrics" in r}


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
    real_init = t_dlrm.init

    def init_like_reference(cfg, seed=0, device=None):
        model = real_init(cfg, seed, device)
        params = jax.tree.map(np.asarray, j_dlrm.init(jax.random.PRNGKey(seed), cfg))
        model.load_state_dict(dense_from_numpy(params, cfg))
        return model

    mp.setattr(t_dlrm, "init", init_like_reference)
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
    with pytest.raises(NotImplementedError, match="A4"):
        t_train.main(FLAGS + ["--device", "cpu", "--ckpt-mode", "delta", "--ckpt-dir", str(tmp_path)])


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(FLAGS + ["--steps", "1"])
