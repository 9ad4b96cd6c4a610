"""The LM train state across the packages, and the train cells' probe without
insertion, on the CPU:

  * ``convert.transformer_to_numpy`` inverts ``transformer_from_numpy``
    bit for bit, for a dense and a MoE smoke transformer;
  * after two qwen2.5-3b smoke train steps (one module-scoped JAX cell,
    Pallas attention in interpret mode), each package's saver writes its
    cell's state: the ``state/`` leaf names are equal; the port restores
    the reference's checkpoint and its next three steps match the JAX
    cell's (integers bit-equal, the loss, rows and params within
    tests/test_torch_lm.py's tolerances); the reference's saver restores
    the port's checkpoint, leaf by leaf equal to the port's state;
  * the drivers (``--arch qwen2.5-3b``; the reference's ``small_mesh``
    built by ``make_test_mesh``, as tests/test_torch_launch_train.py does)
    write checkpoints with equal leaf names, and the port's driver resumes
    from the reference's and repeats its losses within the MIXED tolerance;
  * the port's CLI crashed at step 4 exits 42, and its resume repeats the
    uninterrupted run's losses exactly;
  * ``CellOptions(train_insert=False)``: the LM train cell, from the saved
    engine state loaded into both packages, and the dlrm-mlperf smoke train
    cell (tests/test_torch_train.py's run) probe with ``lookup``: no id is
    inserted, integers are bit-equal to the JAX cells' and the losses
    agree."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import saver as j_saver
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCell as JShape
from repro.launch import lm_cell as j_lm
from repro.launch import train as j_train
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as j_tfm
from repro_torch import convert
from repro_torch import obs as t_obs
from repro_torch.checkpoint import saver as t_saver
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.core import idmap as t_idmap
from repro_torch.launch import train as t_train
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts
from test_torch_lm import TRAIN_STEPS, _adam_close
from test_torch_train import _atol, _run_steps

ARCH = "qwen2.5-3b"
T, B = 64, 2
SHAPE = {"seq_len": T, "global_batch": B}
SAVED_AT = 2  # steps before the checkpoint; TRAIN_STEPS more after it
LOSS_ATOL = 5e-3  # tests/test_torch_lm.py's MIXED loss tolerance (a mean near log 512)
SRC = str(Path(__file__).resolve().parents[1] / "src")
CLI = ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq-len", "32", "--log-every", "1"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("arch_id", ["qwen2.5-3b", "qwen2-moe-a2.7b"])
def test_transformer_to_numpy_inverts_from_numpy(arch_id):
    """The reference's initial tree → the port's state dict → the
    reference's tree: every leaf back, bit for bit, under its name."""
    jcfg, tcfg = j_get_config(arch_id, smoke=True).model, t_get_config(arch_id, smoke=True).model
    tree = _np_tree(j_tfm.init(jax.random.PRNGKey(5), jcfg))
    model = t_build_cell(arch_id, "train_4k", smoke=True, device="cpu",
                         shape_override=TShape("train_4k", "train", SHAPE)).init_state()["dense"]
    model.load_state_dict(convert.transformer_from_numpy(tree, tcfg))
    back = dict(_leaves(convert.transformer_to_numpy(model)))
    want = dict(_leaves(tree))
    assert sorted(back) == sorted(want)
    for name, w in want.items():
        assert back[name].dtype == np.float32 and back[name].flags.c_contiguous, name
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    if tcfg.moe is not None:
        assert {"layers/moe/router", "layers/moe/gate", "layers/moe/shared/down"} <= set(back)


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The JAX smoke train cell and the port's from one state (the JAX
    cell's dense params), two steps each, each package's checkpoint of its
    state; then the port from the reference's checkpoint, the reference's
    saver reading the port's, and three more steps on each side: with
    insertion, and with ``train_insert=False`` in both packages."""
    d = tmp_path_factory.mktemp("lm_state")
    mesh = make_test_mesh()
    jopts = JOpts(attn_impl="pallas", remat=True, zero1=False)
    jshape, tshape = JShape("train_4k", "train", SHAPE), TShape("train_4k", "train", SHAPE)
    jcell = j_build_cell(ARCH, "train_4k", mesh, jopts, smoke=True, shape_override=jshape)
    tcell = t_build_cell(ARCH, "train_4k", smoke=True, shape_override=tshape, device="cpu")
    cfg, tcfg = jcell.arch.model, tcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B * T, jopts)  # the cell keeps its engine to itself
    out = {"gkey": gkey, "tcell": tcell}
    with mesh:
        jstate = jcell.init_state()
        tstate = tcell.init_state()
        tstate["dense"].load_state_dict(convert.transformer_from_numpy(_np_tree(jstate["dense"]), tcfg))
        jstep = jax.jit(jcell.step_fn)
        for s in range(SAVED_AT):
            jstate, _ = jstep(jstate, jcell.make_batch(s))
            tstate, _ = tcell.step_fn(tstate, tcell.make_batch(s))
        j_saver.save({"state": jstate}, d / "j", step=SAVED_AT)
        t_saver.save({"state": tcell.state_tree(tstate)}, d / "t", step=SAVED_AT)
        out["names"] = {p: {n for n in t_saver.leaf_names(d / p, SAVED_AT) if n.startswith("state/")}
                        for p in ("j", "t")}
        out["port_tree"] = dict(t_saver._flatten(tcell.state_tree(tstate)))
        out["ref_reads_port"] = j_saver._flatten(j_saver.restore(d / "t", {"state": jstate}, SAVED_AT))
        fresh = tcell.init_state()
        tree = t_saver.restore(d / "j", {"state": tcell.state_tree(fresh)}, SAVED_AT)["state"]
        runs = {"insert": (jcell, tcell, jstep)}
        jcell_l = j_build_cell(ARCH, "train_4k", mesh, JOpts(attn_impl="pallas", remat=True, zero1=False,
                                                              train_insert=False),
                               smoke=True, shape_override=jshape)
        tcell_l = t_build_cell(ARCH, "train_4k", TOpts(train_insert=False), smoke=True, shape_override=tshape,
                               device="cpu")
        runs["lookup"] = (jcell_l, tcell_l, jax.jit(jcell_l.step_fn))
        out["restored"] = {"step": int(tree["step"])}
        for name, (jc, tc, step_fn) in runs.items():
            ts = tc.load_state_tree(tc.init_state(), tree)
            if name == "insert":
                out["restored"]["tree"] = dict(t_saver._flatten(tc.state_tree(ts)))
            js, steps = jstate, []
            for s in range(SAVED_AT, SAVED_AT + TRAIN_STEPS):
                js, jo = step_fn(js, jc.make_batch(s))
                ts, to = tc.step_fn(ts, tc.make_batch(s))
                steps.append(dict(
                    jo=_np_tree(jo), to=to, jmap=_np_tree(js["sparse"][gkey]["idmap"]),
                    tmap=ts["sparse"][gkey]["idmap"], jrows=jeng.export_rows(js["sparse"])[gkey],
                    trows=tc.engine.export_rows(ts["sparse"])[gkey],
                    jdense=convert.transformer_from_numpy(_np_tree(js["dense"]), tcfg),
                    tdense={k: v.detach().clone() for k, v in ts["dense"].state_dict().items()}))
            out[name] = steps
        out["saved_tree"] = j_saver._flatten({"state": jstate})
    return out


def test_checkpoints_have_the_reference_leaf_names(lm):
    names = lm["names"]
    assert names["t"] == names["j"]
    assert {"state/dense/layers/attn/wq/w", "state/dense/layers/attn/wk/b", "state/opt/m/layers/ffn/gate/w",
            "state/opt/v/head/w", "state/sparse/dim64/idmap/0", "state/sparse/dim64/blocks/1/0",
            "state/step"} <= names["j"]


def test_the_reference_restores_the_port_checkpoint_leaf_by_leaf(lm):
    """The reference's saver, given its own state as the template, reads the
    port's checkpoint back: every leaf the port wrote, shape, type and
    values."""
    got = lm["ref_reads_port"]
    want = {f"state/{k}": v for k, v in lm["port_tree"].items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_the_port_restores_the_reference_checkpoint_exactly(lm):
    """The port's state after loading the reference's checkpoint, laid out
    again by its ``state_tree``, is the reference's saved state leaf for
    leaf."""
    assert lm["restored"]["step"] == SAVED_AT
    got, want = lm["restored"]["tree"], lm["saved_tree"]
    assert sorted(f"state/{k}" for k in got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[f"state/{k}"], err_msg=k)


def _integers_equal(steps, gkey) -> list[dict]:
    mets = []
    for st in steps:
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        tm = {k: int(v) for k, v in st["to"].items() if k != "loss"}
        assert tm == jm
        mets.append(tm)
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(st["tmap"], f)[0].numpy(),
                                          np.asarray(getattr(st["jmap"], f))[0], err_msg=f)
        for k in ("ids", "last_use"):
            np.testing.assert_array_equal(st["trows"][k], st["jrows"][k], err_msg=k)
    return mets


def _losses_rows_params_agree(steps) -> None:
    for i, st in enumerate(steps):
        np.testing.assert_allclose(float(st["to"]["loss"]), float(st["jo"]["loss"]), rtol=0, atol=LOSS_ATOL,
                                   err_msg=f"step {i} loss")
        _adam_close(st["trows"]["emb"], st["jrows"]["emb"], f"step {i} rows")
        _adam_close(np.concatenate([st["tdense"][n].numpy().ravel() for n in st["jdense"]]),
                    np.concatenate([w.numpy().ravel() for w in st["jdense"].values()]), f"step {i} dense")


def test_resumed_from_the_reference_the_port_steps_as_it_does(lm):
    mets = _integers_equal(lm["insert"], lm["gkey"])
    assert sum(m[f"{lm['gkey']}/idmap_inserted"] for m in mets) > 0
    _losses_rows_params_agree(lm["insert"])


def test_train_insert_false_probes_with_lookup_as_the_reference(lm):
    """From the same restored state, ``train_insert=False``: nothing
    inserted, the rows live stay those of the checkpoint while the batches
    hold tokens never seen (they read zero rows and are not written back),
    integers bit-equal, loss, rows and params within the MIXED tolerances."""
    g = lm["gkey"]
    mets = _integers_equal(lm["lookup"], g)
    live = {m[f"{g}/dev_rows_live"] for m in mets}
    inserted = lm["insert"][0]["to"][f"{g}/idmap_inserted"]
    # a lookup reports no insert counter (in either package)
    assert all(m.get(f"{g}/idmap_inserted", 0) == 0 for m in mets) and len(live) == 1 and int(inserted) > 0
    _losses_rows_params_agree(lm["lookup"])
    assert len(lm["lookup"][-1]["trows"]["ids"]) == next(iter(live))


def test_train_insert_false_changes_no_idmap_and_moves_found_rows(lm):
    first, last = lm["lookup"][0], lm["lookup"][-1]
    for f in ("keys", "offsets"):
        assert torch.equal(getattr(first["tmap"], f), getattr(last["tmap"], f)), f
    assert not np.array_equal(first["trows"]["emb"], last["trows"]["emb"])


@pytest.fixture(scope="module")
def dlrm_lookup():
    """tests/test_torch_train.py's three dlrm-mlperf smoke steps (rows
    imported for all but every 7th id of the batches) with
    ``train_insert=False`` in both cells."""
    return _run_steps(insert=False)


def test_dlrm_train_insert_false_matches_the_reference(dlrm_lookup):
    live = set()
    for i, st in enumerate(dlrm_lookup):
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        assert {k: int(v) for k, v in st["to"].items() if k != "loss"} == jm
        assert jm.get("dim16/idmap_inserted", 0) == 0
        live.add(jm["dim16/dev_rows_live"])
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(st["tmap"], f)[0].numpy(),
                                          np.asarray(getattr(st["jmap"], f))[0], err_msg=f)
        for k in ("ids", "last_use"):
            np.testing.assert_array_equal(st["trows"][k], st["jrows"][k], err_msg=k)
        np.testing.assert_allclose(float(st["to"]["loss"]), float(st["jo"]["loss"]), rtol=0,
                                   atol=_atol("mixed", "loss", 1.0), err_msg=f"step {i}")
        np.testing.assert_allclose(st["trows"]["emb"], st["jrows"]["emb"], rtol=0,
                                   atol=_atol("mixed", "params", 1.0), err_msg=f"step {i} rows")
    assert len(live) == 1
    assert not np.array_equal(dlrm_lookup[0]["trows"]["emb"], dlrm_lookup[-1]["trows"]["emb"])


# ------------------------------------------------------------------ drivers

def _records(path) -> dict:
    return {r["step"]: r["metrics"] for r in t_obs.read_jsonl(path) if r.get("type") == "step" and "metrics" in r}


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """The reference's main() (4 steps, a checkpoint every 2) and the twin's
    (2 steps, a checkpoint at the end) with the same LM flags."""
    d = tmp_path_factory.mktemp("lm_drivers")
    flags = ["--arch", ARCH, "--batch", "2", "--seq-len", "32", "--log-every", "1"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    try:
        assert j_train.main(flags + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", str(d / "jck"),
                                     "--telemetry", str(d / "j.jsonl")]) == 0
    finally:
        mp.undo()
    assert t_train.main(flags + ["--device", "cpu", "--steps", "2", "--ckpt-dir", str(d / "tck")]) == 0
    return d


def test_driver_checkpoints_have_equal_leaf_names(drivers):
    j = {n for n in t_saver.leaf_names(drivers / "jck", 2) if n.startswith("state/")}
    t = {n for n in t_saver.leaf_names(drivers / "tck", 2) if n.startswith("state/")}
    assert t == j and "state/dense/layers/attn/wq/w" in j


def test_driver_resumes_from_the_reference_checkpoint(drivers, tmp_path):
    """The twin's driver, given the reference's step-2 checkpoint, runs
    steps 3 and 4 on the batches the reference's run took there: its losses
    within the MIXED tolerance of the reference's."""
    shutil.copytree(drivers / "jck" / "step_0000000002", tmp_path / "ck" / "step_0000000002")
    res, _ = t_train.run(t_train.build_parser().parse_args(
        CLI + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ck"), "--resume",
               "--telemetry", str(tmp_path / "t.jsonl")]), t_train.get_config(ARCH, smoke=True))
    assert res.resumed_from == 2 and res.steps_run == 2 and int(res.state["step"]) == 4
    want, got = _records(drivers / "j.jsonl"), _records(tmp_path / "t.jsonl")
    assert sorted(got) == [3, 4]
    for s in got:
        np.testing.assert_allclose(got[s]["loss"], want[s]["loss"], rtol=0, atol=LOSS_ATOL, err_msg=str(s))
        assert {k: int(v) for k, v in got[s].items() if "/" in k} == {k: int(v) for k, v in want[s].items()
                                                                      if "/" in k}


def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *CLI, *args], cwd=cwd,
                          env={**os.environ, "PYTHONPATH": SRC}, capture_output=True, text=True, timeout=300)


def test_cli_crash_exits_42_and_the_resume_repeats_the_run(tmp_path):
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


def test_lm_driver_still_refuses_delta_checkpoints_and_tables(tmp_path):
    args = t_train.build_parser().parse_args(CLI + ["--ckpt-mode", "delta", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="recsys-family checkpoint"):
        t_train.run(args, t_train.get_config(ARCH, smoke=True))
    args = t_train.build_parser().parse_args(CLI + ["--data-dir", str(tmp_path / "tbl")])
    with pytest.raises(ValueError, match="recsys-family data path"):
        t_train.run(args, t_train.get_config(ARCH, smoke=True))
