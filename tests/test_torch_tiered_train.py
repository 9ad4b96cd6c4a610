"""The tiered dlrm-mlperf smoke train cell and the online-window example of
the PyTorch port against the JAX package on the CPU, through each package's
Trainer: a device tier far below the working set (every step from the
second on demotes and promotes), a checkpoint that the reference's tiered
Trainer wrote (its host tier in ``extra.safetensors``) resumed in the port,
and the online-learning windows with eviction. Both cells' MIXED is set to
FP32 for these runs, and the port's tiered IDMap gets the reference's two
slots a row (no file of either package changes), so the losses agree within
1e-5; every counter and gauge is equal."""
import importlib.util
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.base import ShapeCell as JShape
from repro.launch import recsys_cell as j_recsys
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro.pipelines import OnlineWindowPipeline as JPipe, TrainConfig as JTrainCfg, Trainer as JTrainer
from repro.storage import StorageConfig as JStorage
from repro_torch import convert, obs as t_obs
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.examples import online_window as t_ow
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts
from repro_torch.models import layers as t_layers
from repro_torch.pipelines import TrainConfig as TTrainCfg, Trainer as TTrainer
from repro_torch.storage import StorageConfig as TStorage

BATCH, STEPS, RESUME_AT = 32, 6, 3
DEVICE_ROWS = 1024  # the device tier: a step holds 593-623 unique rows, 6 steps 2,766
LOSS_TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _j_cell():
    return j_build_cell("dlrm-mlperf", "train_batch", make_test_mesh(),
                        JOpts(remat=False, zero1=False, storage=JStorage("lru"), storage_device_rows=DEVICE_ROWS),
                        smoke=True, shape_override=JShape("train_batch", "train", {"batch": BATCH}))


def _t_cell():
    return t_build_cell("dlrm-mlperf", "train_batch", TOpts(storage=TStorage("lru"), storage_device_rows=DEVICE_ROWS),
                        smoke=True, device="cpu", shape_override=TShape("train_batch", "train", {"batch": BATCH}))


def _t_state(tcell, dense0):
    """A fresh port state with the reference's initial dense params (the
    engine rows start from the same id hash in both packages)."""
    st = tcell.init_state()
    st["dense"].load_state_dict(convert.params_from_tree(st["dense"], dense0))
    return st


def _j_run(cell, steps, ckpt=None, resume=False):
    cfg = JTrainCfg(total_steps=steps, log_every=1, watchdog=False, ckpt_dir=ckpt,
                    ckpt_every=RESUME_AT if ckpt else 0, resume=resume)
    tr = JTrainer(cell, cfg, hooks=cell.storage_hooks)
    with cell.mesh:
        state = cell.init_state()
        dense0 = jax.tree.map(np.asarray, state["dense"])
        state, start, _ = tr.try_resume(state)
        res = tr.run(state, (cell.make_batch(s) for s in range(start, steps)), start_step=start)
        rows = cell.engine.export_rows(res.state["sparse"])
    return res, dense0, rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's straight 6 steps, its 3-step run with a checkpoint at
    step 3 and its resume of that checkpoint to step 6; the port's straight
    6 steps from the same dense params, and its resume of the reference's
    checkpoint (a copy of the directory each)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_recsys, "MIXED", j_layers.FP32)
    mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    mp.setattr(t_recsys, "TIERED_MAP_FACTOR", 2)  # the reference's IDMap sizing, slot for slot
    ckpt = tmp_path_factory.mktemp("ref_tiered_ckpt")
    try:
        jres, dense0, jrows = _j_run(_j_cell(), STEPS)
        _j_run(_j_cell(), RESUME_AT, ckpt=str(ckpt / "j"))
        shutil.copytree(ckpt / "j", ckpt / "t")
        jresumed, _, _ = _j_run(_j_cell(), STEPS, ckpt=str(ckpt / "j"), resume=True)
        tcell = _t_cell()
        tres = TTrainer(tcell, TTrainCfg(total_steps=STEPS, log_every=1, watchdog=False),
                        hooks=tcell.storage_hooks, registry=t_obs.MetricsRegistry()).run(
            _t_state(tcell, dense0), (tcell.make_batch(s) for s in range(STEPS)))
        trows = tcell.engine.export_rows(tres.state["sparse"])
        # the port resumes the reference's checkpoint and runs to step 6
        rcell = _t_cell()
        rtr = TTrainer(rcell, TTrainCfg(total_steps=STEPS, log_every=1, watchdog=False, ckpt_dir=str(ckpt / "t"),
                                        ckpt_every=0, resume=True),
                       hooks=rcell.storage_hooks, registry=t_obs.MetricsRegistry())
        state, start, _ = rtr.try_resume(_t_state(rcell, dense0))
        rres = rtr.run(state, (rcell.make_batch(s) for s in range(start, STEPS)), start_step=start)
        return dict(jres=jres, jrows=jrows["dim16"], tres=tres, trows=trows["dim16"], rres=rres, start=start,
                    jresumed=jresumed, ckpt=ckpt / "t")
    finally:
        mp.undo()


def _storage(m: dict) -> dict:
    return {k: v for k, v in m.items() if k.startswith("storage/")}


def test_tier_churns_under_the_cell(runs):
    hist = runs["jres"].metrics_history
    assert sum(m["storage/demoted"] for m in hist) > 0 and sum(m["storage/promoted"] for m in hist) > 0
    assert hist[-1]["storage/host_rows"] > DEVICE_ROWS
    assert all(m["storage/device_rows"] <= DEVICE_ROWS - 1 for m in hist)


def test_trainer_losses_and_storage_metrics_agree(runs):
    jh, th = runs["jres"].metrics_history, runs["tres"].metrics_history
    assert len(th) == len(jh) == STEPS
    for i, (jm, tm) in enumerate(zip(jh, th)):
        assert _storage(tm) == _storage(jm), f"step {i + 1}"
        assert {k: tm[k] for k in jm if k.startswith("dim16/")} == {k: jm[k] for k in jm if k.startswith("dim16/")}
        assert tm["dim16/idmap_row_overflow"] == tm["storage/unplaceable"] == 0
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0, atol=LOSS_TOL, err_msg=f"step {i + 1}")


def test_union_export_agrees(runs):
    """Both tiers' rows after 6 steps: ids, last use and counts equal in
    order, the rows within 1e-5 of their largest magnitude (FP32: the same
    arithmetic up to summation order, as tests/test_torch_train.py)."""
    t, j = runs["trows"], runs["jrows"]
    for k in ("ids", "last_use", "counts"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for got, want, k in [(t["emb"], j["emb"], "emb")] + [(t["slots"][k], j["slots"][k], k) for k in ("m", "v")]:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def test_reference_tiered_checkpoint_resumes_in_the_port(runs):
    """The reference's step-3 checkpoint (state tree and extra.safetensors)
    resumes in the port: steps 4-6 give the reference's own resume's
    counters (a resume rebuilds the residency mirror from the IDMap, so its
    tie-breaks differ from a straight run's), and the losses of both
    packages' straight runs (the tier split changes no row)."""
    assert runs["start"] == RESUME_AT
    assert (runs["ckpt"] / f"step_{RESUME_AT:010d}" / "extra.safetensors").exists()
    rh, th, jh = runs["rres"].metrics_history, runs["tres"].metrics_history, runs["jres"].metrics_history
    jr = runs["jresumed"].metrics_history
    assert runs["rres"].resumed_from == runs["jresumed"].resumed_from == RESUME_AT
    assert len(rh) == len(jr) == STEPS - RESUME_AT
    for rm, jrm, tm, jm in zip(rh, jr, th[RESUME_AT:], jh[RESUME_AT:]):
        assert rm["step"] == tm["step"] == jrm["step"]
        assert _storage(rm) == _storage(jrm)
        assert rm["storage/promoted"] > 0
        for other in (jrm, jm, tm):
            np.testing.assert_allclose(rm["loss"], other["loss"], rtol=0, atol=LOSS_TOL)


def test_tiered_state_from_numpy_equals_the_union_import(runs):
    """The reference's union export imported into a fresh tiered port
    engine, and the same engine state carried across as a device-tier tree
    plus the store's payload, give the same union."""
    tcell = _t_cell()
    eng = tcell.engine
    j = runs["jrows"]
    state = eng.import_rows({"dim16": j})
    rows = eng.export_rows(state)["dim16"]
    order_a, order_b = np.argsort(rows["ids"]), np.argsort(j["ids"])
    for k in ("ids", "last_use", "counts", "emb"):
        np.testing.assert_array_equal(rows[k][order_a], j[k][order_b], err_msg=k)
    payload = eng.storage.checkpoint_payload()
    tree = {g: {"idmap": tuple(getattr(v["idmap"], f).numpy() for f in
                               ("keys", "occupied", "offsets", "last_use", "free_stack", "free_size", "next_row")),
                "blocks": (v["blocks"].emb.numpy(), tuple(v["blocks"].slots[k].numpy() for k in ("m", "v")))}
            for g, v in state.items()}
    eng2 = _t_cell().engine
    state2 = convert.tiered_state_from_numpy(eng2, tree, payload)
    rows2 = eng2.export_rows(state2)["dim16"]
    for k in ("ids", "last_use", "counts", "emb"):
        np.testing.assert_array_equal(rows2[k], rows[k], err_msg=k)
    assert eng2.storage.device_resident() == eng.storage.device_resident() > 0
    assert eng2.storage.host_rows() == eng.storage.host_rows() > 0


def _port_run(factor, storage_rows, steps, monkeypatch):
    """The port's dlrm cell (published MLP shapes cut, dim 16, vocab 2,000,
    batch 512, about 6,000 unique ids a step) for ``steps`` steps, tiered
    with ``storage_rows`` device rows and ``factor`` map slots a row, or all
    on the device (storage_rows None): (history, union export sorted by id)."""
    import dataclasses

    from repro_torch.configs import dlrm_mlperf

    monkeypatch.setattr(t_recsys, "TIERED_MAP_FACTOR", factor)
    arch = dataclasses.replace(dlrm_mlperf.ARCH, model=dataclasses.replace(
        dlrm_mlperf.ARCH.model, vocab_per_feature=2000, embed_dim=16, bot_mlp=(64, 16), top_mlp=(64, 1)))
    opts = TOpts(storage=TStorage("lru"), storage_device_rows=storage_rows) if storage_rows else TOpts()
    cell = t_recsys.build(arch, TShape("train_batch", "train", {"batch": 512}), opts, device="cpu")
    res = TTrainer(cell, TTrainCfg(total_steps=steps, log_every=1, watchdog=False, anomaly=False),
                   hooks=cell.storage_hooks, registry=t_obs.MetricsRegistry()).run(
        cell.init_state(), (cell.make_batch(30_000 + s, vocab=2000) for s in range(steps)))
    rows = cell.engine.export_rows(res.state["sparse"])["dim16"]
    o = np.argsort(rows["ids"])
    return res.metrics_history, [rows["ids"][o], rows["emb"][o], rows["slots"]["m"][o], rows["slots"]["v"][o]]


def test_tiered_map_sizing_loses_no_insert(monkeypatch):
    """ROADMAP §C: at the reference's two IDMap slots a device-tier row the
    tier keeps the map at half load, and a step loses an insert to probe
    exhaustion (its row then reads zeros): the run leaves the all-device
    one. At the port's four, no insert is lost and the run is bit-equal."""
    hist_c, rows_c = _port_run(2, None, 13, monkeypatch)
    for factor, lost in ((2, True), (4, False)):
        hist, rows = _port_run(factor, 9_000, 13, monkeypatch)
        probe = sum(m["dim16/idmap_probe_overflow"] for m in hist)
        assert sum(m["storage/unplaceable"] + m["dim16/idmap_row_overflow"] for m in hist) == 0
        same = [m["loss"] for m in hist] == [m["loss"] for m in hist_c] and all(
            np.array_equal(a, b) for a, b in zip(rows, rows_c))
        assert (probe > 0, same) == (lost, not lost), (factor, probe)


# ------------------------------------------------------------ online window

WINDOWS, STEPS_PER_WINDOW, EVICT_AGE = 3, 25, 30


def _reference_example():
    spec = importlib.util.spec_from_file_location("online_window_ref", ROOT / "examples" / "online_window.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_online_window_twin_agrees_with_the_example(monkeypatch):
    """The example's windows at cut sizes (3 windows of 25 steps, eviction
    age 30, so the second and third evictions discard rows): every step's
    loss within 1e-5, the pre-train evals too, the live rows every step,
    and each eviction's count and live rows equal."""
    ref = _reference_example()
    monkeypatch.setattr(ref, "MIXED", j_layers.FP32)
    jcell = ref.Cell()
    j_evictions = []

    def evict_fn(state, older_than):
        sp, met = jcell.engine.evict_local(state["sparse"], jax.numpy.int32(older_than))
        j_evictions.append({"evicted": int(sum(met.values())), "live": int(ref._live(sp))})
        return {**state, "sparse": sp}

    trainer = JTrainer(jcell, JTrainCfg(total_steps=0, watchdog=False, log_every=1, evict_age_steps=EVICT_AGE),
                       evict_fn=evict_fn)
    pipe = JPipe(trainer, make_window_iter=lambda w: (ref.make_window_batch(w, i % 20)
                                                      for i in range(STEPS_PER_WINDOW)),
                 eval_step=lambda st, b: jcell.eval_fn(st, b), steps_per_window=STEPS_PER_WINDOW)
    jstate = jcell.init_state()
    dense0 = jax.tree.map(np.asarray, jstate["dense"])
    _, jres = pipe.run(jstate, n_windows=WINDOWS)

    tcell = t_ow.Cell("cpu", prec=t_layers.FP32)
    tstate = tcell.init_state()
    tstate["dense"].mlp.load_state_dict(convert.params_from_tree(tstate["dense"].mlp, dense0))
    out = t_ow.main(n_windows=WINDOWS, steps_per_window=STEPS_PER_WINDOW, evict_age=EVICT_AGE, log_every=1,
                    cell=tcell, state=tstate, quiet=True)
    assert out["evictions"] == j_evictions
    assert j_evictions[0]["evicted"] == 0 and all(e["evicted"] > 0 for e in j_evictions[1:])
    for jw, tw in zip(jres, out["windows"]):
        np.testing.assert_allclose(tw["pre_eval_loss"], jw.pre_eval["loss"], rtol=0, atol=LOSS_TOL)
        assert len(tw["train_metrics"]) == len(jw.train_metrics) == STEPS_PER_WINDOW
        for tm, jm in zip(tw["train_metrics"], jw.train_metrics):
            assert tm["step"] == jm["step"] and tm["live_rows"] == jm["live_rows"]
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=0, atol=LOSS_TOL)
    assert all(e["live"] <= t_ow.ROWS_PER_SHARD for e in out["evictions"])
    assert out["windows"][-1]["train_metrics"][-1]["loss"] < out["windows"][-1]["pre_eval_loss"]
