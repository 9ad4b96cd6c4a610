"""The training loop of the port (``repro_torch.obs``, ``io.columnio``,
``io.datagen``, ``checkpoint``, ``pipelines.trainer``) against the JAX
package's on the CPU: the same observation stream gives the same registry
snapshot, the same seed the same table files and (one loader thread) the
same batches and cursors, checkpoints carry the reference's leaf names and
restore across the two packages, and the reference's Trainer on the FP32
MSE cell (``examples/train_mse.py``, loaded by file path with its ``MIXED``
set to FP32, as tests/test_torch_mse.py does) agrees with the port's over
six steps of one table. One module-scoped pair of runs is shared."""
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.checkpoint import saver as j_saver
from repro.io import columnio as j_cio, datagen as j_datagen
from repro.models import layers as j_layers
from repro.pipelines import trainer as j_trainer
from repro_torch import convert, obs as t_obs
from repro_torch.checkpoint import saver as t_saver
from repro_torch.examples import train_mse as t_mse
from repro_torch.io import columnio as t_cio, datagen as t_datagen
from repro_torch.models import layers as t_layers
from repro_torch.pipelines import trainer as t_trainer

STEPS = 6
ROWS, ROWS_PER_GROUP = 1024, 256  # 2 parts of 2 row groups, 2 batches of 128 each


def _load_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_mse.py"
    spec = importlib.util.spec_from_file_location("reference_train_mse_loop", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_mse = _load_example()


def _write_table(datagen, specs, directory):
    gens = datagen.gen_for_specs(specs, seq_mean_len=t_mse.SEQ_MEAN_LEN)
    return datagen.write_table(directory, gens, n_rows=ROWS, rows_per_group=ROWS_PER_GROUP, seed=3)


@functools.cache
def _j_init_dense() -> dict:
    return jax.tree.map(np.asarray, j_mse.MSECell().init_dense)


def _t_cell():
    """The port's FP32 cell with the reference example's dense weights."""
    cell = t_mse.MSECell("cpu", prec=t_layers.FP32)
    state = cell.init_state()
    state["dense"].load_state_dict(convert.params_from_tree(state["dense"], _j_init_dense()))
    return cell, state


def _t_train(table, steps, ckpt_dir=None, resume=False, ckpt_every=0):
    cell, state = _t_cell()
    cfg = t_trainer.TrainConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
                                log_every=1, watchdog=False, anomaly=False)
    trainer = t_trainer.Trainer(cell, cfg, registry=t_obs.MetricsRegistry())
    state, start, cursor = trainer.try_resume(state)
    cursor = cursor or {}
    loader = t_cio.AsyncLoader(table, t_datagen.batch_spec_for(cell.specs, t_mse.BATCH), n_threads=1,
                               loop=True, start_part=cursor.get("part", 0), start_group=cursor.get("group", 0),
                               start_batch=cursor.get("batch", 0), registry=t_obs.MetricsRegistry())
    res = trainer.run(state, iter(loader), start_step=start, cursor_fn=lambda: loader.position)
    loader.stop()
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's Trainer and the port's, six FP32 steps each on the
    same table (one loader thread each, so the batch order is fixed)."""
    root = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    mp.setattr(j_mse, "MIXED", j_layers.FP32)
    try:
        jcell = j_mse.MSECell()
        table = _write_table(j_datagen, jcell.specs, root / "table")
        jloader = j_cio.AsyncLoader(table, j_datagen.batch_spec_for(jcell.specs, j_mse.BATCH), n_threads=1,
                                    loop=True, registry=j_obs.MetricsRegistry())
        jcfg = j_trainer.TrainConfig(total_steps=STEPS, log_every=1, watchdog=False, anomaly=False)
        jres = j_trainer.Trainer(jcell, jcfg, registry=j_obs.MetricsRegistry()).run(
            jcell.init_state(), iter(jloader))
        jloader.stop()
    finally:
        mp.undo()
    tres = _t_train(table, STEPS)
    return {"root": root, "table": table, "jcell": jcell, "jres": jres, "tres": tres}


# ------------------------------------------------------------ observability
def _feed(obs, reg):
    """One observation stream: counters, gauges, histograms (labelled too),
    spans through a Tracer, and the anomaly gate on a fixed span stream."""
    r = np.random.default_rng(0)
    for i in range(700):
        reg.counter("io/rows").inc(float(r.integers(1, 100)))
        reg.histogram("trainer/step_wall_s").observe(float(r.lognormal(-3, 0.5)))
        reg.histogram("io/read_group_s", reader=i % 3).observe(float(r.exponential(1e-3)))
        reg.gauge("io/queue_depth").set(float(i % 7))
    det = obs.AnomalyDetector(reg, window=16, min_samples=4)
    spans = [{"data_wait": 0.01 + 0.001 * (i % 3), "device_step": 0.1 if i != 20 else 0.9} for i in range(30)]
    return [det.observe_step(i + 1, s) for i, s in enumerate(spans)]


def _no_times(snap: dict) -> dict:
    out = {k: v for k, v in snap.items() if k != "t"}
    out["metrics"] = {n: {k: v for k, v in e.items() if k != "t"} for n, e in snap["metrics"].items()}
    return out


def test_registry_snapshots_equal():
    jreg, treg = j_obs.MetricsRegistry(), t_obs.MetricsRegistry()
    assert _feed(t_obs, treg) == _feed(j_obs, jreg)
    js = j_obs.RegistrySnapshot.capture(jreg, worker="w0", epoch=2)
    ts = t_obs.RegistrySnapshot.capture(treg, worker="w0", epoch=2)
    assert _no_times(ts.to_json()) == _no_times(js.to_json())
    assert ts.histogram_summary("trainer/step_wall_s") == js.histogram_summary("trainer/step_wall_s")
    merged_t = t_obs.merge_snapshots([ts, ts]).to_json()
    merged_j = j_obs.merge_snapshots([js, js]).to_json()
    assert _no_times(merged_t) == _no_times(merged_j)
    assert t_obs.RegistrySnapshot.from_json(ts.to_json_str()).to_json() == ts.to_json()
    for name in ("wide-deep", "Qwen2.5/3B", ""):
        assert t_obs.sanitize(name) == j_obs.sanitize(name)
    with pytest.raises(ValueError):
        t_obs.check_name("NoSubsystem")


def test_watchdog_and_tracer_phases(tmp_path):
    """The watchdog flags and attributes the same steps; the Tracer writes
    one JSONL step record per step with its phases, read back by
    ``tail_jsonl``."""
    j_wd, t_wd = j_trainer.StragglerWatchdog(warmup=4), t_trainer.StragglerWatchdog(warmup=4)
    for i in range(20):
        ph = {"data_wait": 0.01, "device_step": 0.05 if i != 12 else 0.5}
        assert t_wd.observe(i, sum(ph.values()), ph) == j_wd.observe(i, sum(ph.values()), ph)
    assert [tuple(e) for e in t_wd.events] == [tuple(e) for e in j_wd.events] and t_wd.events[0].phase == "device_step"
    writer = t_obs.TelemetryWriter(tmp_path / "t.jsonl")
    tracer = t_obs.Tracer(t_obs.MetricsRegistry(), writer, profile=True)
    for s in range(3):
        with tracer.step(s + 1) as st:
            for phase in ("data_wait", "device_step"):
                with tracer.span(phase):
                    pass
            st.annotate(loss=1.0)
    writer.close()
    recs, _ = t_obs.tail_jsonl(tmp_path / "t.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3] and set(recs[0]["spans"]) == {"data_wait", "device_step"}
    assert tracer.registry.histogram("trace/data_wait_s").count == 3


# ---------------------------------------------------------------------- data
def test_tables_byte_equal_and_batches_equal(runs, tmp_path):
    """The same seed writes the same files; one loader thread gives the same
    batches and the same cursor, from the start and from a start cursor."""
    table = _write_table(t_datagen, t_mse.specs(), tmp_path / "table")
    parts = sorted(p.name for p in runs["table"].glob("part-*.col"))
    assert parts == sorted(p.name for p in table.glob("part-*.col")) and len(parts) == 2
    for name in parts:
        assert (table / name).read_bytes() == (runs["table"] / name).read_bytes(), name
    bspec = t_datagen.batch_spec_for(t_mse.specs(), t_mse.BATCH)
    assert dict(bspec.nnz_budget) == dict(j_datagen.batch_spec_for(j_mse.specs(), j_mse.BATCH).nnz_budget)
    for start in ((0, 0), (0, 1), (1, 1)):
        kw = dict(n_threads=1, loop=False, start_part=start[0], start_group=start[1])
        jl = j_cio.AsyncLoader(table, bspec, registry=j_obs.MetricsRegistry(), **kw)
        tl = t_cio.AsyncLoader(table, bspec, registry=t_obs.MetricsRegistry(), **kw)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 2 * (4 - 2 * start[0] - start[1])
        for j, t in zip(jb, tb):
            assert set(t) == set(j)
            for k in j:
                assert t[k].values.dtype == (torch.float32 if np.asarray(j[k].values).dtype == np.float32
                                             else torch.int64)
                np.testing.assert_array_equal(t[k].values.numpy(), np.asarray(j[k].values), err_msg=k)
                np.testing.assert_array_equal(t[k].row_splits.numpy(), np.asarray(j[k].row_splits), err_msg=k)
        assert tl.cursor == jl.cursor == {"part": 1, "group": 2}
        assert tl.overflow == jl.overflow and tl.rows_seen == jl.rows_seen


def test_loader_position_resumes_the_stream(runs):
    """The port's consumer-side position: a loop loader started where
    another stopped (mid row group, and past the last group: the cycle
    wraps) gives the rest of the first one's stream."""
    bspec = t_datagen.batch_spec_for(t_mse.specs(), t_mse.BATCH)

    def take(n, **kw):
        ld = t_cio.AsyncLoader(runs["table"], bspec, n_threads=1, loop=True, registry=t_obs.MetricsRegistry(),
                               **kw)
        it, out, pos = iter(ld), [], []
        for _ in range(n):
            out.append(next(it)["h0"].values.numpy().copy())
            pos.append(dict(ld.position))
        ld.stop()
        return out, pos

    whole, pos = take(12)
    assert pos[2] == {"part": 0, "group": 1, "batch": 1} and pos[7] == {"part": 1, "group": 2, "batch": 0}
    for cut in (3, 8):  # mid group; after the last group
        p = pos[cut - 1]
        rest, _ = take(12 - cut, start_part=p["part"], start_group=p["group"], start_batch=p["batch"])
        for a, b in zip(rest, whole[cut:]):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- checkpoints
def test_state_tree_has_the_reference_names_and_values(runs):
    jflat = j_saver._flatten(runs["jres"].state)
    tflat = t_saver._flatten(convert.train_state_to_tree(runs["tres"].state))
    assert len(jflat) == 53 and list(tflat) == list(jflat)

    def group(k):  # dense params, each AdamW moment, each engine tensor
        return k.split("/")[0] if k.startswith("dense") else ("/".join(k.split("/")[:2]) if k.startswith("opt")
                                                            else k)

    scale = {}
    for k, j in jflat.items():
        scale[group(k)] = max(scale.get(group(k), 0.0), float(np.abs(j).max()) if j.size else 0.0)
    for k, j in jflat.items():
        t = tflat[k]
        assert t.dtype == j.dtype and t.shape == j.shape, k
        if np.issubdtype(j.dtype, np.floating):  # FP32 within 1e-5 of the group's largest magnitude
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * max(scale[group(k)], 1e-30), err_msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)


def test_checkpoints_restore_across_packages(runs, tmp_path):
    """Written by the reference, restored by the port (the saver and the
    Trainer's ``try_resume``), and the other way round: every leaf equal."""
    jstate = runs["jres"].state
    jflat = j_saver._flatten(jstate)
    j_saver.save({"state": jstate, "cursor": {"part": 1, "group": 1}, "saved_step": np.int64(STEPS)},
                 tmp_path / "j", STEPS, n_shards=3)
    cell, fresh = _t_cell()
    like = {"state": convert.train_state_to_tree(fresh), "cursor": {"part": 0, "group": 0}, "saved_step": np.int64(0)}
    got = convert.train_state_from_tree(fresh, t_saver.restore(tmp_path / "j", like)["state"])
    for k, v in t_saver._flatten(convert.train_state_to_tree(got)).items():
        np.testing.assert_array_equal(v, jflat[k], err_msg=k)
    cell, fresh = _t_cell()
    tr = t_trainer.Trainer(cell, t_trainer.TrainConfig(ckpt_dir=str(tmp_path / "j")), registry=t_obs.MetricsRegistry())
    state, step, cursor = tr.try_resume(fresh)
    assert (step, cursor) == (STEPS, {"part": 1, "group": 1})
    assert torch.equal(state["sparse"]["dim8"]["blocks"].emb, torch.tensor(jflat["sparse/dim8/blocks/0"]))

    tstate = runs["tres"].state
    tflat = t_saver._flatten(convert.train_state_to_tree(tstate))
    t_saver.save({"state": convert.train_state_to_tree(tstate), "cursor": {"part": 0, "group": 1, "batch": 1},
                  "saved_step": np.int64(STEPS)}, tmp_path / "t", STEPS, n_shards=4)
    like = {"state": j_mse.MSECell().init_state(), "cursor": {"part": 0, "group": 0}, "saved_step": np.int64(0)}
    back = j_saver.restore(tmp_path / "t", like)
    for k, v in j_saver._flatten(back["state"]).items():
        np.testing.assert_array_equal(v, tflat[k], err_msg=k)
    assert int(back["saved_step"]) == STEPS and int(back["cursor"]["group"]) == 1


# ------------------------------------------------------------------ training
def test_trainer_losses_agree_with_the_reference(runs):
    jh, th = runs["jres"].metrics_history, runs["tres"].metrics_history
    assert [m["step"] for m in th] == [m["step"] for m in jh] == list(range(1, STEPS + 1))
    for j, t in zip(jh, th):
        assert abs(t["loss"] - j["loss"]) <= 1e-5, (t["step"], t["loss"], j["loss"])
        assert {k: v for k, v in t.items() if "overflow" in k} == {k: v for k, v in j.items() if "overflow" in k}
    assert th[0]["loss"] != th[-1]["loss"]


def test_resumed_run_equals_the_uninterrupted_run(runs, tmp_path):
    """Three steps, a checkpoint, then a new Trainer and loader resumed from
    it: steps 4-6 and the final state bit-equal to six steps in one go."""
    ckpt = str(tmp_path / "ckpt")
    first = _t_train(runs["table"], 3, ckpt_dir=ckpt, ckpt_every=3)
    assert t_saver.latest_step(ckpt) == 3
    second = _t_train(runs["table"], STEPS, ckpt_dir=ckpt, resume=True, ckpt_every=3)
    assert second.resumed_from == 3 and second.steps_run == 3
    whole = runs["tres"].metrics_history
    got = first.metrics_history + second.metrics_history
    assert [(m["step"], m["loss"]) for m in got] == [(m["step"], m["loss"]) for m in whole]
    a = t_saver._flatten(convert.train_state_to_tree(second.state))
    b = t_saver._flatten(convert.train_state_to_tree(runs["tres"].state))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_delta_checkpoints_wait_for_the_ft_port(tmp_path):
    """Delta mode is ported: as in the reference, it needs a checkpoint
    directory and hooks that carry the engine (the dirty rows' source)."""
    cell = t_mse.MSECell("cpu")
    for ckpt_dir in (None, str(tmp_path)):
        with pytest.raises(ValueError, match="needs ckpt_dir and engine-bearing hooks"):
            t_trainer.Trainer(cell, t_trainer.TrainConfig(ckpt_dir=ckpt_dir, ft_mode="delta"),
                              registry=t_obs.MetricsRegistry())
    with pytest.raises(ValueError, match="unknown ft_mode"):
        t_trainer.Trainer(cell, t_trainer.TrainConfig(ft_mode="deltas"), registry=t_obs.MetricsRegistry())


def test_main_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mse.main(["--steps", "1", "--workdir", str(tmp_path)])
