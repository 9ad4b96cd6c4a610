"""The port's recsys cells over two gloo ranks against the JAX cells on a
two-device mesh, on the CPU, and the train driver under torchrun.

Both sides take the same global batches (numpy, made from a seed; each
device's CSR local, as the reference lays them out) and the JAX cell's
initial dense state. Three FP32 train steps of the dlrm-mlperf smoke cell,
and of SASRec with histories whose valid positions differ in count between
the ranks (its loss divides by the count over the whole batch): the loss
within 1e-5, every shard's IDMap and the summed counters bit-equal, rows
and dense params within the tolerances of tests/test_torch_recsys_cells.py.
Wide & Deep with two dim groups serves two requests over imported rows.
The driver (``python -m torch.distributed.run --nproc-per-node 2``) gives
the losses of the port's 2-rank cell and resumes from a 2-rank checkpoint;
a 2-rank checkpoint resumes on one device, and a one-device checkpoint
over 2 ranks.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import torch_rank_work as work
from repro_torch.checkpoint import sharded
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.core import idmap as t_idmap
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.obs import read_jsonl
from torch_ranks import SRC, finish, run_ranks, start_jax

D, B, STEPS, LR = 2, work.CELL_BATCH, work.CELL_STEPS, 1e-3
# Adam near its eps (the reasons are in tests/test_torch_recsys_cells.py)
ADAM_EPS_ATOL = STEPS * LR * 1e-10 / (4 * 1e-8)
# one device against 2 ranks: the same global loss, summed in another order
LOSS_ATOL = 1e-5

JAX_BODY = """
import dataclasses
import pathlib
import repro.launch.recsys_cell as j_recsys
from repro.checkpoint import saver
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.io.ragged import Ragged
from repro.launch.common import CellOptions
from repro.models import layers

j_recsys.MIXED = layers.FP32
bat = dict(np.load(D_DIR + "/batches.npz"))
out_dir = pathlib.Path(D_DIR)
mesh = mesh_of(2)
out = {}

def batch_of(key, s):
    names = sorted({k.split("/")[2] for k in bat if k.startswith(f"{key}/{s}/")})
    return {c: Ragged(jnp.asarray(bat[f"{key}/{s}/{c}/values"]), jnp.asarray(bat[f"{key}/{s}/{c}/splits"]))
            for c in names}

for key, arch_id in TRAIN_CASES.items():
    cell = j_recsys.build(get_config(arch_id, smoke=True), ShapeCell("train_batch", "train", {"batch": B}),
                          mesh, CellOptions(remat=False, zero1=False))
    with mesh:
        st = cell.init_state()
        saver.save({k: v for k, v in st.items() if k != "sparse"}, out_dir / f"{key}_init", step=0, n_shards=1)
        step = jax.jit(cell.step_fn)
        for s in range(STEPS):
            st, o = step(st, batch_of(key, s))
            npst = jax.tree.map(np.asarray, st)
            for k, v in o.items():
                out[f"{key}/{s}/out/{k}"] = np.asarray(v)
            for g in cell.engine.groups:
                for f in FIELDS:
                    out[f"{key}/{s}/idmap/{g}/{f}"] = np.asarray(getattr(npst["sparse"][g]["idmap"], f))
            for g, r in cell.engine.export_rows(npst["sparse"]).items():
                for k in ("ids", "emb", "last_use"):
                    out[f"{key}/{s}/rows/{g}/{k}"] = r[k]
                for k, v in r["slots"].items():
                    out[f"{key}/{s}/rows/{g}/{k}"] = v
            for k, v in saver._flatten({k: v for k, v in npst.items() if k != "sparse"}).items():
                out[f"{key}/{s}/tree/{k}"] = v

arch = get_config("wide-deep", smoke=True)
arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, **WD_CHANGE))
cell = j_recsys.build(arch, ShapeCell("serve_p99", "serve", {"batch": B}), mesh,
                      CellOptions(remat=False, zero1=False))
flat = dict(np.load(D_DIR + "/wd_rows.npz"))
rows = {}
for k, v in flat.items():
    _, g, *rest = k.split("/")
    r = rows.setdefault(g, {"slots": {}})
    if rest[0] == "slots":
        r["slots"][rest[1]] = v
    else:
        r[rest[0]] = v
with mesh:
    st = cell.init_state()
    st["sparse"] = cell.engine.import_rows(rows)
    saver.save({"dense": st["dense"]}, out_dir / "wd_init", step=0, n_shards=1)
    fn = jax.jit(cell.step_fn)
    for s in range(2):
        for k, v in fn(st, batch_of("wd", s)).items():
            out[f"wd/{s}/{k}"] = np.asarray(v)
np.savez(out_dir / "jax.npz", **out)
"""


def _global_layout(batch: dict, b_loc: int) -> dict:
    """A one-device batch of D * b_loc rows in the reference's D-device
    layout: the same values, each device's row splits local."""
    out = {}
    for name, r in batch.items():
        splits = r.row_splits.numpy()
        vals = r.values.numpy()
        per = [splits[d * b_loc:(d + 1) * b_loc + 1] - splits[d * b_loc] for d in range(D)]
        out[name] = (vals, np.concatenate(per).astype(np.int32))
    return out


def _short_histories(batch: dict, rng, b_loc: int, t: int) -> None:
    """SASRec's histories cut per row: device 0 keeps most of each, device
    1 little, so the count of valid positions differs between the ranks."""
    vals, _ = batch["hist_items"]
    n = b_loc * t
    new_vals, new_splits = np.zeros_like(vals), []
    for d in range(D):
        lens = rng.integers(t // 2, t + 1, b_loc) if d == 0 else rng.integers(1, t // 2 + 1, b_loc)
        rows = [vals[(d * b_loc + i) * t:(d * b_loc + i) * t + lens[i]] for i in range(b_loc)]
        flat = np.concatenate(rows)
        new_vals[d * n:d * n + flat.size] = flat
        new_splits.append(np.concatenate([[0], np.cumsum(lens)]))
    batch["hist_items"] = (new_vals, np.concatenate(new_splits).astype(np.int32))


def make_batches(d) -> dict:
    """Every step's global batch (the port's one-device stream, which is the
    reference's), and the Wide & Deep rows for every id its requests touch
    but every 7th (those read zero rows)."""
    rng = np.random.default_rng(0)
    out = {}

    def put(key, s, batch):
        for name, (v, sp) in batch.items():
            out[f"{key}/{s}/{name}/values"], out[f"{key}/{s}/{name}/splits"] = v, sp

    for key, arch_id in work.TRAIN_CASES.items():
        arch = t_get_config(arch_id, smoke=True)
        cell = t_recsys.build(arch, TShape("train_batch", "train", {"batch": B}), device="cpu")
        for s in range(STEPS):
            batch = _global_layout(cell.make_batch(s), B // D)
            if key == "sasrec":
                _short_histories(batch, rng, B // D, arch.model.seq_len)
            put(key, s, batch)
    cell = t_recsys.build(work.wide_deep_arch(), TShape("serve_p99", "serve", {"batch": B}), device="cpu")
    rows = {}
    for s in range(2):
        batch = cell.make_batch(s + 10)
        put("wd", s, _global_layout(batch, B // D))
        for g, ids in cell.engine.engine_ids(cell.ids_fn(batch)).items():
            rows.setdefault(g, []).append(ids.numpy())
    flat = {}
    for g, parts in rows.items():
        ids = np.unique(np.concatenate(parts))
        ids = np.delete(ids[ids != -1], np.arange(0, ids.size, 7))
        dim = cell.engine.groups[g].dim
        flat.update({f"rows/{g}/ids": ids, f"rows/{g}/emb": rng.normal(size=(ids.size, dim)).astype(np.float32),
                     f"rows/{g}/slots/m": np.zeros((ids.size, dim), np.float32),
                     f"rows/{g}/slots/v": np.zeros((ids.size, dim), np.float32),
                     f"rows/{g}/last_use": np.ones(ids.size, np.int32)})
    np.savez(d / "wd_rows.npz", **flat)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_cells")
    bat = make_batches(d)
    np.savez(d / "batches.npz", **bat)
    body = (f"D_DIR = {str(d)!r}\nB = {B}\nSTEPS = {STEPS}\nTRAIN_CASES = {work.TRAIN_CASES!r}\n"
            f"WD_CHANGE = {work.WD_CHANGE!r}\nFIELDS = {tuple(t_idmap.TENSOR_FIELDS)!r}\n") + JAX_BODY
    finish(start_jax(body, n_dev=D))  # the ranks start from its saved initial states
    ranks = run_ranks("torch_rank_work:cells_ranks", D, str(d / "store"), str(d))
    return {"ranks": ranks, "ref": dict(np.load(d / "jax.npz")), "bat": bat, "dir": d}


def _ref_prefix(runs, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs["ref"].items() if k.startswith(prefix)}


@pytest.mark.parametrize("key", list(work.TRAIN_CASES))
def test_train_loss_agrees_in_fp32(runs, key):
    for s in range(STEPS):
        want = float(runs["ref"][f"{key}/{s}/out/loss"])
        for r in range(D):
            assert abs(runs["ranks"][r][key][s]["out"]["loss"] - want) <= 1e-5, (s, r)


@pytest.mark.parametrize("key", list(work.TRAIN_CASES))
def test_train_idmaps_and_counters_bit_equal(runs, key):
    inserted = 0
    for s in range(STEPS):
        want = {k: int(v) for k, v in _ref_prefix(runs, f"{key}/{s}/out/").items() if k != "loss"}
        for r in range(D):
            st = runs["ranks"][r][key][s]
            assert {k: v for k, v in st["out"].items() if k != "loss"} == want
            for g, fields in st["idmap"].items():
                for f, v in fields.items():
                    np.testing.assert_array_equal(v, runs["ref"][f"{key}/{s}/idmap/{g}/{f}"][r],
                                                  err_msg=f"step {s} rank {r} {g} {f}")
        inserted += sum(v for k, v in want.items() if k.endswith("idmap_inserted"))
        assert not any(v for k, v in want.items() if "overflow" in k)
    assert inserted > 0


def _close(got: np.ndarray, want: np.ndarray, atol_extra: float, what: str) -> None:
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(scale, 1e-30) + atol_extra, err_msg=what)


@pytest.mark.parametrize("key", list(work.TRAIN_CASES))
def test_train_rows_and_dense_agree(runs, key):
    for s in range(STEPS):
        for g in runs["ranks"][0][key][s]["rows"]:
            parts = [runs["ranks"][r][key][s]["rows"][g] for r in range(D)]
            ids = np.concatenate([p["ids"] for p in parts])
            order, want_order = np.argsort(ids), np.argsort(runs["ref"][f"{key}/{s}/rows/{g}/ids"])
            np.testing.assert_array_equal(ids[order], runs["ref"][f"{key}/{s}/rows/{g}/ids"][want_order])
            for k, extra in (("emb", ADAM_EPS_ATOL), ("m", 0.0), ("v", 0.0), ("last_use", 0.0)):
                got = np.concatenate([p[k] if k in p else p["slots"][k] for p in parts])[order]
                _close(got, runs["ref"][f"{key}/{s}/rows/{g}/{k}"][want_order], extra, f"step {s} {g} {k}")
        want = _ref_prefix(runs, f"{key}/{s}/tree/")
        for r in range(D):
            tree = runs["ranks"][r][key][s]["tree"]
            assert sorted(tree) == sorted(want)
            for k, w in want.items():
                noise = key == "sasrec" and "/wk/b" in k  # zero in exact arithmetic: rounding noise
                extra = 2 * LR * STEPS if noise else (ADAM_EPS_ATOL if k.startswith("dense/") else 0.0)
                _close(np.asarray(tree[k]), w, extra, f"step {s} rank {r} {k}")


def test_sasrec_ranks_count_different_valid_positions(runs):
    splits = runs["bat"]["sasrec/0/hist_items/splits"].reshape(D, -1)
    counts = splits[:, -1]
    assert counts[0] > counts[1] > 0


def test_wide_deep_two_groups_serve_agrees(runs):
    for s in range(2):
        want = _ref_prefix(runs, f"wd/{s}/")
        for r in range(D):
            got = runs["ranks"][r]["wd"][s]
            assert {k: int(v) for k, v in got.items() if k != "logits"} == \
                {k: int(v) for k, v in want.items() if k != "logits"}
            assert got["logits"].shape == (B // D,)
            _close(got["logits"], want["logits"][r * (B // D):(r + 1) * (B // D)], 0.0, f"request {s} rank {r}")
    assert len([k for k in want if k.endswith("exch_send_overflow")]) == 2


def test_each_rank_holds_only_its_own_shard(runs):
    for r in range(D):
        assert runs["ranks"][r]["shard_spec"] == ((r,), 1)


def test_multi_rank_refusals(runs):
    for r in range(D):
        assert runs["ranks"][r]["refused"] == {"retrieval": True, "tiered": True, "lm": True}


def _driver(tmp_path, tag: str, *flags: str, ranks: int = D) -> dict:
    """The driver's per-step losses: under torchrun over ``ranks`` gloo
    ranks, or as one process on one device."""
    tel = tmp_path / f"{tag}.jsonl"
    launch = (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks)]
              if ranks > 1 else [])
    cmd = [sys.executable, *launch, "-m", "repro_torch.launch.train", "--arch", "dlrm-mlperf",
           "--dist-backend", "gloo", "--device", "cpu", "--batch", str(B), "--log-every", "1",
           "--telemetry", str(tel), *flags]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    return {r["step"]: r["metrics"]["loss"] for r in read_jsonl(tel)
            if r.get("type") == "step" and "metrics" in r}


@pytest.fixture(scope="module")
def two_rank_ckpt(tmp_path_factory):
    """Two driver steps over 2 ranks with a checkpoint after each: the
    checkpoints' directory and the losses."""
    d = tmp_path_factory.mktemp("driver")
    losses = _driver(d, "a", "--steps", "2", "--ckpt-dir", str(d / "ckpt"), "--ckpt-every", "1")
    return d / "ckpt", losses


def test_driver_gives_the_two_rank_cells_losses_and_resumes(runs, two_rank_ckpt, tmp_path):
    want = runs["ranks"][0]["driver_losses"]
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(two_rank_ckpt[0], ckpt)
    first = two_rank_ckpt[1]
    resumed = _driver(tmp_path, "b", "--steps", str(STEPS), "--ckpt-dir", ckpt, "--resume")
    assert sorted(first) == [1, 2] and sorted(resumed) == [3]
    got = [first[1], first[2], resumed[3]]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (tmp_path / "ckpt" / "step_0000000002" / "extra.safetensors").exists()


def test_driver_resumes_a_two_rank_checkpoint_on_one_device(runs, two_rank_ckpt, tmp_path):
    want = runs["ranks"][0]["driver_losses"]
    ckpt = tmp_path / "ckpt"
    shutil.copytree(two_rank_ckpt[0], ckpt)
    assert sharded.layout(ckpt) == "rows"
    resumed = _driver(tmp_path, "c", "--steps", str(STEPS), "--ckpt-dir", str(ckpt), "--resume", ranks=1)
    assert sorted(resumed) == [3]
    np.testing.assert_allclose(resumed[3], want[2], rtol=0, atol=LOSS_ATOL)
    assert sharded.layout(ckpt) == "rows"  # the run goes on in the layout it resumed
    assert (ckpt / "step_0000000003" / "extra.safetensors").exists()


def test_driver_resumes_a_one_device_checkpoint_over_two_ranks(runs, tmp_path):
    want = runs["ranks"][0]["driver_losses"]
    ckpt = tmp_path / "ckpt"
    first = _driver(tmp_path, "d", "--steps", "2", "--ckpt-dir", str(ckpt), "--ckpt-every", "1", ranks=1)
    assert sharded.layout(ckpt) == "tree"
    resumed = _driver(tmp_path, "e", "--steps", str(STEPS), "--ckpt-dir", str(ckpt), "--resume")
    assert sorted(first) == [1, 2] and sorted(resumed) == [3]
    np.testing.assert_allclose([first[1], first[2], resumed[3]], want, rtol=0, atol=LOSS_ATOL)
    assert sharded.layout(ckpt) == "rows"


def test_driver_refuses_what_it_does_not_run_over_ranks():
    from repro_torch.launch import train

    args = train.build_parser().parse_args(["--arch", "dlrm-mlperf", "--data-dir", "x"])
    with pytest.raises(ValueError, match="--data-dir"):
        train._refuse_multi_rank(args, t_get_config("dlrm-mlperf", smoke=True))
    args = train.build_parser().parse_args(["--arch", "qwen2.5-3b", "--dist-backend", "gloo"])
    with pytest.raises(ValueError, match="lm family"):
        train._refuse_multi_rank(args, t_get_config("qwen2.5-3b", smoke=True))
    args = train.build_parser().parse_args(["--arch", "dlrm-mlperf"])
    with pytest.raises(ValueError, match="--dist-backend"):
        train._refuse_multi_rank(args, t_get_config("dlrm-mlperf", smoke=True))
