"""The Wide & Deep, SASRec and MIND smoke cells of the PyTorch port against
the JAX package's on the CPU: serve requests over the same imported rows and
dense params, and three train steps from one converted state on the same
numpy batches, in FP32 (both packages' MIXED set to FP32 for the run) and
in MIXED. Wide & Deep also runs a config with two dim groups (embed_dim 16,
wide_dim 8). Train checkpoints cross between the packages both ways."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import saver as j_saver
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCell as JShape
from repro.launch import recsys_cell as j_recsys
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro_torch.checkpoint import saver as t_saver
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import params_from_tree
from repro_torch.core import idmap as t_idmap
from repro_torch.io.ragged import Ragged
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.models import layers as t_layers

BATCH, STEPS, LR = 32, 3, 1e-3
SEEDS = (0, 1, 2)
# The two-group Wide & Deep: its smoke config has embed_dim = wide_dim = 8,
# one group; at 16 and 8 the deep and wide tables are separate groups.
CONFIGS = {"wide-deep": ("wide-deep", {}), "wide-deep-2g": ("wide-deep", {"embed_dim": 16}),
           "sasrec": ("sasrec", {}), "mind": ("mind", {})}


def _archs(key: str):
    arch_id, change = CONFIGS[key]
    ja, ta = j_get_config(arch_id, smoke=True), t_get_config(arch_id, smoke=True)
    return (dataclasses.replace(ja, model=dataclasses.replace(ja.model, **change)),
            dataclasses.replace(ta, model=dataclasses.replace(ta.model, **change)))


# Adam near its eps: an element's step lr * g / (|g| + eps) moves by up to
# lr * dg / (4 eps) when its gradient g, about eps (1e-8) in size, moves by
# dg. A gradient summed in another order differs by about 1e-7 of its
# largest terms (about 1e-3 here): dg 1e-10, so up to 2.5e-6 a step.
ADAM_EPS_ATOL = STEPS * LR * 1e-10 / (4 * 1e-8)


def _tol(prec: str, kind: str, scale: float) -> float:
    """Absolute tolerance of one compared group of tensors, whose largest
    magnitude is ``scale``. FP32: the same arithmetic up to summation order,
    1e-5 of the group's largest magnitude (params and rows: plus
    ``ADAM_EPS_ATOL``). MIXED (bf16 dense compute, each
    framework rounding at other places; the reasons are those of
    tests/test_torch_train.py): outputs and losses 3e-2 (a few bf16 ulps of
    |x| < 2); params and rows 2 * lr * steps (Adam moves an element whose
    gradient sign bf16 noise flips by up to 2 lr a step); the rows' moments
    5e-2 of their largest magnitude."""
    if prec == "fp32":
        return 1e-5 * max(scale, 1e-30) + (ADAM_EPS_ATOL if kind == "params" else 0.0)
    return {"out": 3e-2 * max(scale, 1.0), "params": 2 * LR * STEPS, "moments": 5e-2 * scale}[kind]


# SASRec's key bias has a zero gradient in exact arithmetic (a query's
# softmax does not change when one constant, q · b_k, is added to all its
# scores), so both packages' gradients are rounding noise, which Adam
# normalises into steps of up to lr: held within 2 * lr * steps, as a MIXED
# param is.
NOISE_PARAMS = {f"block{b}.wk.bias" for b in range(2)}


def _close(prec, kind, got: dict, want: dict, what: str) -> None:
    want = {k: np.asarray(v) for k, v in want.items()}
    scale = max(float(np.abs(v).max()) if v.size else 0.0 for v in want.values())
    for k, w in want.items():
        atol = 2 * LR * STEPS if k in NOISE_PARAMS else _tol(prec, kind, scale)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0, atol=atol, err_msg=f"{what} {k}")


def _t_batch(jbatch) -> dict:
    return {k: Ragged(torch.from_numpy(np.array(v.values)), torch.from_numpy(np.array(v.row_splits)))
            for k, v in jbatch.items()}


def _rows(jcell, seeds, scale: float, moments: bool) -> dict:
    """Engine rows in the reference's export form for every id of the
    batches but every 7th (those are missing: zero rows at serve, inserted
    in training)."""
    r = np.random.default_rng(0)
    out = {}
    for key, g in jcell.engine.groups.items():
        eng = np.concatenate([np.asarray(jcell.engine.engine_ids(jcell.ids_fn(jcell.make_batch(s)))[key])
                              for s in seeds])
        ids = np.unique(eng[eng != -1])
        ids = np.delete(ids, np.arange(0, ids.size, 7))
        n, d = ids.size, g.dim
        slots = ({"m": r.normal(scale=1e-3, size=(n, d)).astype(np.float32),
                  "v": r.random(size=(n, d)).astype(np.float32) * 1e-5} if moments
                 else {k: np.zeros((n, d), np.float32) for k in ("m", "v")})
        out[key] = {"ids": ids, "emb": r.normal(scale=scale, size=(n, d)).astype(np.float32),
                    "slots": slots, "last_use": np.ones(n, np.int32)}
    return out


def _cells(key: str, kind: str):
    ja, ta = _archs(key)
    name = "train_batch" if kind == "train" else "serve_p99"
    jcell = j_recsys.build(ja, JShape(name, kind, {"batch": BATCH}), make_test_mesh(),
                           JOpts(remat=False, zero1=False))
    tcell = t_recsys.build(ta, TShape(name, kind, {"batch": BATCH}), device="cpu")
    return jcell, tcell


def _run(key: str, prec: str) -> dict:
    """Serve three requests and train three steps in both packages."""
    mp = pytest.MonkeyPatch()
    mp.setattr(t_recsys, "SUM_TABLES_OF_A_DIM", False)  # the reference's group sizes (ROADMAP C7)
    if prec == "fp32":
        mp.setattr(j_recsys, "MIXED", j_layers.FP32)
        mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    try:
        out = {}
        jcell, tcell = _cells(key, "serve")
        rows = _rows(jcell, SEEDS, 1.0, moments=False)
        mesh = jcell.mesh
        with mesh:
            jstate = jcell.init_state()
            jstate["sparse"] = jcell.engine.import_rows(rows)
            jstep = jax.jit(jcell.step_fn)
            out["serve_j"] = [jax.tree.map(np.asarray, jstep(jstate, jcell.make_batch(s))) for s in SEEDS]
        tstate = tcell.init_state()
        tstate["sparse"] = tcell.engine.import_rows(rows)
        tstate["dense"].load_state_dict(params_from_tree(tstate["dense"], jax.tree.map(np.asarray, jstate["dense"])))
        out["serve_t"] = [tcell.step_fn(tstate, _t_batch(jcell.make_batch(s))) for s in SEEDS]
        out["serve_rows"], out["serve_jcell"] = rows, jcell

        jcell, tcell = _cells(key, "train")
        rows = _rows(jcell, range(STEPS), 0.1, moments=True)
        with mesh:
            jstate = jcell.init_state()
            jstate["sparse"] = jcell.engine.import_rows(rows)
            tstate = tcell.init_state()
            tstate["sparse"] = tcell.engine.import_rows(rows)
            model = tstate["dense"]
            model.load_state_dict(params_from_tree(model, jax.tree.map(np.asarray, jstate["dense"])))
            for k in ("m", "v"):
                for n, x in params_from_tree(model, jax.tree.map(np.asarray, jstate["opt"][k])).items():
                    tstate["opt"][k][n].copy_(x)
            jstep = jax.jit(jcell.step_fn)
            out["train"] = []
            for s in range(STEPS):
                jb = jcell.make_batch(s)
                jstate, jo = jstep(jstate, jb)
                tstate, to = tcell.step_fn(tstate, _t_batch(jb))
                jnp_state = jax.tree.map(np.asarray, jstate)
                out["train"].append(dict(
                    jo=jax.tree.map(np.asarray, jo), to=to,
                    jmaps={g: jnp_state["sparse"][g]["idmap"] for g in jcell.engine.groups},
                    tmaps={g: tstate["sparse"][g]["idmap"] for g in tcell.engine.groups},
                    jrows=jcell.engine.export_rows(jstate["sparse"]),
                    trows=tcell.engine.export_rows(tstate["sparse"]),
                    jdense=params_from_tree(model, jnp_state["dense"]),
                    tdense={k: v.detach().clone() for k, v in model.state_dict().items()},
                    jopt={k: params_from_tree(model, jnp_state["opt"][k]) for k in ("m", "v")},
                    topt={k: {n: t.clone() for n, t in d.items()} for k, d in tstate["opt"].items()}))
        out.update(jcell=jcell, tcell=tcell, jstate=jstate, tstate=tstate)
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=[(k, p) for k in CONFIGS for p in ("fp32", "mixed")],
                ids=lambda kp: f"{kp[0]}-{kp[1]}")
def runs(request):
    key, prec = request.param
    return key, prec, _run(key, prec)


def test_groups(runs):
    key, _, r = runs
    groups = list(r["tcell"].engine.groups)
    assert groups == list(r["jcell"].engine.groups)
    assert len(groups) == (2 if key == "wide-deep-2g" else 1)


def _history_masks(r, seed: int) -> np.ndarray:
    """SASRec's serve history mask (BATCH, T) of one request: the positions
    whose id has a row (every 7th id has none: a zero row at serve)."""
    jcell, rows = r["serve_jcell"], r["serve_rows"]
    key = next(iter(jcell.engine.groups))
    t = jcell.arch.model.seq_len
    eng = np.asarray(jcell.engine.engine_ids(jcell.ids_fn(jcell.make_batch(seed)))[key])
    return np.isin(eng[:BATCH * t], rows[key]["ids"]).reshape(BATCH, t)  # hist_items come first in the group


def test_serve_metrics_equal_and_outputs_agree(runs):
    """Every output agrees with the reference's, but SASRec's rows whose
    history mask is not a prefix (ROADMAP C6, repaired in the port): there
    the reference reads position count(mask) - 1, and where that position
    is masked its logit is 0; the port reads the last valid position, a
    non-zero logit."""
    key, prec, r = runs
    c6 = 0
    for seed, jo, to in zip(SEEDS, r["serve_j"], r["serve_t"]):
        assert {k: int(v) for k, v in to.items() if k != "logits"} == \
               {k: int(v) for k, v in jo.items() if k != "logits"}
        assert to["logits"].shape == (BATCH,) and to["logits"].dtype == torch.float32
        same = np.ones(BATCH, bool)
        if key == "sasrec":
            mask = _history_masks(r, seed)
            count = mask.sum(1)
            same = np.array([m[:c].all() for m, c in zip(mask, count)])  # prefix masks: one position read
            read_masked = ~mask[np.arange(BATCH), np.maximum(count - 1, 0)]
            assert not np.asarray(jo["logits"])[read_masked].any()  # the reference: a zero user vector
            c6_rows = read_masked & (count > 0)  # an empty history reads a zero vector in both
            # the port reads the last valid position: non-zero logits, but
            # where the target item has no row either
            assert c6_rows.sum() == 0 or to["logits"].numpy()[c6_rows].any()
            c6 += int(c6_rows.sum())
        _close(prec, "out", {"logits": to["logits"].numpy()[same]}, {"logits": np.asarray(jo["logits"])[same]},
               "serve")
    assert key != "sasrec" or c6 > 0
    assert np.unique(np.concatenate([o["logits"].numpy() for o in r["serve_t"]])).size > BATCH


def test_train_integers_bit_equal(runs):
    _, _, r = runs
    inserted = 0
    for st in r["train"]:
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        tm = {k: int(v) for k, v in st["to"].items() if k != "loss"}
        assert tm == jm
        inserted += sum(v for k, v in tm.items() if k.endswith("idmap_inserted"))
        for g, tmap in st["tmaps"].items():
            for f in t_idmap.TENSOR_FIELDS:
                np.testing.assert_array_equal(getattr(tmap, f)[0].numpy(), np.asarray(getattr(st["jmaps"][g], f))[0],
                                              err_msg=f"{g} {f}")
            for k in ("ids", "last_use"):
                np.testing.assert_array_equal(st["trows"][g][k], st["jrows"][g][k], err_msg=f"{g} {k}")
    assert inserted > 0


def test_train_loss_rows_and_params_agree(runs):
    _, prec, r = runs
    for i, st in enumerate(r["train"]):
        _close(prec, "out", {"loss": float(st["to"]["loss"])}, {"loss": float(st["jo"]["loss"])}, f"step {i}")
        for g in st["trows"]:
            tr, jr = st["trows"][g], st["jrows"][g]
            _close(prec, "params", {"emb": tr["emb"]}, {"emb": jr["emb"]}, f"step {i} {g}")
            for k in ("m", "v"):
                _close(prec, "moments", {k: tr["slots"][k]}, {k: jr["slots"][k]}, f"step {i} {g}")
        _close(prec, "params", st["tdense"], st["jdense"], f"step {i}")
        for k in ("m", "v") if prec == "fp32" else ():  # the reasons are in tests/test_torch_train.py
            _close(prec, "moments", st["topt"][k], st["jopt"][k], f"step {i} opt {k}")


def test_train_moves_rows_and_params(runs):
    _, _, r = runs
    first, last = r["train"][0], r["train"][-1]
    for g in first["trows"]:
        n = first["trows"][g]["emb"].shape[0]
        assert not np.array_equal(last["trows"][g]["emb"][:n], first["trows"][g]["emb"])
    assert any(not torch.equal(first["tdense"][n], last["tdense"][n]) for n in first["tdense"])


@pytest.mark.parametrize("key", ["wide-deep-2g", "sasrec"])
def test_train_checkpoint_crosses_packages(key, tmp_path):
    """A train cell's state after three FP32 steps written by the reference
    and restored by the port, and the other way round: every leaf equal
    under the reference's key paths (dense/block0/ln1/scale,
    dense/pos_emb, dense/bias, opt/m/..., sparse/dim8/idmap/2, ...)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_recsys, "MIXED", j_layers.FP32)
    mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    mp.setattr(t_recsys, "SUM_TABLES_OF_A_DIM", False)  # the reference's group sizes (ROADMAP C7)
    try:
        jcell, tcell = _cells(key, "train")
        with jcell.mesh:
            jstate = jcell.init_state()
            jstep = jax.jit(jcell.step_fn)
            for s in range(STEPS):
                jstate, _ = jstep(jstate, jcell.make_batch(s))
        jstate = jax.tree.map(np.asarray, jstate)
        tstate = tcell.init_state()
        for s in range(STEPS):
            tstate, _ = tcell.step_fn(tstate, tcell.make_batch(s))
    finally:
        mp.undo()
    jflat = j_saver._flatten(jstate)
    want = {"wide-deep-2g": ["dense/bias", "dense/deep/l0/w", "opt/m/wide_proj/b", "sparse/dim16/blocks/0",
                             "sparse/dim8/idmap/2"],
            "sasrec": ["dense/block0/ln1/scale", "dense/block0/ln1/bias", "dense/pos_emb",
                       "opt/v/final_ln/bias", "dense/block0/wq/w", "sparse/dim16/blocks/0"]}[key]
    assert set(want) <= set(jflat)

    j_saver.save(jstate, tmp_path / "j", STEPS, n_shards=3)
    fresh = tcell.init_state()
    got = tcell.load_state_tree(fresh, t_saver.restore(tmp_path / "j", tcell.state_tree(fresh)))
    tflat = t_saver._flatten(tcell.state_tree(got))
    assert list(tflat) == list(jflat)
    for k, v in tflat.items():
        np.testing.assert_array_equal(np.asarray(v), jflat[k], err_msg=k)

    tflat = t_saver._flatten(tcell.state_tree(tstate))
    t_saver.save(tcell.state_tree(tstate), tmp_path / "t", STEPS, n_shards=4)
    with jcell.mesh:
        like = jax.tree.map(np.asarray, jcell.init_state())
    back = j_saver._flatten(j_saver.restore(tmp_path / "t", like))
    assert list(back) == list(tflat)
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(tflat[k]), err_msg=k)
    assert float(np.abs(back["dense/bias"] if key == "wide-deep-2g" else back["dense/pos_emb"]).max()) > 0


def test_c7_one_group_of_two_tables_is_sized_for_both():
    """ROADMAP C7, repaired in the port. The Wide & Deep smoke config has
    embed_dim = wide_dim = 8, so its deep and wide tables share one dim
    group. The reference sizes that group for one table (n_sparse *
    vocab_per_feature rows, times 1.5); the port for both, twice the
    reference's rows before rounding. ``SUM_TABLES_OF_A_DIM = False`` gives
    the reference's sizing (the other tests of this file run so)."""
    ja, ta = _archs("wide-deep")
    m = ta.model
    assert m.embed_dim == m.wide_dim == 8
    one_table = m.n_sparse * m.vocab_per_feature

    def rows(n):
        return max(-(-int(n * 1.5) // 128) * 128, 1024)

    shape = ("train_batch", "train", {"batch": BATCH})
    jcell = j_recsys.build(ja, JShape(*shape), make_test_mesh(), JOpts(remat=False, zero1=False))
    tcell = t_recsys.build(ta, TShape(*shape), device="cpu")
    (jg,), (tg,) = jcell.engine.groups.values(), tcell.engine.groups.values()
    assert jg.rows_per_shard == rows(one_table)
    assert tg.rows_per_shard == rows(2 * one_table)
    assert tg.map_capacity_per_shard == 2 * tg.rows_per_shard
    mp = pytest.MonkeyPatch()
    mp.setattr(t_recsys, "SUM_TABLES_OF_A_DIM", False)
    try:
        (ref_sized,) = t_recsys.build(ta, TShape(*shape), device="cpu").engine.groups.values()
    finally:
        mp.undo()
    assert (ref_sized.rows_per_shard, ref_sized.map_capacity_per_shard) == (jg.rows_per_shard,
                                                                          jg.map_capacity_per_shard)
    two_groups = t_recsys._rows_per_dim(_archs("wide-deep-2g")[1])
    assert two_groups == {16: one_table, 8: one_table}  # separate dims: one table a group, as before
