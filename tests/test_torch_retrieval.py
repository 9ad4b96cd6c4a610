"""The retrieval cell (``retrieval_cand``) of the PyTorch port against the
JAX package's on the CPU, for the four recsys archs at smoke size (64
candidates): the same rows imported into both engines, the same dense
params and batches; and the twin of ``examples/serve_retrieval.py``."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShape
from repro.core.feature_engine import FeatureEngine as JFeatureEngine
from repro.launch import recsys_cell as j_recsys
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro_torch.checkpoint import saver as t_saver
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import params_from_tree
from repro_torch.io.ragged import Ragged
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.models import layers as t_layers

NC, SEEDS = 64, (0, 1)
ARCHS = ("dlrm-mlperf", "wide-deep", "sasrec", "mind")
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
MIXED_TOL = dict(rtol=3e-2, atol=3e-2)  # bf16 scores: a few ulps of |x| < 2 (tests/test_torch_recsys_models.py)


def _t_batch(jbatch) -> dict:
    return {part: {k: Ragged(torch.from_numpy(np.array(v.values)), torch.from_numpy(np.array(v.row_splits)))
                   for k, v in cols.items()} for part, cols in jbatch.items()}


def _engine_ids(jcell, batch) -> dict:
    """{part: {group: engine ids}} of one request, through the reference's
    Feature Engine and engines."""
    out = {}
    for engine, part in ((jcell.engine_user, "user"), (jcell.engine_cand, "cand")):
        specs = [sp for g in engine.groups.values() for sp in g.features]
        prepared, _ = JFeatureEngine(specs).apply({sp.name: batch[part][sp.name] for sp in specs})
        out[part] = {k: np.asarray(v) for k, v in engine.engine_ids(prepared).items()}
    return out


def _rows(jcell) -> dict:
    """Rows for every id of the requests (user and candidates) but every
    7th, which reads as a zero row."""
    r = np.random.default_rng(0)
    eng_ids = {}
    for s in SEEDS:
        for part in _engine_ids(jcell, jcell.make_batch(s)).values():
            for key, v in part.items():
                eng_ids.setdefault(key, []).append(v)
    out = {}
    for key, parts in eng_ids.items():
        ids = np.unique(np.concatenate(parts))
        ids = ids[ids != -1]
        ids = np.delete(ids, np.arange(0, ids.size, 7))
        n, d = ids.size, int(key[3:])
        out[key] = {"ids": ids, "emb": r.normal(scale=0.5, size=(n, d)).astype(np.float32),
                    "slots": {k: np.zeros((n, d), np.float32) for k in ("m", "v")},
                    "last_use": np.ones(n, np.int32)}
    return out


def _history_mask(r, seed: int) -> np.ndarray:
    """SASRec's history mask (T,) of one request: the positions whose id
    has a row (every 7th id has none: a zero row at serve)."""
    hist = r["jcell"].engine_user.groups
    ids = _engine_ids(r["jcell"], r["jcell"].make_batch(seed))["user"]
    key = next(iter(hist))
    t = r["tcell"].arch.model.seq_len
    return np.isin(ids[key][:t], r["rows"][key]["ids"])  # hist_items come first in the group


def _run(arch: str, prec: str) -> dict:
    mp = pytest.MonkeyPatch()
    mp.setattr(t_recsys, "SUM_TABLES_OF_A_DIM", False)  # the reference's group sizes (ROADMAP C7)
    if prec == "fp32":  # the reference's score_candidates takes the precision as a default argument
        mod = j_recsys._model_mod(arch)
        fp32 = types.SimpleNamespace(**{k: getattr(mod, k) for k in ("feature_specs", "init", "pspec")},
                                     score_candidates=functools.partial(mod.score_candidates,
                                                                        prec=j_layers.FP32))
        mp.setattr(j_recsys, "_model_mod", lambda a: fp32)
        mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    try:
        mesh = make_test_mesh()
        jcell = j_build_cell(arch, "retrieval_cand", mesh, JOpts(remat=False, zero1=False), smoke=True,
                             shape_override=JShape("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": NC}))
        tcell = t_build_cell(arch, "retrieval_cand", smoke=True, device="cpu",
                             shape_override=TShape("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": NC}))
        rows = _rows(jcell)
        with mesh:
            jstate = jcell.init_state()
            jstate["sparse_user"] = jcell.engine_user.import_rows(rows)
            jstate["sparse_cand"] = jcell.engine_cand.import_rows(rows)
            jstep = jax.jit(jcell.step_fn)
            jout = [jax.tree.map(np.asarray, jstep(jstate, jcell.make_batch(s))) for s in SEEDS]
        tstate = tcell.init_state()
        tstate["sparse_user"] = tcell.engine_user.import_rows(rows)
        tstate["sparse_cand"] = tcell.engine_cand.import_rows(rows)
        model = tstate["dense"]
        model.load_state_dict(params_from_tree(model, jax.tree.map(np.asarray, jstate["dense"])))
        tout = [tcell.step_fn(tstate, _t_batch(jcell.make_batch(s))) for s in SEEDS]
        return dict(jcell=jcell, tcell=tcell, jout=jout, tout=tout, rows=rows)
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=[(a, p) for a in ARCHS for p in ("fp32", "mixed")],
                ids=lambda ap: f"{ap[0]}-{ap[1]}")
def runs(request):
    arch, prec = request.param
    return arch, prec, _run(arch, prec)


def test_engines_and_batches_match_the_reference(runs):
    arch, _, r = runs
    jcell, tcell = r["jcell"], r["tcell"]
    for je, te in ((jcell.engine_user, tcell.engine_user), (jcell.engine_cand, tcell.engine_cand)):
        assert list(te.groups) == list(je.groups)
        assert te.salts == je.salts
        for k, g in te.groups.items():
            assert (g.rows_per_shard, g.map_capacity_per_shard) == (je.groups[k].rows_per_shard,
                                                                     je.groups[k].map_capacity_per_shard)
    assert len(tcell.engine_cand.groups) == (2 if arch == "wide-deep" and tcell.arch.model.embed_dim
                                             != tcell.arch.model.wide_dim else 1)
    jb, tb = jcell.make_batch(3), tcell.make_batch(3)
    for part in ("user", "cand"):
        assert set(tb[part]) == set(jb[part])
        for k in jb[part]:
            np.testing.assert_array_equal(tb[part][k].values.numpy(), np.asarray(jb[part][k].values))


def test_metrics_equal(runs):
    _, _, r = runs
    for jo, to in zip(r["jout"], r["tout"]):
        tm = {k: int(v) for k, v in to.items() if k != "scores"}
        assert tm == {k: int(v) for k, v in jo.items() if k != "scores"}
        assert all(v > 0 for k, v in tm.items() if k.endswith("dev_rows_live"))


def test_scores_agree(runs):
    arch, prec, r = runs
    c6 = 0
    for seed, jo, to in zip(SEEDS, r["jout"], r["tout"]):
        s = to["scores"]
        assert s.shape == (NC,) and s.dtype == torch.float32 and bool(torch.isfinite(s).all())
        mask = _history_mask(r, seed) if arch == "sasrec" else None
        if mask is not None and not mask[:mask.sum()].all():
            # ROADMAP C6, repaired in the port: the reference reads position
            # count(mask) - 1, a zero user vector where that one is masked;
            # the port reads the last valid position
            assert mask[mask.sum() - 1] or not np.asarray(jo["scores"]).any()
            c6 += 1
        else:
            np.testing.assert_allclose(s.numpy(), np.asarray(jo["scores"]),
                                       **(FP32_TOL if prec == "fp32" else MIXED_TOL))
        assert np.unique(s.numpy()).size > NC // 4
    assert c6 < len(SEEDS)


def test_serve_retrieval_twin_runs_on_the_cpu(tmp_path):
    """The twin's main(): 20 train steps, a checkpoint under the reference's
    leaf names, the dense params and trained rows in a retrieval cell, 12
    requests of 4,096 candidates with finite, distinct scores; no id of the
    train steps found no row."""
    from repro_torch.examples import serve_retrieval

    out = serve_retrieval.main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert out["scores"].shape == (4096,) and np.isfinite(out["scores"]).all()
    assert np.unique(out["scores"]).size > 100
    assert len(out["latency_ms"]) == serve_retrieval.N_REQUESTS - serve_retrieval.N_WARMUP
    assert np.isfinite(out["train_loss"]) and out["train_overflow"] == 0
    names = t_saver.leaf_names(tmp_path, serve_retrieval.TRAIN_STEPS)
    assert {"dense/bias", "dense/deep/l0/w", "dense/wide_proj/b", "opt/m/deep_out/w",
            "sparse/dim8/blocks/0", "step"} <= names
