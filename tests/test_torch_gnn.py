"""The GNN family (GIN, ``gin-tu``) of the PyTorch port against the JAX
package's on the CPU, one device:

* ``models/gnn``: ``apply``, ``loss_fn`` and the FP32 gradients for the node
  and graph tasks, on one converted param tree and the same numpy graph
  (masked edges, masked nodes, unlabelled nodes), against the reference
  with its Pallas segment sum (interpret mode) and with
  ``jax.ops.segment_sum``;
* the four shape cells (``full_graph_sm`` and ``molecule`` at their
  published sizes, ``minibatch_lg`` and ``ogb_products`` with their widths
  and their scale cut) with the smoke model: ``make_batch`` bit-equal, then
  three train steps from the reference's initial state, FP32 (both
  packages' MIXED set to FP32) and MIXED; ``molecule`` also with
  ``compress_grads``;
* ``io/sampler`` bit-equal; the train driver with ``--arch gin-tu`` against
  the reference's, and its resume.

Tolerances. FP32: the same arithmetic up to summation order, 1e-5 (the
state after one step: params plus Adam's per-element sensitivity,
``_adam_atol``). MIXED: bf16 dense compute, rounded at other places by each
framework; the port also sums the aggregations and the readout pooling in
fp32 where the reference pools in bf16. Logits within 3e-2 (a few bf16 ulps
of |x| < 2), losses within 1e-2 (about one bf16 ulp of a loss near 1.6),
the params' update within MIXED_UPDATE_RTOL as a relative norm, moments
within 5e-2 of their largest magnitude (``_mixed_close``). The FP32 state
after three steps within 1e-4 plus Adam's sensitivity
(``_fp32_atol_later``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCell as JShape
from repro.io import sampler as j_sampler
from repro.launch import gnn_cell as j_gnn_cell
from repro.launch import train as j_train
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import gnn as j_gnn
from repro.models import layers as j_layers
from repro_torch import convert, obs as t_obs
from repro_torch.checkpoint import saver as t_saver
from repro_torch.configs.base import GNN_SHAPES, ShapeCell as TShape
from repro_torch.io import sampler as t_sampler
from repro_torch.launch import gnn_cell as t_gnn_cell
from repro_torch.launch import train as t_train
from repro_torch.launch.cells import build_cell
from repro_torch.launch.common import CellOptions as TOpts
from repro_torch.models import gnn as t_gnn
from repro_torch.models import layers as t_layers

STEPS, LR = 3, 1e-3
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
MIXED_TOL = dict(rtol=3e-2, atol=3e-2)
MIXED_LOSS_ATOL = 1e-2
# MIXED after one and three steps, relative norms against the reference
# (largest measured on the CPU: the update 0.30 at full_graph_sm after one
# step, Adam's first step being the sign of a gradient that bf16 noise
# flips on about 2% of its elements; the residuals 0.54 after one step). A
# skipped update or residual is off by 1, one of the wrong sign by 2.
MIXED_UPDATE_RTOL = 0.5
MIXED_EF_RTOL = 0.8
# the scale of minibatch_lg and ogb_products cut, their widths kept
CUT = {"minibatch_lg": {"batch_nodes": 16}, "ogb_products": {"n_nodes": 4_000, "n_edges": 30_001}}
PRECS = {"fp32": (j_layers.FP32, t_layers.FP32), "mixed": (j_layers.MIXED, t_layers.MIXED)}


def _shape(name: str) -> dict:
    s = next(s for s in GNN_SHAPES if s.name == name)
    return s.kind, {**s.params, **CUT.get(name, {})}


def _np(tree):
    """Numpy copies of a tree's leaves (a port state's tensors change in place)."""
    return jax.tree.map(lambda x: np.array(x.detach().cpu() if torch.is_tensor(x) else x), tree)


# ---------------------------------------------------------------- the model
def _graph(task: str, seed: int = 0):
    """A numpy graph of 40 nodes in 4 graphs (graph task) or one graph
    (node task): 150 edges, the last 10 masked (padding) and pointing
    anywhere; nodes 3 and 17 masked; in the node task every 5th label -1."""
    r = np.random.default_rng(seed)
    n, e, ng = 40, 150, 4
    f = dict(feats=r.normal(size=(n, 12)).astype(np.float32),
             edge_src=r.integers(0, n, e).astype(np.int32), edge_dst=r.integers(0, n, e).astype(np.int32),
             edge_mask=np.arange(e) < e - 10, node_graph=np.repeat(np.arange(ng), n // ng).astype(np.int32),
             node_mask=~np.isin(np.arange(n), [3, 17]))
    if task == "graph":
        f["labels"] = r.integers(0, 3, ng).astype(np.int32)
    else:
        f["labels"] = np.where(np.arange(n) % 5 == 4, -1, r.integers(0, 3, n)).astype(np.int32)
    return f


def _models(task: str):
    jcfg = j_gnn.GINConfig(n_layers=3, d_hidden=16, d_feat=12, n_classes=3, task=task)
    tcfg = t_gnn.GINConfig(**dataclasses.asdict(jcfg))
    params = _np(j_gnn.init(jax.random.PRNGKey(5), jcfg))
    model = t_gnn.init(tcfg, device="cpu")
    model.load_state_dict(convert.gin_from_numpy(params, tcfg))
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("task", ["node", "graph"])
def test_apply_and_loss_agree(task, prec, pallas):
    jcfg, tcfg, params, model = _models(task)
    jp, tp = PRECS[prec]
    f = _graph(task)
    jg = j_gnn.GraphBatch(**{k: jnp.asarray(v) for k, v in f.items()})
    tg = t_gnn.GraphBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
    jl = j_gnn.apply(params, jcfg, jg, None, jp, pallas)
    tl = t_gnn.apply(model, tcfg, tg, tp)
    assert tl.dtype == torch.float32 and tl.shape == ((4, 3) if task == "graph" else (40, 3))
    assert bool(torch.isfinite(tl).all()) and float(tl.abs().max()) > 1e-3
    tol = FP32_TOL if prec == "fp32" else MIXED_TOL
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **tol)
    jv = j_gnn.loss_fn(params, jcfg, jg, jp, None, pallas)
    tv = t_gnn.loss_fn(model, tcfg, tg, tp)
    np.testing.assert_allclose(tv.item(), float(jv), **tol)


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("task", ["node", "graph"])
def test_fp32_gradients_agree(task, pallas):
    """The loss's gradient in every param (under the reference's key path),
    FP32; the graph task's unused ``head`` gets none in the port, zeros in
    the reference."""
    jcfg, tcfg, params, model = _models(task)
    f = _graph(task, seed=1)
    jg = j_gnn.GraphBatch(**{k: jnp.asarray(v) for k, v in f.items()})
    tg = t_gnn.GraphBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
    jgrad = _np(jax.grad(lambda p: j_gnn.loss_fn(p, jcfg, jg, j_layers.FP32, None, pallas))(
        jax.tree.map(jnp.asarray, params)))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(t_gnn.loss_fn(model, tcfg, tg, t_layers.FP32), list(model.parameters()),
                                allow_unused=True)
    want = convert.params_from_tree(model, jgrad)
    for n, g in zip(names, grads):
        if g is None:
            assert task == "graph" and n.startswith("head.") and not want[n].any(), n
            continue
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n, **FP32_TOL)
    assert float(want["layer0.eps"].abs()) > 0 and float(want["encoder.weight"].abs().max()) > 0


def test_masked_edges_drop_out_of_the_sum():
    """An edge whose mask is off contributes nothing and gets no gradient:
    the port drops it by its id alone (it does not multiply the message by
    the mask as the reference does); the same logits either way."""
    _, tcfg, _, model = _models("node")
    f = _graph("node", seed=2)
    g = t_gnn.GraphBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
    live = f["edge_mask"]
    cut = t_gnn.GraphBatch(**{**g._asdict(), "edge_src": g.edge_src[live], "edge_dst": g.edge_dst[live],
                              "edge_mask": g.edge_mask[live]})
    torch.testing.assert_close(t_gnn.apply(model, tcfg, g, t_layers.FP32),
                               t_gnn.apply(model, tcfg, cut, t_layers.FP32), rtol=0, atol=0)
    src, seg = t_gnn.sort_edges(g, 40)
    assert src.dtype == seg.dtype == torch.int32 and bool((seg[:-10] < 40).all()) and bool((seg[-10:] == 40).all())


# ---------------------------------------------------------------- the cells
def _shardings(jcell, mesh):
    """The reference cell's state shardings on its mesh: an initial state
    placed so is traced once, not again after the first step."""
    return jax.tree.map(lambda s: NamedSharding(mesh, s), jcell.state_shardings, is_leaf=lambda x: isinstance(x, P))


def _start(name: str, compress: bool) -> tuple:
    """A shape's JAX cell with its initial state and batches, and the
    port's cell: built once, shared by the FP32 and MIXED runs (each cell
    reads MIXED when its step is traced or called)."""
    kind, params = _shape(name)
    mesh = make_test_mesh()
    jcell = j_gnn_cell.build(j_get_config("gin-tu", smoke=True), JShape(name, kind, params), mesh,
                             JOpts(compress_grads=compress))
    tcell = build_cell("gin-tu", name, TOpts(compress_grads=compress), smoke=True, device="cpu",
                       shape_override=TShape(name, kind, params))
    with mesh:
        j0 = jax.device_put(jcell.init_state(), _shardings(jcell, mesh))
        batches = [jcell.make_batch(s) for s in range(STEPS)]
    return mesh, jcell, j0, batches, tcell


def _run(start: tuple, prec: str) -> dict:
    mesh, jcell, jstate, jbatches, tcell = start
    mp = pytest.MonkeyPatch()
    if prec == "fp32":
        mp.setattr(j_gnn_cell, "MIXED", j_layers.FP32)
        mp.setattr(t_gnn_cell, "MIXED", t_layers.FP32)
    try:
        out = {"tcell": tcell, "batches_equal": [], "jloss": [], "tloss": []}
        with mesh:
            out["j0"] = _np(jstate)
            tstate = tcell.load_state_tree(tcell.init_state(), out["j0"])
            step = jax.jit(lambda st, b: jcell.step_fn(st, b))  # a trace of its own for this precision
            for s in range(STEPS):
                jb, tb = jbatches[s], tcell.make_batch(s)
                out["batches_equal"].append({f: np.array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy())
                                             and np.asarray(getattr(jb, f)).dtype == getattr(tb, f).numpy().dtype
                                             for f in jb._fields})
                jstate, jo = step(jstate, jb)
                tstate, to = tcell.step_fn(tstate, tb)
                out["jloss"].append(float(jo["loss"]))
                out["tloss"].append(float(to["loss"]))
                if s == 0:
                    out["j1"], out["t1"] = _np(jstate), _np(tcell.state_tree(tstate))
            out["j"] = _np(jstate)
        out["t"] = _np(tcell.state_tree(tstate))
        return out
    finally:
        mp.undo()


CASES = [(n, p, False) for n in ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
         for p in ("fp32", "mixed")] + [("molecule", p, True) for p in ("fp32", "mixed")]


@pytest.fixture(scope="module")
def starts() -> dict:
    return {}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}" + ("-compressed" if c[2] else ""))
def cells(request, starts):
    name, prec, compress = request.param
    if (name, compress) not in starts:
        starts[name, compress] = _start(name, compress)
    return request.param, _run(starts[name, compress], prec)


def test_make_batch_bit_equal(cells):
    _, r = cells
    for s, eq in enumerate(r["batches_equal"]):
        assert all(eq.values()), (s, eq)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if torch.is_tensor(tree) else tree)}


def _adam_atol(v: np.ndarray, steps: int) -> np.ndarray:
    """Adam's per-element sensitivity: an update lr * m / sqrt(v) moves by
    up to lr * dg / sqrt(v) a step when the gradient moves by dg, about 1e-6
    of the leaf's largest gradient (summation order; Adam's eps 1e-8 bounds
    it near a zero gradient), at most the 2 lr a step of a flipped sign."""
    vhat = v / (1 - 0.999 ** steps)
    dg = 1e-6 * np.sqrt(vhat.max())
    return np.minimum(steps * LR * dg / (np.sqrt(vhat) + 1e-8), 2 * LR * steps)


def _state_close(got: dict, want: dict, atol_of) -> None:
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    assert int(got["step"]) == int(want["step"])
    for k in want:
        if k != "step":
            excess = np.abs(got[k] - want[k]) - atol_of(k, want)
            assert got[k].shape == want[k].shape and float(excess.max(initial=-1.0)) <= 0, \
                (k, float(excess.max()), int((excess > 0).sum()))


def _fp32_atol(k: str, want: dict, rel: float = 1e-5):
    """``rel`` of the largest magnitude of the leaf's kind (params, m, v),
    plus Adam's sensitivity for a param. A residual gf - q * scale carries
    the rounding of the gradient gf, not of itself: ``rel`` of the leaf's
    gradient, read as max |m| / (1 - b1)."""
    if k.startswith("ef/"):
        return rel * float(np.abs(want["opt/m/" + k[len("ef/"):]]).max()) / 0.1
    part = "dense" if k.startswith("dense/") else "/".join(k.split("/")[:2])
    scale = max(float(np.abs(v).max()) for kk, v in want.items() if kk.startswith(part + "/"))
    atol = rel * max(scale, 1e-30)
    if part == "dense":
        return atol + _adam_atol(want["opt/v/" + k[len("dense/"):]], int(want["step"]))
    return atol


def _fp32_atol_later(k: str, want: dict):
    """After three steps: 1e-4 of each kind's magnitude plus Adam's
    sensitivity over the steps (a ReLU input within rounding of 0 flips with
    the summation order; at ``molecule`` that moves encoder/w by 1.2e-5, of
    a scale of 0.25, where step 1 agrees within 1.5e-8)."""
    return _fp32_atol(k, want, rel=1e-4)


def _update_rel(got: dict, want: dict, init: dict) -> float:
    """|dp_got - dp_want| / |dp_want| over all dense params, dp the move
    from the initial params (float64 norms)."""
    keys = sorted(k for k in want if k.startswith("dense/"))
    dg = np.concatenate([(got[k].astype(np.float64) - init[k]).ravel() for k in keys])
    dw = np.concatenate([(want[k].astype(np.float64) - init[k]).ravel() for k in keys])
    return float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))


def _mixed_close(got: dict, want: dict, init: dict) -> None:
    """MIXED: the params' update from the initial state within
    MIXED_UPDATE_RTOL as a relative norm; the moments within 5e-2 of their
    kind's largest magnitude; the residuals after step 1 within
    MIXED_EF_RTOL as a relative norm, after more steps within twice their
    leaf's largest (bf16 noise in the gradient moves the int8 rounding by a
    grid step on most elements: 1.11 relative after three steps at
    ``molecule``; the FP32 runs hold them within 1e-4)."""
    got, want, init = _flat(got), _flat(want), _flat(init)
    assert set(got) == set(want) and int(got["step"]) == int(want["step"])
    rel = _update_rel(got, want, init)
    assert rel <= MIXED_UPDATE_RTOL, rel
    ef = sorted(k for k in want if k.startswith("ef/"))
    if ef and int(want["step"]) == 1:
        e_got, e_want = (np.concatenate([t[k].ravel() for k in ef]).astype(np.float64) for t in (got, want))
        e_rel = float(np.linalg.norm(e_got - e_want) / np.linalg.norm(e_want))
        assert e_rel <= MIXED_EF_RTOL, e_rel
    for k in want:
        if k.startswith("opt/"):
            part = "/".join(k.split("/")[:2])
            atol = 5e-2 * max(float(np.abs(v).max()) for kk, v in want.items() if kk.startswith(part + "/"))
        elif k.startswith("ef/") and int(want["step"]) > 1:
            atol = 2.1 * float(np.abs(want[k]).max())
        else:
            continue
        excess = np.abs(got[k] - want[k]) - atol
        assert got[k].shape == want[k].shape and float(excess.max(initial=-1.0)) <= 0, (k, float(excess.max()))


def test_losses_agree(cells):
    (_, prec, _), r = cells
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=0, atol=1e-5 if prec == "fp32" else MIXED_LOSS_ATOL)


def test_state_after_one_step_agrees(cells):
    """Params, AdamW moments (and the residuals) after the first step: FP32
    within 1e-5 of each kind's magnitude (params plus Adam's sensitivity),
    MIXED as ``_mixed_close``."""
    (_, prec, compress), r = cells
    assert ("ef" in r["t1"]) == compress
    if prec == "fp32":
        _state_close(r["t1"], r["j1"], _fp32_atol)
    else:
        _mixed_close(r["t1"], r["j1"], r["j0"])


def test_state_after_three_steps_agrees(cells):
    """After three steps: FP32 as ``_fp32_atol_later``, MIXED as
    ``_mixed_close``."""
    (_, prec, _), r = cells
    if prec == "fp32":
        _state_close(r["t"], r["j"], _fp32_atol_later)
    else:
        _mixed_close(r["t"], r["j"], r["j0"])


def test_three_steps_train(cells):
    """The params moved from the initial state; the losses are finite."""
    _, r = cells
    init = _flat(r["j0"])
    got = _flat(r["t"])
    assert all(np.isfinite(r["tloss"]))
    assert max(float(np.abs(got[k] - init[k]).max()) for k in init if k.startswith("dense/")) > 1e-3


def test_a_gnn_cell_over_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cell("gin-tu", "molecule", smoke=True)


# ---------------------------------------------------------------- the sampler
@pytest.mark.parametrize("fanout,n_seeds", [((15, 10), 32), ((3,), 7), ((4, 3, 2), 5)])
def test_sampler_bit_equal(fanout, n_seeds):
    jg, tg = j_sampler.CSRGraph.random(500, 6.0, seed=3), t_sampler.CSRGraph.random(500, 6.0, seed=3)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert (tg.n_nodes, tg.n_edges) == (jg.n_nodes, jg.n_edges)
    js, ts = j_sampler.NeighborSampler(jg, fanout, seed=4), t_sampler.NeighborSampler(tg, fanout, seed=4)
    assert ts.budgets(n_seeds) == js.budgets(n_seeds)
    for _ in range(2):  # the generator's state carries over between calls
        seeds = np.arange(n_seeds) * 7
        a, b = js.sample(seeds), ts.sample(seeds)
        for f in ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert a.n_seeds == b.n_seeds == n_seeds


# ---------------------------------------------------------------- the driver
def _records(path) -> dict:
    return {r["step"]: r["metrics"] for r in t_obs.read_jsonl(path) if r.get("type") == "step" and "metrics" in r}


def test_driver_trains_gin_tu_as_the_reference_and_resumes(tmp_path):
    """``--arch gin-tu`` (the molecule smoke shape): the twin, its GIN
    started from the reference's initial params, gives the reference
    driver's losses within the MIXED tolerance; its checkpoint holds the
    reference's state names; a run of 3 steps resumed to 6 repeats the
    uninterrupted run's losses exactly."""
    flags = ["--arch", "gin-tu", "--batch", "16", "--log-every", "1"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_train, "small_mesh", make_test_mesh)
    try:
        assert j_train.main(flags + ["--steps", "6", "--telemetry", str(tmp_path / "j.jsonl")]) == 0
    finally:
        mp.undo()
    t_init = t_gnn.init

    def init_like_reference(cfg, seed=0, device=None):
        model = t_init(cfg, seed, device)
        jcfg = j_gnn.GINConfig(**dataclasses.asdict(cfg))
        model.load_state_dict(convert.gin_from_numpy(_np(j_gnn.init(jax.random.PRNGKey(seed), jcfg)), cfg))
        return model

    mp.setattr(t_gnn, "init", init_like_reference)
    try:
        assert t_train.main(flags + ["--steps", "6", "--device", "cpu", "--telemetry", str(tmp_path / "t.jsonl"),
                                     "--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "3"]) == 0
        assert t_train.main(flags + ["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "b"),
                                     "--ckpt-every", "3"]) == 0
        assert t_train.main(flags + ["--steps", "6", "--device", "cpu", "--ckpt-dir", str(tmp_path / "b"),
                                     "--ckpt-every", "3", "--resume", "--telemetry", str(tmp_path / "r.jsonl")]) == 0
    finally:
        mp.undo()
    j, t, resumed = _records(tmp_path / "j.jsonl"), _records(tmp_path / "t.jsonl"), _records(tmp_path / "r.jsonl")
    assert sorted(j) == sorted(t) == list(range(1, 7)) and sorted(resumed) == [4, 5, 6]
    for step in j:
        np.testing.assert_allclose(t[step]["loss"], j[step]["loss"], rtol=0, atol=MIXED_LOSS_ATOL, err_msg=str(step))
    assert [resumed[s]["loss"] for s in (4, 5, 6)] == [t[s]["loss"] for s in (4, 5, 6)]
    names = t_saver.leaf_names(tmp_path / "a", 6)
    assert {"state/step", "state/dense/encoder/w", "state/dense/layer1/eps", "state/dense/readout0/b",
            "state/opt/v/layer0/mlp2/w", "state/dense/head/b"} <= names


def test_driver_refuses_delta_checkpoints_for_gin_tu(tmp_path):
    with pytest.raises(ValueError, match="recsys-family"):
        t_train.main(["--arch", "gin-tu", "--device", "cpu", "--steps", "2", "--ckpt-mode", "delta",
                      "--ckpt-dir", str(tmp_path)])
