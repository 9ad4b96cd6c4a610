"""The port's GIN cells over gloo ranks against the JAX cells on a mesh of
as many forced host devices, on the CPU, in FP32 (both packages' MIXED set
to FP32): the edge-parallel full graph (ogb_products' widths, its scale
cut, E padded to D) at D 2 and D 3, the minibatch cell at D 2, and the
molecule cell with ``compress_grads`` at D 2 (each rank's own int8
error-feedback residual). Both sides start from the reference's initial
params and take the reference's batches (each rank its slice of the global
batch: its edges in the full graph, its subgraphs in the others).

Held: each rank's slice bit-equal to the reference's global batch; the
losses of three steps within 1e-5 on every rank; the state after the first
step (params, AdamW moments, the residuals stacked [D, ...] in rank order)
within the FP32 tolerances of tests/test_torch_gnn.py, and after the third
within its later FP32 ones (1e-4 plus Adam's sensitivity: a ReLU input
within rounding of 0 flips with the summation order, and Adam grows that);
the params bit-equal across the ranks after every step.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import test_torch_gnn as single
from repro.configs import get_config as j_get_config
from repro.models import gnn as j_gnn
import torch_rank_work as work
from torch_ranks import finish, run_ranks, start_jax

JAX_BODY = """
import pathlib
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch import gnn_cell
from repro.launch.common import CellOptions
from repro.models import layers

gnn_cell.MIXED = layers.FP32
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k, v in tree.items():
            o.update(flat(v, f"{prefix}{k}/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}

for case, name, kind, params, compress, n in CASES:
    mesh = mesh_of(n)
    cell = gnn_cell.build(get_config("gin-tu", smoke=True), ShapeCell(name, kind, params), mesh,
                          CellOptions(compress_grads=compress))
    with mesh:
        # placed as the step's outputs are, so that the step is traced once
        st = jax.device_put(cell.init_state(), jax.tree.map(
            lambda s: NamedSharding(mesh, s), cell.state_shardings, is_leaf=lambda x: isinstance(x, P)))
        step = jax.jit(cell.step_fn)
        for s in range(STEPS):
            b = cell.make_batch(s)
            if s == 0:
                for f in b._fields:
                    out[f"{case}/batch/{f}"] = np.asarray(getattr(b, f))
            st, o = step(st, b)
            out[f"{case}/loss/{s}"] = np.asarray(o["loss"])
            if s == 0:
                for k, v in flat(jax.tree.map(np.asarray, st)).items():
                    out[f"{case}/step1/{k}"] = v
        for k, v in flat(jax.tree.map(np.asarray, st)).items():
            out[f"{case}/final/{k}"] = v
np.savez(pathlib.Path(D_DIR) / "gnn_jax.npz", **out)
"""
CASE_IDS = [c[0] for c in work.GNN_CASES]


def _save_initial_params(d) -> None:
    """The reference cells' initial params (``gnn.init(PRNGKey(0), cfg)``,
    as their ``init_state`` draws them), for the ranks to start from."""
    for case, _, kind, params, _, _ in work.GNN_CASES:
        cfg = dataclasses.replace(j_get_config("gin-tu", smoke=True).model, d_feat=params["d_feat"],
                                  n_classes=params["n_classes"],
                                  task="graph" if kind == "graph_batch" else "node")
        np.savez(d / f"gnn_init_{case}.npz", **single._flat(single._np(j_gnn.init(jax.random.PRNGKey(0), cfg))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gnn_ranks")
    body = f"D_DIR = {str(d)!r}\nSTEPS = {work.GNN_STEPS}\nCASES = {work.GNN_CASES!r}\n" + JAX_BODY
    proc = start_jax(body, n_dev=3)  # beside the ranks
    _save_initial_params(d)
    with ThreadPoolExecutor(2) as pool:  # the 2-rank and the 3-rank group at once
        futures = {n: pool.submit(run_ranks, "torch_rank_work:gnn_ranks", n, str(d / f"store{n}"), str(d))
                   for n in (2, 3)}
        ranks = {n: f.result() for n, f in futures.items()}
    finish(proc)
    return {"ranks": ranks, "ref": dict(np.load(d / "gnn_jax.npz"))}


def _case(case: str):
    return next(c for c in work.GNN_CASES if c[0] == case)


def _ref(runs, case: str, prefix: str) -> dict:
    p = f"{case}/{prefix}/"
    return {k[len(p):]: v for k, v in runs["ref"].items() if k.startswith(p)}


def _ranks(runs, case: str) -> list:
    return [r[case] for r in runs["ranks"][_case(case)[5]]]


@pytest.mark.parametrize("case", CASE_IDS)
def test_each_rank_takes_its_slice_of_the_reference_batch(runs, case):
    _, _, kind, _, _, n = _case(case)
    want = _ref(runs, case, "batch")
    for rank, r in enumerate(_ranks(runs, case)):
        got = r["rank_shard"]
        for f, w in want.items():
            if kind == "full_graph" and not f.startswith("edge_"):
                mine = w  # node features and labels replicated
            else:  # the full graph's edges sharded; the others: whole subgraphs or graphs a rank
                mine = np.split(w, n)[rank]
            assert got[f].dtype == mine.dtype and np.array_equal(got[f], mine), (rank, f)


@pytest.mark.parametrize("case", CASE_IDS)
def test_losses_agree_with_the_reference_cell(runs, case):
    want = [float(runs["ref"][f"{case}/loss/{s}"]) for s in range(work.GNN_STEPS)]
    for r in _ranks(runs, case):
        np.testing.assert_allclose(r["loss"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASE_IDS)
def test_state_after_one_step_agrees(runs, case):
    for r in _ranks(runs, case):
        single._state_close(r["step1"], _ref(runs, case, "step1"), single._fp32_atol)


@pytest.mark.parametrize("case", CASE_IDS)
def test_state_after_three_steps_agrees(runs, case):
    for r in _ranks(runs, case):
        single._state_close(r["final"], _ref(runs, case, "final"), single._fp32_atol_later)


@pytest.mark.parametrize("case", CASE_IDS)
def test_params_bit_equal_across_ranks(runs, case):
    rs = _ranks(runs, case)
    for at in ("step1", "final"):
        for k, v in rs[0][at].items():
            if k.startswith(("dense/", "opt/")):
                assert all(np.array_equal(r[at][k], v) for r in rs[1:]), (at, k)
    if _case(case)[4]:  # each rank's own residual, stacked in rank order
        assert rs[0]["final"]["ef/encoder/w"].shape[0] == _case(case)[5]
