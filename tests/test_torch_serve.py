"""The dlrm-mlperf smoke serve cell, JAX package against the PyTorch port on
the CPU: same imported engine rows, same dense params, same batches."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShape
from repro.launch import recsys_cell as j_recsys
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro.models.recsys import dlrm as j_dlrm
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import params_from_tree
from repro_torch.io.ragged import Ragged
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts, local_view
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import dlrm as t_dlrm


BATCH, SEEDS = 32, (0, 1, 2)
# bf16 logits: each framework may round matmul sums and bias adds at other
# places. |logit| < 0.5 here, where one bf16 ulp is <= 2^-10; the tolerance
# allows a few ulps over the 3 + 2 layers.
MIXED_TOL = dict(rtol=2e-2, atol=2e-2)


def _t_batch(jbatch) -> dict:
    return {k: Ragged(torch.from_numpy(np.array(v.values)), torch.from_numpy(np.array(v.row_splits)))
            for k, v in jbatch.items()}


@pytest.fixture(scope="module")
def cells():
    mesh = make_test_mesh()
    jcell = j_build_cell("dlrm-mlperf", "serve_p99", mesh, JOpts(remat=False, zero1=False),
                         smoke=True, shape_override=JShape("serve_p99", "serve", {"batch": BATCH}))
    tcell = t_build_cell("dlrm-mlperf", "serve_p99", smoke=True,
                         shape_override=TShape("serve_p99", "serve", {"batch": BATCH}), device="cpu")
    # engine rows: every id of the three requests except every 7th (missing
    # ids read as zero rows), in the reference's export format
    eng = np.concatenate([np.asarray(jcell.engine.engine_ids(jcell.ids_fn(jcell.make_batch(s)))["dim16"])
                          for s in SEEDS])
    ids = np.unique(eng[eng != -1])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    r = np.random.default_rng(0)
    n = ids.size
    rows = {"dim16": {"ids": ids, "emb": r.normal(size=(n, 16)).astype(np.float32),
                      "slots": {"m": np.zeros((n, 16), np.float32), "v": np.zeros((n, 16), np.float32)},
                      "last_use": np.ones(n, np.int32)}}
    with mesh:
        jstate = jcell.init_state()
        jstate["sparse"] = jcell.engine.import_rows(rows)
        jstep = jax.jit(jcell.step_fn)
        jout = [jstep(jstate, jcell.make_batch(s)) for s in SEEDS]
    tstate = tcell.init_state()
    tstate["sparse"] = tcell.engine.import_rows(rows)
    dense_np = jax.tree.map(np.asarray, jstate["dense"])
    tstate["dense"].load_state_dict(params_from_tree(tstate["dense"], dense_np))
    tout = [tcell.step_fn(tstate, tcell.make_batch(s)) for s in SEEDS]
    return dict(jcell=jcell, tcell=tcell, jstate=jstate, tstate=tstate, jout=jout, tout=tout,
                mesh=mesh)


def test_plumbing_budgets_equal(cells):
    for batch in (BATCH, 512, 262_144):
        jarch, tarch = cells["jcell"].arch, cells["tcell"].arch
        jpl = j_recsys._plumbing(jarch, cells["mesh"], batch, j_dlrm.feature_specs(jarch.model),
                                 JOpts())
        tpl = t_recsys._plumbing(tarch, batch, t_dlrm.feature_specs(tarch.model), TOpts(), "cpu")
        assert tpl.engine.cfg.overrides == jpl.engine.cfg.overrides
        assert tpl.nnz_loc == jpl.nnz_loc


def test_make_batch_draws_the_reference_stream(cells):
    for s in SEEDS:
        jb, tb = cells["jcell"].make_batch(s), cells["tcell"].make_batch(s)
        for k in jb:
            np.testing.assert_array_equal(tb[k].values.numpy(), np.asarray(jb[k].values))
            np.testing.assert_array_equal(tb[k].row_splits.numpy(), np.asarray(jb[k].row_splits))


def test_serve_metrics_equal(cells):
    for jo, to in zip(cells["jout"], cells["tout"]):
        jm = {k: int(v) for k, v in jo.items() if k != "logits"}
        tm = {k: int(v) for k, v in to.items() if k != "logits"}
        assert tm == jm
        assert tm["dim16/dev_rows_live"] > 0


def _acts(cells, seed):
    jcell, tcell = cells["jcell"], cells["tcell"]
    jb = jcell.make_batch(seed)
    jids = jcell.ids_fn(jb)
    jst = jax.tree.map(lambda x: x[0], cells["jstate"]["sparse"])
    _, jrows, jplans, _ = jcell.engine.fetch_local(jst, jids, jnp.int32(0), train=False)
    jacts = jcell.engine.activations(jrows, jplans, jids)
    tb = _t_batch(jb)
    tids = tcell.ids_fn(tb)
    tst = local_view(cells["tstate"]["sparse"])
    _, trows, tplans, _ = tcell.engine.fetch_local(tst, tids, torch.tensor(0), train=False)
    tacts = tcell.engine.activations(trows, tplans, tids)
    return jb, jacts, tacts


@pytest.mark.parametrize("seed", SEEDS)
def test_pooled_activations_and_fp32_model_agree(cells, seed):
    jb, jacts, tacts = _acts(cells, seed)
    assert set(tacts) == set(jacts)
    for k in jacts:
        np.testing.assert_allclose(tacts[k].numpy(), np.asarray(jacts[k]), rtol=1e-6, atol=0)
    mcfg = cells["tcell"].arch.model
    dense = {"dense": np.asarray(jb["dense"].values).reshape(-1, mcfg.n_dense)}
    jl = j_dlrm.apply(cells["jstate"]["dense"], cells["jcell"].arch.model, jacts,
                      {"dense": jnp.asarray(dense["dense"])}, j_layers.FP32)
    tl = t_dlrm.apply(cells["tstate"]["dense"], mcfg,
                      {k: torch.from_numpy(np.array(v)) for k, v in jacts.items()},
                      {"dense": torch.tensor(dense["dense"])}, t_layers.FP32)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_mixed_logits_agree(cells):
    for jo, to in zip(cells["jout"], cells["tout"]):
        assert to["logits"].shape == (BATCH,) and to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), **MIXED_TOL)


def test_tril_pair_order_equal():
    for f in (2, 5, 27):
        iu, ju = jnp.tril_indices(f, k=-1)
        t = torch.tril_indices(f, f, offset=-1)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(iu))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(ju))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imported_roots(path: Path) -> set[str]:
    """The top-level package of every import in ``path``, at any depth of
    the file (inside functions too), read from its syntax tree."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("name", ["chip_smoke.py"] + sorted(
    p.name for p in (Path(__file__).resolve().parents[1] / "scripts").glob("*.py")))
def test_card_scripts_import_neither_jax_nor_repro(name):
    root = Path(__file__).resolve().parents[1]
    path = root / name if name == "chip_smoke.py" else root / "scripts" / name
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)
    assert "torch" in roots


def test_build_cell_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_cell("dlrm-mlperf", "serve_p99", smoke=True)
