"""The MSE ranking model of ``examples/train_mse.py`` against its twin in
the port (``repro_torch/examples/train_mse.py``) on the CPU: three train
steps of each cell on the same numpy batches, from the reference's dense
weights. The example is loaded by file path; nothing in ``examples/``
changes. Under "fp32" the loaded module's ``MIXED`` is set to ``FP32`` for
the run and the twin is built with ``prec=FP32``."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io.ragged import Ragged as JRagged
from repro.models import layers as j_layers
from repro_torch.convert import params_from_tree
from repro_torch.core import idmap as t_idmap
from repro_torch.examples import train_mse as t_mse
from repro_torch.models import layers as t_layers

STEPS = 3
DENSE_LR, SPARSE_LR = 1e-3, 1e-2  # the example's AdamW and SparseAdam rates


def _load_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "train_mse.py"
    spec = importlib.util.spec_from_file_location("reference_train_mse", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_mse = _load_example()


def _atol(prec: str, kind: str, scale: float) -> float:
    """Tolerance of one compared group, given its largest magnitude.

    FP32: the same arithmetic up to summation order, 1e-5 of the group's
    largest magnitude (the loss: 1e-5).
    MIXED (bf16 dense compute, as the example runs): the reasons of
    tests/test_torch_train.py. The loss within 2e-2 (a few bf16 ulps of the
    logits); Adam normalises the gradient, so where bf16 noise flips the
    sign of a gradient near zero the two frameworks move that element up to
    2 * lr apart per step: rows 2 * 1e-2 * steps, dense params 2 * 1e-3 *
    steps. The rows' moments after the first step, whose gradients are
    taken at the same state, within 5e-2 of their largest magnitude; after
    later steps within 0.25 of it, because by then the rows the gradients
    are taken at differ by up to 2e-2 an element (SparseAdam's lr is ten
    times the dlrm slice's), and the attention and the DNN carry that into
    every gradient of a sample (measured: 0.11 and 0.14 at steps 2 and 3).
    """
    if prec == "fp32":
        return 1e-5 * max(scale, 1.0 if kind == "loss" else 1e-30)
    return {"loss": 2e-2, "rows": 2 * SPARSE_LR * STEPS, "params": 2 * DENSE_LR * STEPS,
            "moments": 5e-2 * scale, "later_moments": 0.25 * scale}[kind]


def _close(prec, kind, got: dict, want: dict, what: str) -> None:
    want = {k: np.asarray(v) for k, v in want.items()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0, atol=_atol(prec, kind, scale),
                                   err_msg=f"{what} {k}")


def _run_steps() -> list[dict]:
    jcell = j_mse.MSECell()
    tcell = t_mse.MSECell("cpu", prec=t_layers.FP32 if j_mse.MIXED is j_layers.FP32 else t_layers.MIXED)
    jstate = jcell.init_state()
    tstate = tcell.init_state()
    tstate["dense"].load_state_dict(params_from_tree(tstate["dense"], jax.tree.map(np.asarray, jcell.init_dense)))
    jstep = jax.jit(jcell.step_fn)
    out = []
    for s in range(STEPS):
        arrays = t_mse.batch_arrays(tcell.specs, t_mse.BATCH, seed=s)
        jbatch = {k: JRagged(jnp.asarray(v), jnp.asarray(sp)) for k, (v, sp) in arrays.items()}
        jstate, jo = jstep(jstate, jbatch)
        tstate, to = tcell.step_fn(tstate, t_mse.to_batch(arrays, "cpu"))
        jsp, tsp = jstate["sparse"]["dim8"], tstate["sparse"]["dim8"]
        out.append(dict(
            jo={k: np.asarray(v) for k, v in jo.items()}, to={k: v.numpy() for k, v in to.items()},
            jmap={f: np.asarray(getattr(jsp["idmap"], f)) for f in t_idmap.TENSOR_FIELDS},
            tmap={f: getattr(tsp["idmap"], f).numpy().copy() for f in t_idmap.TENSOR_FIELDS},
            jrows={"emb": np.asarray(jsp["blocks"].emb), **{k: np.asarray(v) for k, v in jsp["blocks"].slots.items()}},
            trows={"emb": tsp["blocks"].emb.numpy().copy(),
                   **{k: v.numpy().copy() for k, v in tsp["blocks"].slots.items()}},
            jdense=params_from_tree(tstate["dense"], jax.tree.map(np.asarray, jstate["dense"])),
            tdense={k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}))
    return out


@pytest.fixture(scope="module", params=["fp32", "mixed"])
def steps(request):
    """(precision, per-step results); "fp32" sets the loaded example's MIXED
    to FP32 for the run, which changes no file."""
    mp = pytest.MonkeyPatch()
    if request.param == "fp32":
        mp.setattr(j_mse, "MIXED", j_layers.FP32)
    try:
        return request.param, _run_steps()
    finally:
        mp.undo()


def test_mse_constants_and_specs_match_the_example():
    for name in ("DIM", "N_HASH", "N_BUCKET", "N_SEQ", "SEQ_LEN", "BATCH"):
        assert getattr(t_mse, name) == getattr(j_mse, name), name
    want = [(s.name, s.transform, s.emb_dim, s.pooling, s.max_len, tuple(map(float, s.boundaries)))
            for s in j_mse.specs()]
    got = [(s.name, s.transform, s.emb_dim, s.pooling, s.max_len, tuple(map(float, s.boundaries)))
           for s in t_mse.specs()]
    assert got == want
    j_dims = [np.asarray(l["w"]).shape for _, l in sorted(j_mse.MSECell().init_dense["dnn"].items())]
    assert [(a, b) for a, b in zip(t_mse.DNN_DIMS, t_mse.DNN_DIMS[1:])] == j_dims


def test_mse_step_integers_bit_equal(steps):
    _, steps = steps
    for i, st in enumerate(steps):
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        tm = {k: int(v) for k, v in st["to"].items() if k != "loss"}
        assert tm == jm, f"step {i}"
        assert tm["dim8/exch_uniq_overflow"] > 0  # the example's u_budget cuts the batch
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(st["tmap"][f], st["jmap"][f], err_msg=f"step {i} {f}")


def test_mse_step_loss_rows_and_params_agree(steps):
    prec, steps = steps
    for i, st in enumerate(steps):
        _close(prec, "loss", {"loss": float(st["to"]["loss"])}, {"loss": float(st["jo"]["loss"])},
               f"step {i}")
        _close(prec, "rows", {"emb": st["trows"]["emb"]}, {"emb": st["jrows"]["emb"]}, f"step {i}")
        for k in ("m", "v"):
            _close(prec, "moments" if i == 0 else "later_moments", {k: st["trows"][k]},
                   {k: st["jrows"][k]}, f"step {i}")
        _close(prec, "params", st["tdense"], st["jdense"], f"step {i}")


def test_mse_step_trains(steps):
    """The comparison above is not vacuous: rows and params moved, and the
    loss stayed finite."""
    _, steps = steps
    first, last = steps[0], steps[-1]
    assert not np.array_equal(first["trows"]["emb"], last["trows"]["emb"])
    assert all(np.isfinite(float(st["to"]["loss"])) for st in steps)
    n = "dnn.l0.weight"
    assert not torch.equal(first["tdense"][n], last["tdense"][n])
