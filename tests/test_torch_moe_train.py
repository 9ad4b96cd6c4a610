"""The MoE archs' smoke train cells, JAX package against the PyTorch port on
the CPU: three MIXED steps of ``train_4k`` (T 128, batch 2) for
``qwen2-moe-a2.7b`` and ``moonshot-v1-16b-a3b``, one module-scoped JAX cell
per arch (Pallas attention in interpret mode, remat, no ZeRO-1), both from
a fresh state with the JAX cell's dense params and zero AdamW moments, on
the same batches. Both differentiate the loss plus the routers' aux loss
and report the loss without it (shown by a zero aux weight). Then the
cell builds with the train options and the train driver trains a MoE
arch.

Held as tests/test_torch_lm.py holds the dense LM's train cell where the
MoE lets it, and more closely where it does not:
  * integers (engine metrics, IDMap fields, exported ids and last-use
    steps) bit-equal; the loss within 5e-3;
  * the AdamW moments after step 1 (m = (1 - b1)·g and v = (1 - b2)·g²
    of the clipped gradient: the whole model's gradient, the aux term
    in it) and the token rows' SparseAdam moments after every step,
    each param's and the rows' by its relative L2 distance
    ‖got - want‖ / ‖want‖;
  * the token rows and the dense params no more than 2·lr·steps apart, and
    at most ``MAX_APART_SHARE`` of their elements more than lr / 10 apart
    (``test_torch_lm._adam_close``'s checks at the MoE's share).
Elementwise bounds in units of the largest magnitude, as the dense LM
uses, do not hold here: a near-tie token that takes another expert in each
framework moves a few elements of its experts' and the head's gradients
by up to 25% of their largest (0.185 of layers.0.moe.up's, 0.248 of
moonshot's head's after step 1).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShape
from repro.launch import lm_cell as j_lm
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import transformer_from_numpy
from repro_torch.core import idmap as t_idmap
from repro_torch.launch import train as t_train
from repro_torch.launch.cells import build_arch_cell, build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts
from test_torch_lm import LR, TRAIN_STEPS
from test_torch_moe import MOE_ARCHS

T, B = 128, 2
SHAPE = {"seq_len": T, "global_batch": B}
# the relative L2 distances seen after step 1 (qwen2-moe, moonshot): AdamW m
# at most 0.063 and 0.055, v 0.082 and 0.071 (in layers.0's router and
# experts); the routers' aux term left out or doubled puts layers.1's
# router at 0.23 to 0.28 in m and 0.39 to 0.63 in v. The rows' m and v over
# three steps: at most 0.072.
ADAMW_M_L2, ADAMW_V_L2, ROWS_L2 = 0.12, 0.16, 0.12
# the share of elements more than lr / 10 apart after three steps: dense
# 0.153 and 0.181, rows 0.031 and 0.044 seen; an optimizer that moved
# nothing puts nearly all of them lr·steps apart
MAX_APART_SHARE = 0.3


@pytest.fixture(scope="module", params=MOE_ARCHS)
def train(request):
    arch_id = request.param
    mesh = make_test_mesh()
    jopts = JOpts(attn_impl="pallas", remat=True, zero1=False)
    jcell = j_build_cell(arch_id, "train_4k", mesh, jopts, smoke=True,
                         shape_override=JShape("train_4k", "train", SHAPE))
    tcell = t_build_cell(arch_id, "train_4k", smoke=True, shape_override=TShape("train_4k", "train", SHAPE),
                         device="cpu")
    tcfg = tcell.arch.model
    jeng, gkey = j_lm._engine_for(jcell.arch.model, mesh, B * T, jopts)  # the cell keeps its engine to itself
    steps = []
    with mesh:
        jstate = jcell.init_state()
        tstate = tcell.init_state()
        tstate["dense"].load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcfg))
        params0 = {k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}
        jstep = jax.jit(jcell.step_fn)
        for s in range(TRAIN_STEPS):
            jstate, jo = jstep(jstate, jcell.make_batch(s))
            tstate, to = tcell.step_fn(tstate, tcell.make_batch(s))
            if s == 0:  # the moments after step 1: the gradient
                adamw_after_1 = {k: (transformer_from_numpy(jax.tree.map(np.asarray, jstate["opt"][k]), tcfg),
                                     {n: v.clone() for n, v in tstate["opt"][k].items()}) for k in ("m", "v")}
            steps.append(dict(
                jo=jax.tree.map(np.asarray, jo), to=to,
                jmap=jax.tree.map(np.asarray, jstate["sparse"][gkey]["idmap"]),
                tmap=tstate["sparse"][gkey]["idmap"],
                jrows=jeng.export_rows(jstate["sparse"])[gkey],
                trows=tcell.engine.export_rows(tstate["sparse"])[gkey],
                jdense=transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcfg),
                tdense={k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}))
    return dict(arch_id=arch_id, jcell=jcell, tcell=tcell, steps=steps, params0=params0, gkey=gkey,
                adamw_after_1=adamw_after_1)


def test_moe_train_batches_equal(train):
    for s in range(TRAIN_STEPS):
        np.testing.assert_array_equal(train["tcell"].make_batch(s).numpy(), np.asarray(train["jcell"].make_batch(s)))


def test_moe_train_integers_bit_equal(train):
    """Engine metrics, every IDMap field and the exported ids and last-use
    steps after each step."""
    inserted = 0
    for st in train["steps"]:
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        tm = {k: int(v) for k, v in st["to"].items() if k != "loss"}
        assert tm == jm
        inserted += tm[f"{train['gkey']}/idmap_inserted"]
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(st["tmap"], f)[0].numpy(),
                                          np.asarray(getattr(st["jmap"], f))[0], err_msg=f)
        for k in ("ids", "last_use"):
            np.testing.assert_array_equal(st["trows"][k], st["jrows"][k], err_msg=k)
    assert inserted > 0


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _apart(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """No element more than 2·lr·steps apart, at most MAX_APART_SHARE of
    them more than lr / 10."""
    d = np.abs(got - want)
    assert d.max() <= 2 * LR * TRAIN_STEPS, f"{what}: max diff {d.max()}"
    frac = float((d > LR / 10).mean())
    assert frac <= MAX_APART_SHARE, f"{what}: {frac:.4f} of the elements more than lr / 10 apart"


def test_moe_train_loss_rows_and_params_agree(train):
    """The loss (a mean near log 512 = 6.2, the aux term left out) within
    5e-3 at each step; the rows' SparseAdam m and v within ROWS_L2; the
    rows and the dense params ``_apart``; the params moved and the rows
    moved between steps (the comparison is not vacuous)."""
    for i, st in enumerate(train["steps"]):
        np.testing.assert_allclose(float(st["to"]["loss"]), float(st["jo"]["loss"]), rtol=0, atol=5e-3,
                                   err_msg=f"step {i} loss")
        tr, jr = st["trows"], st["jrows"]
        for k in ("m", "v"):
            dist = _rel_l2(tr["slots"][k], jr["slots"][k])
            assert dist <= ROWS_L2, f"step {i} rows {k}: relative L2 {dist}"
        _apart(tr["emb"], jr["emb"], f"step {i} rows")
        _apart(np.concatenate([st["tdense"][n].numpy().ravel() for n in st["jdense"]]),
               np.concatenate([w.numpy().ravel() for w in st["jdense"].values()]), f"step {i} dense")
    first, last = train["steps"][0], train["steps"][-1]
    for n, p0 in train["params0"].items():
        assert not torch.equal(last["tdense"][n], p0), n
    n0 = first["trows"]["emb"].shape[0]
    assert not np.array_equal(last["trows"]["emb"][:n0], first["trows"]["emb"])


def test_moe_train_adamw_moments_after_step_1_agree(train):
    """AdamW's m and v after step 1 hold the clipped gradient of loss + aux
    in every dense param: each param's within ADAMW_M_L2 and ADAMW_V_L2
    (relative L2), every param present and nonzero."""
    for k, tol in (("m", ADAMW_M_L2), ("v", ADAMW_V_L2)):
        want, got = train["adamw_after_1"][k]
        assert set(got) == set(want)
        for n, w in want.items():
            assert float(w.abs().max()) > 0, f"{k} {n} is zero"
            dist = _rel_l2(got[n].numpy(), w.numpy())
            assert dist <= tol, f"AdamW {k} of {n} after step 1: relative L2 {dist}"


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_train_differentiates_aux_and_reports_the_loss_without_it(arch_id):
    """One step from the same state with the arch's router aux weight and
    with 0: the reported losses are equal (the loss alone), the routers
    after the step are not (the aux loss is in the gradient)."""
    arch = t_get_config(arch_id, smoke=True)
    no_aux = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, moe=dataclasses.replace(arch.model.moe, router_aux_weight=0.0)))
    shape = TShape("train_4k", "train", {"seq_len": 32, "global_batch": 2})
    out = {}
    for name, a in (("aux", arch), ("no_aux", no_aux)):
        cell = build_arch_cell(a, shape, device="cpu")
        state, o = cell.step_fn(cell.init_state(), cell.make_batch(0))
        out[name] = (float(o["loss"]), {k: v.detach().clone() for k, v in state["dense"].state_dict().items()})
    assert arch.model.moe.router_aux_weight > 0 and out["aux"][0] == out["no_aux"][0]
    for i in range(arch.model.n_layers):
        n = f"layers.{i}.moe.router"
        assert not torch.equal(out["aux"][1][n], out["no_aux"][1][n]), n


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_train_cell_builds_with_the_options(arch_id):
    """The MoE train cell builds (the refusal is gone), and ``remat``,
    ``remat_policy`` and ``fused_ce`` reach its config."""
    cell = t_build_cell(arch_id, "train_4k", smoke=True, device="cpu",
                        shape_override=TShape("train_4k", "train", SHAPE),
                        opts=TOpts(remat=False, remat_policy="dots", fused_ce=True))
    cfg = cell.arch.model
    assert cfg.moe is not None and (cfg.remat, cfg.remat_policy) == (False, "dots")
    assert cell.init_state()["dense"].cfg == cfg


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_train_driver_trains(arch_id):
    """``python -m repro_torch.launch.train --arch <moe> --device cpu``
    trains 2 smoke steps: finite losses, each equal to the cell's own on the
    same batch from the same fresh state."""
    args = t_train.build_parser().parse_args(["--arch", arch_id, "--device", "cpu", "--steps", "2",
                                              "--batch", "2", "--seq-len", "32", "--log-every", "1"])
    res, _ = t_train.run(args, t_train.get_config(arch_id, smoke=True))
    assert res.steps_run == 2
    got = [float(m["loss"]) for m in res.metrics_history]
    cell = t_build_cell(arch_id, "train_4k", smoke=True, device="cpu",
                        shape_override=TShape("train_4k", "train", {"seq_len": 32, "global_batch": 2}))
    state, want = cell.init_state(), []
    for s in range(2):
        state, out = cell.step_fn(state, cell.make_batch(s))
        want.append(float(out["loss"]))
    assert len(got) == 2 and all(np.isfinite(got))
    assert got == want
