"""The training slice of the PyTorch port against the JAX package on the CPU:
the row init hash, the train branch of the exchange, the differentiable
routing, the FP32 DLRM loss and its gradients, and the whole dlrm-mlperf
smoke train step over three steps from one converted state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShape
from repro.core import blocks as j_blocks
from repro.core import exchange as j_exchange
from repro.core import idmap as j_idmap
from repro.launch.cells import build_cell as j_build_cell
from repro.launch import recsys_cell as j_recsys
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import layers as j_layers
from repro.models.recsys import dlrm as j_dlrm
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import params_from_tree
from repro_torch.core import blocks as t_blocks
from repro_torch.core import exchange as t_exchange
from repro_torch.core import idmap as t_idmap
from repro_torch.launch import recsys_cell as t_recsys
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import dlrm as t_dlrm


BATCH, STEPS, LR = 32, 3, 1e-3


def _atol(prec: str, kind: str, scale: float) -> float:
    """Tolerance of one compared tensor of the whole train step, given the
    largest magnitude ``scale`` of its group (all embedding rows, all dense
    params, all m or all v moments of one step). A gradient is a sum over
    the batch whose terms may cancel, so its error follows the size of the
    group, not of the one element.

    FP32 (the cells' MIXED set to FP32): the same arithmetic up to summation
    order: 1e-5 of the group's largest magnitude.

    MIXED (bf16 dense compute, as the cells run): each framework rounds
    matmul sums and bias adds at other places.
      * loss, a mean near log 2: 2e-2 allows a few bf16 ulps of the logits;
      * params and embedding rows: Adam normalises the gradient, so where
        bf16 noise flips the sign of a gradient near 0 (or leaves it at
        exactly 0 in one framework) the two move that element up to 2 * lr
        apart in a step: 2 * lr * steps;
      * the embedding rows' moments: 5e-2 of the group's largest magnitude.
    The dense params' AdamW moments are held in FP32 only: in bf16 a
    pre-activation within an ulp of 0 can fall on either side of a ReLU,
    which moves that unit's gradient by one sample's whole contribution, as
    large as the group's largest moment.
    """
    if prec == "fp32":
        return 1e-5 * max(scale, 1e-30)
    return {"loss": 2e-2, "params": 2 * LR * STEPS, "moments": 5e-2 * scale}[kind]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _ids(r, n: int) -> np.ndarray:
    return np.unique(r.integers(-(1 << 62), 1 << 62, size=4 * n, dtype=np.int64))[:n]


# ------------------------------------------------------------------- blocks

@pytest.mark.parametrize("dim", [1, 8, 16, 128])
def test_hash_uniform_bit_equal(dim):
    r = np.random.default_rng(dim)
    edge = np.array([0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max], np.int64)
    ids = np.concatenate([edge, r.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                                           size=300, dtype=np.int64)])
    np.testing.assert_array_equal(t_blocks._hash_uniform(_t(ids), dim).numpy(),
                                  np.asarray(j_blocks._hash_uniform(jnp.asarray(ids), dim)))


def test_init_rows_bit_equal_in_place_on_a_view():
    r = np.random.default_rng(0)
    n_rows, dim, k = 64, 8, 40
    emb = r.normal(size=(n_rows, dim)).astype(np.float32)
    slots = {s: r.normal(size=(n_rows, dim)).astype(np.float32) for s in ("m", "v")}
    offsets = r.permutation(n_rows)[:k].astype(np.int32)
    ids = _ids(r, k)
    is_new = r.random(k) < 0.6
    jb = j_blocks.init_rows(j_blocks.Blocks(emb=jnp.asarray(emb), slots={
        s: jnp.asarray(v) for s, v in slots.items()}), jnp.asarray(offsets), jnp.asarray(ids),
        jnp.asarray(is_new))
    stacked = t_blocks.Blocks(emb=_t(emb)[None], slots={s: _t(v)[None] for s, v in slots.items()})
    tb = t_blocks.init_rows(stacked.map(lambda x: x[0]), _t(offsets), _t(ids), _t(is_new))
    np.testing.assert_array_equal(stacked.emb[0].numpy(), np.asarray(jb.emb))
    for s in ("m", "v"):
        np.testing.assert_array_equal(stacked.slots[s][0].numpy(), np.asarray(jb.slots[s]))
    assert tb.emb.data_ptr() == stacked.emb.data_ptr()


# ---------------------------------------------------------------- exchange

def _spec_pair(U, C, R):
    return (j_exchange.ExchangeSpec(axes=("data",), n_devices=1, u_budget=U, per_dest_cap=C,
                                    recv_budget=R),
            t_exchange.ExchangeSpec(n_devices=1, u_budget=U, per_dest_cap=C, recv_budget=R))


def _fetch_inputs(seed, n_rows, cap, dim=8):
    """A map holding some ids, a batch of known, new and PAD ids, and rows."""
    r = np.random.default_rng(seed)
    known, fresh = _ids(r, 30), _ids(r, 40)
    ids = r.choice(np.concatenate([known, fresh]), size=90)
    ids[r.random(90) < 0.1] = -1
    emb = r.normal(size=(n_rows, dim)).astype(np.float32)
    slots = {s: r.normal(size=(n_rows, dim)).astype(np.float32) for s in ("m", "v")}
    jm, _, _, _ = j_idmap.lookup_or_insert(j_idmap.create(cap, n_rows), jnp.asarray(known),
                                           jnp.int32(1))
    tm, _, _, _ = t_idmap.lookup_or_insert(t_idmap.create(cap, n_rows, "cpu"), _t(known), 1)
    jb = j_blocks.Blocks(emb=jnp.asarray(emb), slots={s: jnp.asarray(v) for s, v in slots.items()})
    tb = t_blocks.Blocks(emb=_t(emb), slots={s: _t(v) for s, v in slots.items()})
    return ids, jm, jb, tm, tb


@pytest.mark.parametrize("U,C,R,n_rows,cap", [
    (64, 256, 128, 128, 256),   # fits
    (24, 32, 16, 128, 256),     # dedupe and merge budgets cut
    (64, 256, 128, 50, 256),    # rows run out: row overflow
    (64, 256, 128, 128, 64),    # a full map: probe overflow
])
def test_train_fetch_bit_equal(U, C, R, n_rows, cap):
    ids, jm, jb, tm, tb = _fetch_inputs(U + n_rows + cap, n_rows, cap)
    js, ts = _spec_pair(U, C, R)
    jm, jb, j_rows, j_plan, j_met = j_exchange.fetch(jm, jb, jnp.asarray(ids), js, jnp.int32(2), True)
    tm, tb, t_rows, t_plan, t_met = t_exchange.fetch(tm, tb, _t(ids), ts, torch.tensor(2), True)
    for f in t_idmap.TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    for f in t_exchange.Plan._fields:
        np.testing.assert_array_equal(getattr(t_plan, f).numpy(), np.asarray(getattr(j_plan, f)),
                                      err_msg=f)
    assert {k: int(v) for k, v in t_met.items()} == {k: int(v) for k, v in j_met.items()}
    assert int(t_met["idmap_inserted"]) > 0
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(tb.emb.numpy(), np.asarray(jb.emb))
    for s in ("m", "v"):
        np.testing.assert_array_equal(tb.slots[s].numpy(), np.asarray(jb.slots[s]))


@pytest.mark.parametrize("U,C,R", [(64, 256, 128), (24, 32, 16)])
def test_route_rows_vjp_agrees(U, C, R):
    """Routing and its gradient in rows_r (duplicate ids, PAD, cut budgets),
    with the masks applied in place under autograd."""
    ids, jm, jb, tm, tb = _fetch_inputs(U, 128, 256)
    js, ts = _spec_pair(U, C, R)
    _, _, _, j_plan, _ = j_exchange.fetch(jm, jb, jnp.asarray(ids), js, jnp.int32(2), True)
    _, _, _, t_plan, _ = t_exchange.fetch(tm, tb, _t(ids), ts, torch.tensor(2), True)
    r = np.random.default_rng(R)
    rows = r.normal(size=(R, 8)).astype(np.float32)
    cot = r.normal(size=(ids.size, 8)).astype(np.float32)
    j_vals, vjp = jax.vjp(lambda x: j_exchange.route_rows(x, j_plan, js), jnp.asarray(rows))
    (j_grad,) = vjp(jnp.asarray(cot))
    t_rows = _t(rows).requires_grad_()
    t_vals = t_exchange.route_rows(t_rows, t_plan, ts)
    (t_grad,) = torch.autograd.grad(t_vals, t_rows, _t(cot))
    np.testing.assert_array_equal(t_vals.detach().numpy(), np.asarray(j_vals))
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(j_grad)).sum() > 0


# -------------------------------------------------------------------- loss

def test_fp32_dlrm_loss_and_gradients_agree():
    mesh = make_test_mesh()
    jcell = j_build_cell("dlrm-mlperf", "serve_p99", mesh, JOpts(remat=False, zero1=False),
                         smoke=True, shape_override=JShape("serve_p99", "serve", {"batch": BATCH}))
    tcell = t_build_cell("dlrm-mlperf", "serve_p99", smoke=True, device="cpu",
                         shape_override=TShape("serve_p99", "serve", {"batch": BATCH}))
    jcfg, tcfg = jcell.arch.model, tcell.arch.model
    r = np.random.default_rng(1)
    acts = {f"cat_{i}": r.normal(size=(BATCH, tcfg.embed_dim)).astype(np.float32)
            for i in range(tcfg.n_sparse)}
    dense = {"dense": r.normal(size=(BATCH, tcfg.n_dense)).astype(np.float32),
             "label": (r.random((BATCH, 1)) < 0.5).astype(np.float32)}
    params = j_dlrm.init(jax.random.PRNGKey(3), jcfg)

    def jloss(p, a):
        return j_dlrm.loss(p, jcfg, a, {k: jnp.asarray(v) for k, v in dense.items()}, j_layers.FP32)

    j_val, (j_gp, j_ga) = jax.value_and_grad(jloss, argnums=(0, 1))(
        params, {k: jnp.asarray(v) for k, v in acts.items()})
    model = t_dlrm.init(tcfg, device="cpu")
    model.load_state_dict(params_from_tree(model, jax.tree.map(np.asarray, params)))
    t_acts = {k: _t(v).requires_grad_() for k, v in acts.items()}
    t_val = t_dlrm.loss(model, tcfg, t_acts, {k: _t(v) for k, v in dense.items()}, t_layers.FP32)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(t_val, [*model.parameters(), *t_acts.values()])
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=1e-5, atol=1e-5)
    want = params_from_tree(model, jax.tree.map(np.asarray, j_gp))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5, err_msg=n)
    for k, g in zip(t_acts, grads[len(names):]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_ga[k]), rtol=1e-5, atol=1e-5, err_msg=k)


# --------------------------------------------------------------- whole step

def _run_steps(insert: bool = True) -> list[dict]:
    """Both smoke train cells from one converted state (engine rows with
    nonzero moments, every 7th id of the batches left out so it is
    inserted, or with ``insert`` False looked up and missed: both cells'
    ``train_insert``; the reference's dense params and AdamW state), then
    three steps each on the same batches."""
    mesh = make_test_mesh()
    shape = {"batch": BATCH}
    jcell = j_build_cell("dlrm-mlperf", "train_batch", mesh, JOpts(remat=False, zero1=False, train_insert=insert),
                         smoke=True, shape_override=JShape("train_batch", "train", shape))
    tcell = t_build_cell("dlrm-mlperf", "train_batch", TOpts(train_insert=insert), smoke=True, device="cpu",
                         shape_override=TShape("train_batch", "train", shape))
    eng = np.concatenate([np.asarray(jcell.engine.engine_ids(jcell.ids_fn(jcell.make_batch(s)))["dim16"])
                          for s in range(STEPS)])
    ids = np.unique(eng[eng != -1])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    r = np.random.default_rng(0)
    n = ids.size
    rows = {"dim16": {"ids": ids, "emb": r.normal(scale=0.1, size=(n, 16)).astype(np.float32),
                      "slots": {"m": r.normal(scale=1e-3, size=(n, 16)).astype(np.float32),
                                "v": r.random(size=(n, 16)).astype(np.float32) * 1e-5},
                      "last_use": np.ones(n, np.int32)}}
    with mesh:
        jstate = jcell.init_state()
        jstate["sparse"] = jcell.engine.import_rows(rows)
        tstate = tcell.init_state()
        tstate["sparse"] = tcell.engine.import_rows(rows)
        model = tstate["dense"]
        model.load_state_dict(params_from_tree(model, jax.tree.map(np.asarray, jstate["dense"])))
        tstate["opt"] = {k: params_from_tree(model, jax.tree.map(np.asarray, jstate["opt"][k])) for k in ("m", "v")}
        jstep = jax.jit(jcell.step_fn)
        out = []
        for s in range(STEPS):
            jstate, jo = jstep(jstate, jcell.make_batch(s))
            tstate, to = tcell.step_fn(tstate, tcell.make_batch(s))
            out.append(dict(
                jo=jax.tree.map(np.asarray, jo), to=to,
                jmap=jax.tree.map(np.asarray, jstate["sparse"]["dim16"]["idmap"]),
                tmap=tstate["sparse"]["dim16"]["idmap"],
                jrows=jcell.engine.export_rows(jstate["sparse"])["dim16"],
                trows=tcell.engine.export_rows(tstate["sparse"])["dim16"],
                jdense=params_from_tree(model, jax.tree.map(np.asarray, jstate["dense"])),
                tdense={k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()},
                jopt={k: params_from_tree(model, jax.tree.map(np.asarray, jstate["opt"][k])) for k in ("m", "v")},
                topt={k: {n: t.clone() for n, t in d.items()} for k, d in tstate["opt"].items()}))
    return out


@pytest.fixture(scope="module", params=["fp32", "mixed"])
def steps(request):
    """(precision, per-step results); "fp32" sets both cells' MIXED to FP32
    for the run, which changes no file of either package."""
    mp = pytest.MonkeyPatch()
    if request.param == "fp32":
        mp.setattr(j_recsys, "MIXED", j_layers.FP32)
        mp.setattr(t_recsys, "MIXED", t_layers.FP32)
    try:
        return request.param, _run_steps()
    finally:
        mp.undo()


def _close(prec, kind, got: dict, want: dict, what: str) -> None:
    """Compare a group of tensors, by name, within ``_atol``."""
    want = {k: np.asarray(v) for k, v in want.items()}
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0, atol=_atol(prec, kind, scale),
                                   err_msg=f"{what} {k}")


def test_train_step_integers_bit_equal(steps):
    _, steps = steps
    inserted = 0
    for st in steps:
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        tm = {k: int(v) for k, v in st["to"].items() if k != "loss"}
        assert tm == jm
        inserted += tm["dim16/idmap_inserted"]
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(st["tmap"], f)[0].numpy(),
                                          np.asarray(getattr(st["jmap"], f))[0], err_msg=f)
        for k in ("ids", "last_use"):
            np.testing.assert_array_equal(st["trows"][k], st["jrows"][k], err_msg=k)
    assert inserted > 0


def test_train_step_loss_rows_and_params_agree(steps):
    prec, steps = steps
    for i, st in enumerate(steps):
        _close(prec, "loss", {"loss": float(st["to"]["loss"])}, {"loss": float(st["jo"]["loss"])},
               f"step {i}")
        tr, jr = st["trows"], st["jrows"]
        _close(prec, "params", {"emb": tr["emb"]}, {"emb": jr["emb"]}, f"step {i}")
        for k in ("m", "v"):
            _close(prec, "moments", {k: tr["slots"][k]}, {k: jr["slots"][k]}, f"step {i}")
        _close(prec, "params", st["tdense"], st["jdense"], f"step {i}")
        for k in ("m", "v") if prec == "fp32" else ():
            _close(prec, "moments", st["topt"][k], st["jopt"][k], f"step {i} opt {k}")


def test_train_step_moves_rows_and_params(steps):
    """The comparison above is not vacuous: training changed the state."""
    _, steps = steps
    first, last = steps[0], steps[-1]
    assert not np.array_equal(last["trows"]["emb"][: first["trows"]["emb"].shape[0]],
                              first["trows"]["emb"])
    n = next(iter(first["tdense"]))
    assert not torch.equal(first["tdense"][n], last["tdense"][n])


def test_build_train_cell_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_cell("dlrm-mlperf", "train_batch", smoke=True)
