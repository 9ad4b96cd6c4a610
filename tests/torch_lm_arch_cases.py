"""Cases shared by tests/test_torch_granite.py and tests/test_torch_internlm2.py:
one dense LM arch (the importing module's ``ARCH``), JAX package against the
PyTorch port on the CPU at its smoke widths, under MIXED:

  * ``get_config`` gives the reference's fields, for the full config and
    the smoke one;
  * three steps of the ``train_4k`` cell (T 64, batch 2) from the JAX
    cell's dense params and zero moments: integers (engine metrics, every
    IDMap field, the exported ids and last uses) bit-equal, the loss, the
    token rows and the dense params within tests/test_torch_lm.py's
    tolerances;
  * two ``prefill_32k`` requests (T 64, batch 2) over imported rows (every
    7th vocab id left out): metrics bit-equal, the last logits and the KV
    cache within ``MIXED_TOL``;
  * four decode steps (S 72, batch 2) from the first request's cache at
    position 64, the JAX decode cell's whole state loaded into the port's
    (``convert.decode_state_from_numpy``): logits within ``MIXED_TOL``,
    metrics equal, the cache written at the four positions alone;
  * the train driver trains the arch for two steps on the CPU.

The JAX side runs its Pallas flash kernels in interpret mode
(``attn_impl="pallas"``), one module-scoped cell of each kind. Import with
``from torch_lm_arch_cases import *`` after setting ``ARCH``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCell as JShape
from repro.io.ragged import Ragged as JRagged
from repro.launch import lm_cell as j_lm
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.core import idmap as t_idmap
from repro_torch.launch import train as t_train
from repro_torch.launch.cells import build_cell as t_build_cell
from test_torch_lm import MIXED_TOL, TRAIN_STEPS, _adam_close

__all__ = ["train", "prefill", "decode", "test_config_fields_match_reference", "test_train_integers_bit_equal",
           "test_train_loss_rows_and_params_agree", "test_prefill_metrics_bit_equal",
           "test_prefill_logits_and_cache_match_reference", "test_decode_from_the_prefill_cache_matches_reference",
           "test_driver_trains_two_steps"]

T, B = 64, 2
DEC_S, DEC_STEPS = 72, 4
LOSS_ATOL = 5e-3  # tests/test_torch_lm.py: a mean near log 512
JOPTS = JOpts(attn_impl="pallas", remat=True, zero1=False)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rows(engine, cfg, gkey: str) -> dict:
    """Rows for every vocab id but every 7th (those tokens read zero rows)."""
    vocab = jnp.arange(cfg.vocab_size, dtype=jnp.int64)
    ids = np.asarray(engine.engine_ids({"tokens": JRagged(vocab, jnp.array([0, cfg.vocab_size], jnp.int32))})[gkey])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    r = np.random.default_rng(0)
    return {gkey: {"ids": ids, "emb": r.normal(size=(ids.size, cfg.d_model)).astype(np.float32),
                   "slots": {k: np.zeros((ids.size, cfg.d_model), np.float32) for k in ("m", "v")},
                   "last_use": np.ones(ids.size, np.int32)}}


def test_config_fields_match_reference(request):
    """Every field of the port's config as the reference has it: the arch,
    its shapes and source, and each model field the port's
    ``TransformerConfig`` has (the reference's ``scan_layers`` is a
    lowering switch of the JAX package)."""
    arch_id = request.module.ARCH
    for smoke in (False, True):
        j, t = j_get_config(arch_id, smoke=smoke), t_get_config(arch_id, smoke=smoke)
        assert (t.arch_id, t.family, t.source, t.notes) == (j.arch_id, j.family, j.source, j.notes)
        assert [(s.name, s.kind, dict(s.params)) for s in t.shapes] == \
            [(s.name, s.kind, dict(s.params)) for s in j.shapes]
        for f in dataclasses.fields(t.model):
            assert getattr(t.model, f.name) == getattr(j.model, f.name), (smoke, f.name)
        assert t.model.head_dim == j.model.head_dim and t.model.moe is None


@pytest.fixture(scope="module")
def train(request):
    arch_id = request.module.ARCH
    mesh = make_test_mesh()
    shape = {"seq_len": T, "global_batch": B}
    jcell = j_build_cell(arch_id, "train_4k", mesh, JOPTS, smoke=True,
                         shape_override=JShape("train_4k", "train", shape))
    tcell = t_build_cell(arch_id, "train_4k", smoke=True, shape_override=TShape("train_4k", "train", shape),
                         device="cpu")
    tcfg = tcell.arch.model
    jeng, gkey = j_lm._engine_for(jcell.arch.model, mesh, B * T, JOPTS)  # the cell keeps its engine to itself
    out = []
    with mesh:
        jstate, tstate = jcell.init_state(), tcell.init_state()
        tstate["dense"].load_state_dict(convert.transformer_from_numpy(_np_tree(jstate["dense"]), tcfg))
        params0 = {k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}
        jstep = jax.jit(jcell.step_fn)
        for s in range(TRAIN_STEPS):
            jstate, jo = jstep(jstate, jcell.make_batch(s))
            tstate, to = tcell.step_fn(tstate, tcell.make_batch(s))
            out.append(dict(
                jo=_np_tree(jo), to=to, jmap=_np_tree(jstate["sparse"][gkey]["idmap"]),
                tmap=tstate["sparse"][gkey]["idmap"], jrows=jeng.export_rows(jstate["sparse"])[gkey],
                trows=tcell.engine.export_rows(tstate["sparse"])[gkey],
                jdense=convert.transformer_from_numpy(_np_tree(jstate["dense"]), tcfg),
                tdense={k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}))
    return dict(steps=out, gkey=gkey, params0=params0)


def test_train_integers_bit_equal(train):
    inserted = 0
    for st in train["steps"]:
        jm = {k: int(v) for k, v in st["jo"].items() if k != "loss"}
        assert {k: int(v) for k, v in st["to"].items() if k != "loss"} == jm
        inserted += jm[f"{train['gkey']}/idmap_inserted"]
        for f in t_idmap.TENSOR_FIELDS:
            np.testing.assert_array_equal(getattr(st["tmap"], f)[0].numpy(),
                                          np.asarray(getattr(st["jmap"], f))[0], err_msg=f)
        for k in ("ids", "last_use"):
            np.testing.assert_array_equal(st["trows"][k], st["jrows"][k], err_msg=k)
    assert inserted > 0


def test_train_loss_rows_and_params_agree(train):
    """The loss within 5e-3, rows and params within ``_adam_close``; and
    training moved every param from its start."""
    for i, st in enumerate(train["steps"]):
        np.testing.assert_allclose(float(st["to"]["loss"]), float(st["jo"]["loss"]), rtol=0, atol=LOSS_ATOL,
                                   err_msg=f"step {i} loss")
        _adam_close(st["trows"]["emb"], st["jrows"]["emb"], f"step {i} rows")
        _adam_close(np.concatenate([st["tdense"][n].numpy().ravel() for n in st["jdense"]]),
                    np.concatenate([w.numpy().ravel() for w in st["jdense"].values()]), f"step {i} dense")
    last = train["steps"][-1]["tdense"]
    assert all(not torch.equal(last[n], p0) for n, p0 in train["params0"].items())


@pytest.fixture(scope="module")
def prefill(request):
    """Two prefill requests on each side over the same rows and the JAX
    cell's dense params."""
    arch_id = request.module.ARCH
    mesh = make_test_mesh()
    shape = {"seq_len": T, "global_batch": B}
    jcell = j_build_cell(arch_id, "prefill_32k", mesh, JOPTS, smoke=True,
                         shape_override=JShape("prefill_32k", "prefill", shape))
    tcell = t_build_cell(arch_id, "prefill_32k", smoke=True, shape_override=TShape("prefill_32k", "prefill", shape),
                         device="cpu")
    cfg = jcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B * T, JOPTS)
    rows = _rows(jeng, cfg, gkey)
    with mesh:
        jstate = jcell.init_state()
        jstate["sparse"] = jeng.import_rows(rows)
        jstep = jax.jit(jcell.step_fn)
        jout = [_np_tree(jstep(jstate, jcell.make_batch(s))) for s in (0, 1)]
    tstate = tcell.init_state()
    tstate["sparse"] = tcell.engine.import_rows(rows)
    tstate["dense"].load_state_dict(convert.transformer_from_numpy(_np_tree(jstate["dense"]), tcell.arch.model))
    tout = [tcell.step_fn(tstate, tcell.make_batch(s)) for s in (0, 1)]
    return dict(jout=jout, tout=tout, rows=rows, gkey=gkey, cfg=tcell.arch.model, arch_id=arch_id)


def test_prefill_metrics_bit_equal(prefill):
    for jo, to in zip(prefill["jout"], prefill["tout"]):
        jm = {k: int(v) for k, v in jo.items() if "/" in k}
        assert {k: int(v) for k, v in to.items() if "/" in k} == jm
        assert jm[f"{prefill['gkey']}/dev_rows_live"] == prefill["rows"][prefill["gkey"]]["ids"].size


def test_prefill_logits_and_cache_match_reference(prefill):
    cfg = prefill["cfg"]
    for jo, to in zip(prefill["jout"], prefill["tout"]):
        assert to["logits"].shape == (B, cfg.vocab_size) and to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy(), jo["logits"], **MIXED_TOL)
        for k in ("cache_k", "cache_v"):
            assert to[k].shape == (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim) and to[k].dtype == torch.bfloat16
            np.testing.assert_allclose(to[k].float().numpy(), jo[k].astype(np.float32), **MIXED_TOL)


@pytest.fixture(scope="module")
def decode(prefill):
    """The JAX decode cell (S 72, batch 2) with the prefill's rows and the
    first request's cache in positions [0, 64), ``pos`` 64; the port's
    cell takes that whole state; four steps on each side."""
    mesh = make_test_mesh()
    params = {"seq_len": DEC_S, "global_batch": B}
    jcell = j_build_cell(prefill["arch_id"], "decode_32k", mesh, JOPTS, smoke=True,
                         shape_override=JShape("decode_32k", "decode", params))
    tcell = t_build_cell(prefill["arch_id"], "decode_32k", smoke=True,
                         shape_override=TShape("decode_32k", "decode", params), device="cpu")
    cfg = jcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B, JOPTS)
    with mesh:
        jst = jcell.init_state()
        jst["sparse"] = jeng.import_rows(prefill["rows"])
        first = prefill["jout"][0]
        jst["cache"] = {k: jnp.zeros_like(jst["cache"][k]).at[:, :, :T].set(jnp.asarray(first[f"cache_{k}"]))
                        for k in ("k", "v")}
        jst["pos"] = jnp.int32(T)
        init = _np_tree(jst)
        tst = convert.decode_state_from_numpy(init, tcell.init_state())
        jstep = jax.jit(jcell.step_fn)
        jo, to = [], []
        for s in range(DEC_STEPS):
            jst, o = jstep(jst, jcell.make_batch(s))
            jo.append(_np_tree(o))
            tst, o = tcell.step_fn(tst, tcell.make_batch(s))
            to.append(o)
    return dict(jout=jo, tout=to, init=init, jfinal=_np_tree(jst), tfinal=tst, cfg=tcell.arch.model)


def test_decode_from_the_prefill_cache_matches_reference(decode):
    cfg = decode["cfg"]
    for jo, to in zip(decode["jout"], decode["tout"]):
        assert to["logits"].shape == (B, cfg.vocab_size) and bool(torch.isfinite(to["logits"]).all())
        np.testing.assert_allclose(to["logits"].numpy(), jo["logits"], **MIXED_TOL)
        assert {k: int(v) for k, v in to.items() if "/" in k} == {k: int(v) for k, v in jo.items() if "/" in k}
    assert int(decode["tfinal"]["pos"]) == int(decode["jfinal"]["pos"]) == T + DEC_STEPS
    written = np.zeros(DEC_S, bool)
    written[T:T + DEC_STEPS] = True
    for k in ("k", "v"):
        got = decode["tfinal"]["cache"][k].float().numpy()
        want, before = decode["jfinal"]["cache"][k].astype(np.float32), decode["init"]["cache"][k].astype(np.float32)
        np.testing.assert_array_equal(got[:, :, ~written], before[:, :, ~written])
        np.testing.assert_array_equal(want[:, :, ~written], before[:, :, ~written])
        np.testing.assert_allclose(got[:, :, written], want[:, :, written], **MIXED_TOL)
        assert np.abs(got[:, :, written]).max() > 0


def test_driver_trains_two_steps(request):
    """``python -m repro_torch.launch.train --arch <arch> --device cpu``
    trains 2 smoke steps, each loss the cell's own on the same batch from
    the same fresh state."""
    arch_id = request.module.ARCH
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
    assert all(np.isfinite(got)) and got == want
