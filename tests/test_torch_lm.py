"""The LM prefill and train slices, JAX package against the PyTorch port on
the CPU: RoPE, GQA expansion, RMSNorm, SwiGLU, attention, the transformer
stack in FP32, the next-token loss and its gradients in FP32, the qwen2.5
smoke prefill cell and three steps of the smoke train cell under MIXED, on
the same numpy inputs and converted weights. The JAX side runs its Pallas
flash kernels (forward and backward) in interpret mode
(``attn_impl="pallas"``); the port runs the kernels' plain versions, as it
does for every CPU tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeCell as JShape
from repro.launch import lm_cell as j_lm
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.launch.mesh import make_test_mesh
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tfm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import transformer_from_numpy
from repro_torch.kernels.flash_attention import ref as t_fa_ref
from repro_torch.launch import lm_cell as t_lm
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.launch.common import CellOptions as TOpts
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.core import idmap as t_idmap
from repro_torch.models import transformer as t_tfm

T, B, SEEDS = 128, 2, (0, 1)
# MIXED prefill, port against JAX: bf16 matmuls round their sums once in
# each framework, but at other points of the 2-layer stack (bias adds,
# residuals, RoPE's f32 → bf16 cast), so a value may sit a bf16 ulp or two
# apart. |cache| and |logits| stay below 2.5 here, where one ulp is 2^-6;
# the largest differences seen are one cache ulp (0.0156) and 0.0065.
MIXED_TOL = dict(rtol=3e-2, atol=3e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _within_frac(got, want, frac, what):
    """Every element within ``frac`` of the largest magnitude of ``want``."""
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= frac * top, f"{what}: max diff {err} against largest magnitude {top}"


@pytest.mark.parametrize("t,h,hd,theta", [(16, 2, 16, 10000.0), (300, 4, 128, 1e6), (7, 1, 64, 500.0)])
def test_apply_rope_matches_reference(t, h, hd, theta):
    r = np.random.default_rng(t + hd)
    x = r.normal(size=(2, t, h, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t))
    want = _np(j_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = t_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_attn.rope_freqs(hd, theta).numpy(), _np(j_attn.rope_freqs(hd, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("hk,groups", [(2, 2), (1, 8), (4, 1)])
def test_expand_kv_matches_reference(hk, groups):
    x = np.random.default_rng(hk).normal(size=(2, 5, hk, 16)).astype(np.float32)
    want = _np(j_attn._expand_kv(jnp.asarray(x), groups))
    np.testing.assert_array_equal(t_fa_ref.expand_kv(torch.from_numpy(x), groups).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_reference(dtype):
    r = np.random.default_rng(3)
    x = (r.normal(size=(2, 9, 64)) * 3).astype(np.float32)
    scale = r.normal(size=(64,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = _np(j_layers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx))
    norm = t_layers.RMSNorm(64)
    norm.load_state_dict({"scale": torch.from_numpy(scale)})
    got = norm(_t(x, dtype))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2  # bf16: one rounding of the output
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=tol, atol=tol)


def test_swiglu_matches_reference():
    p = j_layers.make_swiglu(jax.random.PRNGKey(1), 32, 80)
    x = np.random.default_rng(4).normal(size=(3, 5, 32)).astype(np.float32)
    want = _np(j_layers.swiglu_apply(p, jnp.asarray(x), j_layers.FP32))
    ffn = t_layers.SwiGLU(32, 80, torch.Generator().manual_seed(0))
    ffn.load_state_dict({f"{k}.weight": _t(np.asarray(v["w"]).T) for k, v in p.items()})
    got = ffn(torch.from_numpy(x), t_layers.FP32).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _smoke_cfgs():
    return j_get_config("qwen2.5-3b", smoke=True).model, t_get_config("qwen2.5-3b", smoke=True).model


def _transformer(jparams, tcfg):
    model = t_tfm.init(tcfg)
    model.load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return model


def test_attn_apply_fp32_matches_reference():
    """One GQA attention block with QKV bias (non-zero here) through the
    Pallas kernel and the port's plain path: 1e-5 of the largest output."""
    jcfg, tcfg = _smoke_cfgs()
    p = j_attn.make_attn(jax.random.PRNGKey(2), jcfg.attn_cfg)
    r = np.random.default_rng(2)
    p = {k: {**v, **({"b": jnp.asarray(r.normal(size=v["b"].shape).astype(np.float32) * 0.1)}
                     if "b" in v else {})} for k, v in p.items()}
    x = r.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    want = _np(j_attn.attn_apply(p, jcfg.attn_cfg, jnp.asarray(x), jnp.asarray(pos), j_layers.FP32,
                                 impl="pallas"))
    mod = t_attn.Attention(tcfg.attn_cfg, torch.Generator().manual_seed(0))
    sd = {}
    for k, v in p.items():
        sd[f"{k}.weight"] = _t(np.asarray(v["w"]).T)
        if "b" in v:
            sd[f"{k}.bias"] = _t(v["b"])
    mod.load_state_dict(sd)
    got = mod(torch.from_numpy(x), torch.from_numpy(pos), t_layers.FP32)[0]
    _within_frac(got.detach().numpy(), want, 1e-5, "attention output")


def test_transformer_apply_fp32_matches_reference():
    """The 2-layer smoke stack in FP32 with the cache collected: hidden
    states and every layer's K (after RoPE) and V within 1e-4 of their
    largest magnitude (two layers of online-softmax attention and fp32
    matmuls summed in another order)."""
    jcfg, tcfg = _smoke_cfgs()
    jparams = j_tfm.init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(5).normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    jh, _, (jk, jv) = j_tfm.apply(jparams, jcfg, jnp.asarray(x), j_tfm.MeshCtx(), j_layers.FP32,
                                  attn_impl="pallas", collect_cache=True)
    with torch.no_grad():
        th, taux, (tk, tv) = t_tfm.apply(_transformer(jparams, tcfg), torch.from_numpy(x), t_layers.FP32,
                                         collect_cache=True)
    L, hk, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    assert tk.shape == tv.shape == (L, B, T, hk, hd) and tk.dtype == torch.float32
    assert float(taux) == 0.0  # no MoE layer
    for got, want, what in [(th, jh, "hidden"), (tk, jk, "cache k"), (tv, jv, "cache v")]:
        _within_frac(got.numpy(), _np(want), 1e-4, what)


def test_transformer_from_numpy_round_trip():
    """Every leaf of the reference tree lands once in the state dict, each
    ``w`` transposed into ``nn.Linear`` layout; a wrong shape raises."""
    jcfg, tcfg = _smoke_cfgs()
    tree = jax.tree.map(np.asarray, j_tfm.init(jax.random.PRNGKey(3), jcfg))
    sd = transformer_from_numpy(tree, tcfg)
    model = t_tfm.init(tcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(v.numel() for v in model.state_dict().values()) == n_leaves
    for i in range(tcfg.n_layers):
        lt = jax.tree.map(lambda x: x[i], tree["layers"])
        layer = model.layers[i]
        np.testing.assert_array_equal(layer.attn.wq.weight.detach().numpy(), lt["attn"]["wq"]["w"].T)
        np.testing.assert_array_equal(layer.attn.wk.bias.detach().numpy(), lt["attn"]["wk"]["b"])
        np.testing.assert_array_equal(layer.ffn.down.weight.detach().numpy(), lt["ffn"]["down"]["w"].T)
        np.testing.assert_array_equal(layer.ffn_norm.scale.detach().numpy(), lt["ffn_norm"]["scale"])
    np.testing.assert_array_equal(model.head.weight.detach().numpy(), tree["head"]["w"].T)
    bad = {**tree, "head": {"w": tree["head"]["w"][:, :-1]}}
    with pytest.raises(ValueError, match="head"):
        transformer_from_numpy(bad, tcfg)


def test_engine_budgets_equal():
    mesh = make_test_mesh()
    jcfg, tcfg = _smoke_cfgs()
    full_j, full_t = j_get_config("qwen2.5-3b").model, t_get_config("qwen2.5-3b").model
    # prefill and train at B·T tokens a step, decode at B: long_500k's 1,
    # decode_32k's 32 (its batch cut from 128) and its smoke batch of 4
    for (jc, tc), L in [((jcfg, tcfg), B * T), ((full_j, full_t), 32_768), ((full_j, full_t), 1),
                        ((full_j, full_t), 32), ((jcfg, tcfg), 4)]:
        jeng, jkey = j_lm._engine_for(jc, mesh, L, JOpts())
        teng, tkey = t_lm._engine_for(tc, L, TOpts(), "cpu")
        assert jkey == tkey
        jg, tg = jeng.groups[jkey], teng.groups[tkey]
        assert (jg.rows_per_shard, jg.map_capacity_per_shard) == (tg.rows_per_shard, tg.map_capacity_per_shard)
        je, te = jg.exchange, tg.exchange
        assert (je.u_budget, je.per_dest_cap, je.recv_budget) == (te.u_budget, te.per_dest_cap, te.recv_budget)
        assert jeng.salts == teng.salts


@pytest.fixture(scope="module")
def prefill():
    """The JAX prefill cell (Pallas attention) and the port's, over one set
    of imported token rows (every 7th vocab id left out: those tokens read
    as zero rows) and the JAX cell's dense params, on two batches."""
    mesh = make_test_mesh()
    shape = {"seq_len": T, "global_batch": B}
    jopts = JOpts(attn_impl="pallas", remat=False, zero1=False)
    jcell = j_build_cell("qwen2.5-3b", "prefill_32k", mesh, jopts, smoke=True,
                         shape_override=JShape("prefill_32k", "prefill", shape))
    tcell = t_build_cell("qwen2.5-3b", "prefill_32k", smoke=True,
                         shape_override=TShape("prefill_32k", "prefill", shape), device="cpu")
    cfg = jcell.arch.model
    # make_prefill_cell keeps its engine to itself; an equal one imports the rows
    jeng, gkey = j_lm._engine_for(cfg, mesh, B * T, jopts)
    from repro.io.ragged import Ragged as JRagged

    vocab = jnp.arange(cfg.vocab_size, dtype=jnp.int64)
    ids = np.asarray(jeng.engine_ids({"tokens": JRagged(vocab, jnp.array([0, cfg.vocab_size], jnp.int32))})[gkey])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    n = ids.size
    r = np.random.default_rng(0)
    rows = {gkey: {"ids": ids, "emb": r.normal(size=(n, cfg.d_model)).astype(np.float32),
                   "slots": {k: np.zeros((n, cfg.d_model), np.float32) for k in ("m", "v")},
                   "last_use": np.ones(n, np.int32)}}
    with mesh:
        jstate = jcell.init_state()
        jstate["sparse"] = jeng.import_rows(rows)
        jstep = jax.jit(jcell.step_fn)
        jout = [jstep(jstate, jcell.make_batch(s)) for s in SEEDS]
        jout = [jax.tree.map(np.asarray, o) for o in jout]
    tstate = tcell.init_state()
    tstate["sparse"] = tcell.engine.import_rows(rows)
    tstate["dense"].load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcell.arch.model))
    tout = [tcell.step_fn(tstate, tcell.make_batch(s)) for s in SEEDS]
    return dict(jcell=jcell, tcell=tcell, jout=jout, tout=tout, n_rows=n)


def test_prefill_batches_equal(prefill):
    for s in SEEDS:
        np.testing.assert_array_equal(prefill["tcell"].make_batch(s).numpy(), np.asarray(prefill["jcell"].make_batch(s)))


def test_prefill_metrics_bit_equal(prefill):
    for jo, to in zip(prefill["jout"], prefill["tout"]):
        jm = {k: int(v) for k, v in jo.items() if "/" in k}
        tm = {k: int(v) for k, v in to.items() if "/" in k}
        assert jm == tm
        assert tm["dim64/dev_rows_live"] == prefill["n_rows"]


def test_prefill_logits_and_cache_match_reference(prefill):
    cfg = prefill["tcell"].arch.model
    for jo, to in zip(prefill["jout"], prefill["tout"]):
        assert to["logits"].shape == (B, cfg.vocab_size) and to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy(), jo["logits"], **MIXED_TOL)
        for k in ("cache_k", "cache_v"):
            assert to[k].shape == (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
            assert to[k].dtype == torch.bfloat16
            np.testing.assert_allclose(to[k].float().numpy(), jo[k].astype(np.float32), **MIXED_TOL)


def test_build_lm_cell_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_cell("qwen2.5-3b", "prefill_32k", smoke=True)


# ------------------------------------------------------------------ training

def test_lm_loss_and_grads_fp32_match_reference():
    """The smoke stack's next-token loss in FP32 and its gradient in every
    dense param and in x_emb, against tfm.lm_loss and jax.grad with the
    Pallas kernels (remat on in both): the loss within 1e-5, each gradient
    within 1e-4 of its largest magnitude (two layers of flash backward and
    fp32 matmuls summed in another order)."""
    jcfg, tcfg = _smoke_cfgs()
    jparams = j_tfm.init(jax.random.PRNGKey(4), jcfg)
    r = np.random.default_rng(6)
    x = r.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    labels = r.integers(0, jcfg.vocab_size, size=(B, T)).astype(np.int32)

    def jloss(p, x):
        return j_tfm.lm_loss(p, jcfg, x, jnp.asarray(labels), j_tfm.MeshCtx(), j_layers.FP32,
                             attn_impl="pallas")[0]

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    model = _transformer(jparams, tcfg)
    tx = torch.from_numpy(x).requires_grad_()
    loss, aux = t_tfm.lm_loss(model, tx, torch.from_numpy(labels), t_layers.FP32)
    assert float(aux) == 0.0  # no MoE
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [*model.parameters(), tx])
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    want = transformer_from_numpy(jax.tree.map(np.asarray, jgp), tcfg)
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        _within_frac(g.numpy(), want[n].numpy(), 1e-4, f"grad {n}")
    _within_frac(grads[-1].numpy(), _np(jgx), 1e-4, "grad x_emb")


def test_remat_recomputes_each_layer_and_keeps_the_gradients(monkeypatch):
    """With remat each layer's attention runs again in the backward, and
    loss and gradients are those of the plain stack: the same CPU
    arithmetic, so equal bit for bit."""
    import dataclasses

    _, tcfg = _smoke_cfgs()
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(size=(B, T, tcfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, tcfg.vocab_size, size=(B, T)))
    calls = {"n": 0}
    fwd = t_fa_ref.flash_fwd

    def counted(*a, **kw):
        calls["n"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(t_fa_ref, "flash_fwd", counted)
    out = {}
    for remat in (True, False):
        model = t_tfm.init(dataclasses.replace(tcfg, remat=remat), seed=3)
        xe = x.clone().requires_grad_()
        calls["n"] = 0
        loss, _ = t_tfm.lm_loss(model, xe, labels, t_layers.FP32)
        grads = torch.autograd.grad(loss, [*model.parameters(), xe])
        out[remat] = (loss, grads, calls["n"])
    assert out[True][2] == 2 * tcfg.n_layers and out[False][2] == tcfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


TRAIN_STEPS, LR = 3, 1e-3  # LR: CellOptions' dense_opt_lr and sparse_opt_lr


@pytest.fixture(scope="module")
def train():
    """The JAX smoke train cell (Pallas attention, remat, no ZeRO-1) and the
    port's, both from a fresh state with the JAX cell's dense params and
    zero AdamW moments, three steps on the same batches under MIXED."""
    mesh = make_test_mesh()
    shape = {"seq_len": T, "global_batch": B}
    jopts = JOpts(attn_impl="pallas", remat=True, zero1=False)
    jcell = j_build_cell("qwen2.5-3b", "train_4k", mesh, jopts, smoke=True,
                         shape_override=JShape("train_4k", "train", shape))
    tcell = t_build_cell("qwen2.5-3b", "train_4k", smoke=True,
                         shape_override=TShape("train_4k", "train", shape), device="cpu")
    cfg, tcfg = jcell.arch.model, tcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B * T, jopts)  # the cell keeps its engine to itself
    out = []
    with mesh:
        jstate = jcell.init_state()
        tstate = tcell.init_state()
        tstate["dense"].load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcfg))
        params0 = {k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}
        jstep = jax.jit(jcell.step_fn)
        for s in range(TRAIN_STEPS):
            jstate, jo = jstep(jstate, jcell.make_batch(s))
            tstate, to = tcell.step_fn(tstate, tcell.make_batch(s))
            out.append(dict(
                jo=jax.tree.map(np.asarray, jo), to=to,
                jmap=jax.tree.map(np.asarray, jstate["sparse"][gkey]["idmap"]),
                tmap=tstate["sparse"][gkey]["idmap"],
                jrows=jeng.export_rows(jstate["sparse"])[gkey],
                trows=tcell.engine.export_rows(tstate["sparse"])[gkey],
                jdense=transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcfg),
                tdense={k: v.detach().clone() for k, v in tstate["dense"].state_dict().items()}))
    return dict(jcell=jcell, tcell=tcell, steps=out, params0=params0, gkey=gkey)


def test_lm_train_batches_equal(train):
    for s in range(TRAIN_STEPS):
        np.testing.assert_array_equal(train["tcell"].make_batch(s).numpy(),
                                      np.asarray(train["jcell"].make_batch(s)))


def test_lm_train_integers_bit_equal(train):
    """Engine metrics, every IDMap field (offsets included) and the
    exported ids and last-use steps after each step."""
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


def _adam_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Params or rows after Adam steps under MIXED. Adam normalises the
    gradient, so where bf16 noise flips the sign of a gradient near 0 the
    two frameworks move that element up to 2 * lr apart in a step: none may
    be more than 2 * lr * steps apart, and at most 2% of them more than
    lr / 10 (0.9% at most after three steps here; an optimizer that moved
    nothing would put nearly all of them lr * steps apart)."""
    d = np.abs(got - want)
    assert d.max() <= 2 * LR * TRAIN_STEPS, f"{what}: max diff {d.max()}"
    frac = float((d > LR / 10).mean())
    assert frac <= 0.02, f"{what}: {frac:.4f} of the elements more than lr / 10 apart"


def test_lm_train_loss_rows_and_params_agree(train):
    """MIXED (bf16 dense compute in both): each framework rounds matmul
    sums, bias adds and the attention's bf16 inputs at other places.
      * loss, a mean near log 512 = 6.2: within 5e-3 (3.2e-4 seen; the
        loss falls by 4e-2 from step 1 to 2);
      * token rows and dense params: ``_adam_close``;
      * the rows' Adam moments: 5e-2 of the largest magnitude, as in
        tests/test_torch_train.py (2.9e-2 seen)."""
    for i, st in enumerate(train["steps"]):
        np.testing.assert_allclose(float(st["to"]["loss"]), float(st["jo"]["loss"]), rtol=0, atol=5e-3,
                                   err_msg=f"step {i} loss")
        tr, jr = st["trows"], st["jrows"]
        _adam_close(tr["emb"], jr["emb"], f"step {i} rows")
        for k in ("m", "v"):
            w = jr["slots"][k]
            np.testing.assert_allclose(tr["slots"][k], w, rtol=0, atol=5e-2 * np.abs(w).max(),
                                       err_msg=f"step {i} rows {k}")
        _adam_close(np.concatenate([st["tdense"][n].numpy().ravel() for n in st["jdense"]]),
                    np.concatenate([w.numpy().ravel() for w in st["jdense"].values()]), f"step {i} dense")


def test_lm_train_moves_rows_and_params(train):
    """The comparison above is not vacuous: the params moved from their
    start, the loss fell, and the rows moved between steps."""
    first, last = train["steps"][0], train["steps"][-1]
    for n, p0 in train["params0"].items():
        assert not torch.equal(last["tdense"][n], p0), n
    n0 = first["trows"]["emb"].shape[0]
    assert not np.array_equal(last["trows"]["emb"][:n0], first["trows"]["emb"])
    assert all(p.requires_grad for p in train["tcell"].init_state()["dense"].parameters())


def test_build_lm_train_cell_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_cell("qwen2.5-3b", "train_4k", smoke=True)
