"""The recsys models of the PyTorch port against the JAX package's on the
CPU: Wide & Deep, SASRec, MIND and DLRM's ``apply``, ``loss`` (with its
gradients) and ``score_candidates`` on one converted param tree and the
same numpy activations; the layers and losses they add; MIND's fixed
routing draw."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro.models.recsys import common as j_common
from repro.models.recsys import dlrm as j_dlrm, mind as j_mind, sasrec as j_sasrec, wide_deep as j_wd
from repro_torch.configs import get_config
from repro_torch.convert import params_from_tree, params_to_tree
from repro_torch.models import layers as t_layers
from repro_torch.models.recsys import common as t_common
from repro_torch.models.recsys import dlrm as t_dlrm, mind as t_mind, sasrec as t_sasrec, wide_deep as t_wd

B, NC = 16, 48
MODS = {"wide-deep": (j_wd, t_wd), "sasrec": (j_sasrec, t_sasrec), "mind": (j_mind, t_mind),
        "dlrm-mlperf": (j_dlrm, t_dlrm)}
# bf16 compute (MIXED): each framework rounds matmul sums, bias adds and the
# LayerNorm outputs at other places; a bf16 ulp is 2^-8 of the value, and a
# logit passes through up to 5 bf16 roundings (SASRec: 1 block of LN, q·k,
# softmax·v, two FF layers, the final LN). The tolerance allows a few ulps
# of the logits' magnitude (|x| < 2 here).
MIXED_TOL = dict(rtol=3e-2, atol=3e-2)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch: str):
    return get_config(arch, smoke=True).model


def _acts(arch: str, cfg, b: int, seed: int) -> tuple[dict, dict]:
    """Pooled activations and dense columns of a batch of ``b`` rows, as
    numpy: sequences with a zero tail, and for SASRec (``b`` > 1) a row
    whose first position is missing and a row with no history at all."""
    r = np.random.default_rng(seed)

    def normal(*shape):
        return r.normal(scale=0.5, size=shape).astype(np.float32)

    if arch in ("wide-deep", "dlrm-mlperf"):
        acts = {f"cat_{i}": normal(b, cfg.embed_dim) for i in range(cfg.n_sparse)}
        if arch == "wide-deep":
            acts.update({f"wide_{i}": normal(b, cfg.wide_dim) for i in range(cfg.n_sparse)})
        dense = {"label": (r.random((b, 1)) < 0.5).astype(np.float32)}
        if arch == "dlrm-mlperf":
            dense["dense"] = normal(b, cfg.n_dense)
        return acts, dense
    t, d = cfg.seq_len, cfg.embed_dim
    hist = normal(b, t, d)
    lens = r.integers(1, t + 1, b)
    hist[np.arange(t)[None, :] >= lens[:, None]] = 0.0
    if arch == "sasrec" and b > 1:
        hist[0, 0] = 0.0        # a missing id at the first position
        hist[1] = 0.0           # no history at all
        return {"hist_items": hist, "pos_items": normal(b, t, d),
                "neg_items": normal(b, t * cfg.n_neg, d)}, {}
    return {"hist_items": hist, "target_item": normal(b, d), "neg_items": normal(b, cfg.n_neg, d)}, {}


def _cand(arch: str, cfg, seed: int) -> dict:
    r = np.random.default_rng(seed)
    out = {"cand_rows": r.normal(scale=0.5, size=(NC, cfg.embed_dim)).astype(np.float32)}
    if arch == "wide-deep":
        out["cand_wide"] = r.normal(scale=0.5, size=(NC, cfg.wide_dim)).astype(np.float32)
    return out


def _models(arch: str, seed: int = 3):
    jm, tm = MODS[arch]
    cfg = _cfg(arch)
    jcfg = getattr(jm, type(cfg).__name__)(**dataclasses.asdict(cfg))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jcfg))
    model = tm.init(cfg, device="cpu")
    model.load_state_dict(params_from_tree(model, params))
    return jm, tm, jcfg, cfg, params, model


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in tree.items()}


PRECS = {"fp32": (j_layers.FP32, t_layers.FP32, FP32_TOL), "mixed": (j_layers.MIXED, t_layers.MIXED, MIXED_TOL)}


@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("arch", list(MODS))
def test_apply_and_loss_agree(arch, prec):
    jm, tm, jcfg, cfg, params, model = _models(arch)
    jp, tp, tol = PRECS[prec]
    acts, dense = _acts(arch, cfg, B, seed=1)
    jl = jm.apply(params, jcfg, _j(acts), _j(dense), jp)
    tl = tm.apply(model, cfg, _t(acts), _t(dense), tp)
    assert tl.dtype == torch.float32 and tl.shape == (B,)
    assert bool(torch.isfinite(tl).all())
    # SASRec's row 0 misses its first id: its mask is no prefix, where the
    # port reads another position than the reference (ROADMAP C6; held in
    # test_sasrec_user_repr_reads_the_last_valid_position)
    rows = slice(1, None) if arch == "sasrec" else slice(None)
    np.testing.assert_allclose(tl.detach().numpy()[rows], np.asarray(jl)[rows], **tol)
    jv = jm.loss(params, jcfg, _j(acts), _j(dense), jp)
    tv = tm.loss(model, cfg, _t(acts), _t(dense), tp)
    np.testing.assert_allclose(tv.item(), float(jv), **tol)


@pytest.mark.parametrize("arch", list(MODS))
def test_fp32_loss_gradients_agree(arch):
    """The loss's gradient in every dense param (under the reference's key
    path) and in every activation, FP32."""
    jm, tm, jcfg, cfg, params, model = _models(arch)
    acts, dense = _acts(arch, cfg, B, seed=2)
    jg_p, jg_a = jax.grad(lambda p, a: jm.loss(p, jcfg, a, _j(dense), j_layers.FP32), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), _j(acts))
    t_acts = {k: v.requires_grad_() for k, v in _t(acts).items()}
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(tm.loss(model, cfg, t_acts, _t(dense), t_layers.FP32),
                                [*model.parameters(), *t_acts.values()])
    want = params_from_tree(model, jax.tree.map(np.asarray, jg_p))
    assert set(want) == set(names)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n, **FP32_TOL)
    for k, g in zip(t_acts, grads[len(names):]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_a[k]), err_msg=k, **FP32_TOL)
    assert max(float(g.abs().max()) for g in grads[:len(names)]) > 0


@pytest.mark.parametrize("prec", list(PRECS))
@pytest.mark.parametrize("arch", list(MODS))
def test_score_candidates_agree(arch, prec):
    jm, tm, jcfg, cfg, params, model = _models(arch)
    jp, tp, tol = PRECS[prec]
    acts, dense = _acts(arch, cfg, 1, seed=4)
    cand = _cand(arch, cfg, seed=5)
    js = jm.score_candidates(params, jcfg, _j(acts), _j(dense), *map(jnp.asarray, cand.values()), prec=jp)
    ts = tm.score_candidates(model, cfg, _t(acts), _t(dense), *map(torch.from_numpy, cand.values()), prec=tp)
    assert ts.dtype == torch.float32 and ts.shape == (NC,)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **tol)
    assert np.unique(ts.detach().numpy()).size > NC // 2


def test_sasrec_masked_positions_give_no_nan():
    """A row whose first position is masked (every key a query there may
    see is masked: a uniform row, not NaN) and a row with no history."""
    jm, tm, jcfg, cfg, params, model = _models("sasrec")
    acts, _ = _acts("sasrec", cfg, B, seed=6)
    hist = torch.from_numpy(acts["hist_items"])
    mask = torch.any(hist != 0.0, dim=-1)
    assert not mask[0, 0] and not mask[1].any()
    h = model.encode(hist, mask, t_layers.FP32)
    jh = j_sasrec.encode(params, jcfg, jnp.asarray(acts["hist_items"]), jnp.asarray(mask.numpy()), j_layers.FP32)
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **FP32_TOL)
    u = model.user_repr(_t(acts), t_layers.FP32)
    assert bool(torch.isfinite(u).all())


def test_sasrec_user_repr_reads_the_last_valid_position():
    """ROADMAP C6, repaired in the port. Row 0's history of 8 has no row for
    its 7th id (mask 1111_1101): the reference reads position
    count(mask) - 1 = 6, a masked one, so its user vector is
    final_ln(0) = 0; the port reads position 7, the last valid one. Row 1's
    mask is a prefix (1111_1000): both read position 4, and the port's
    vector is bit for bit its hidden state there, as before the repair."""
    jm, tm, jcfg, cfg, params, model = _models("sasrec")
    assert cfg.seq_len == 8
    acts, _ = _acts("sasrec", cfg, 2, seed=7)
    hist = acts["hist_items"]
    hist[:] = np.random.default_rng(8).normal(scale=0.5, size=hist.shape).astype(np.float32)
    hist[0, 6] = 0.0
    hist[1, 5:] = 0.0
    mask = np.any(hist != 0.0, axis=-1)
    assert mask[0].tolist() == [1, 1, 1, 1, 1, 1, 0, 1] and mask[1].tolist() == [1] * 5 + [0] * 3
    jh = np.asarray(j_sasrec.encode(params, jcfg, jnp.asarray(hist), jnp.asarray(mask), j_layers.FP32))
    ju = np.asarray(j_sasrec.user_repr(params, jcfg, _j(acts), j_layers.FP32))
    tu = model.user_repr(_t(acts), t_layers.FP32).detach().numpy()
    th = model.encode(torch.from_numpy(hist), torch.from_numpy(mask), t_layers.FP32).detach().numpy()
    np.testing.assert_array_equal(ju[0], jh[0, 6])                     # the reference: position 6
    assert not ju[0].any()                                             # ... a zero user vector
    np.testing.assert_allclose(tu[0], jh[0, 7], **FP32_TOL)            # the port: position 7
    assert np.abs(tu[0]).max() > 0.1
    np.testing.assert_array_equal(tu[1], th[1, 4])                     # a prefix: position 4 in both
    np.testing.assert_allclose(tu[1], ju[1], **FP32_TOL)


@pytest.mark.parametrize("shape", [(4, 50), (2, 8), (3, 7), (5, 123)])
def test_mind_routing_draw(shape):
    """The fixed routing logits against ``jax.random.normal(PRNGKey(17))``:
    the threefry bits are the reference's, and the erfinv polynomial within
    2e-6 (a few float32 ulps: XLA's log1p and fused steps round otherwise)."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(17), shape, jnp.float32))
    got = t_mind.routing_init(*shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    want_u = np.asarray(jax.random.uniform(jax.random.PRNGKey(17), shape, jnp.float32, lo, 1.0))
    np.testing.assert_allclose(t_mind._erfinv_f32(want_u) * np.float32(np.sqrt(2)), want, rtol=0, atol=2e-6)
    # the threefry words: the reference's bits, bit for bit
    k, t = shape
    idx = np.arange(k * t, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = t_mind._threefry2x32(0, 17, (idx >> np.uint64(32)).astype(np.uint32),
                                      (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(17), shape, jnp.uint32)).reshape(-1)
    np.testing.assert_array_equal(b0 ^ b1, bits)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_agrees(dtype):
    r = np.random.default_rng(7)
    x = (r.normal(size=(6, 5, 50)) * 3 + 1).astype(np.float32)
    p = {"scale": r.normal(size=50).astype(np.float32), "bias": r.normal(size=50).astype(np.float32)}
    ln = t_layers.LayerNorm(50)
    ln.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got = ln(tx)
    want = j_layers.layernorm_apply(_j(p), jx)
    assert got.dtype == tx.dtype
    tol = FP32_TOL if dtype == "fp32" else dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of the output
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    fresh = t_layers.LayerNorm(50)
    np.testing.assert_array_equal(fresh.scale.detach().numpy(), np.asarray(j_layers.make_layernorm(50)["scale"]))
    np.testing.assert_array_equal(fresh.bias.detach().numpy(), np.asarray(j_layers.make_layernorm(50)["bias"]))


def test_embedding_agrees():
    table = np.random.default_rng(8).normal(size=(20, 6)).astype(np.float32)
    emb = t_layers.Embedding(20, 6, torch.Generator().manual_seed(0))
    assert emb.table.shape == (20, 6) and float(emb.table.std()) < 0.1  # N(0, 0.02²)
    emb.load_state_dict({"table": torch.from_numpy(table)})
    ids = np.array([0, 3, 19, 3, 7])
    for jp, tp in ((j_layers.FP32, t_layers.FP32), (j_layers.MIXED, t_layers.MIXED)):
        want = j_layers.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(ids), jp)
        got = emb(torch.from_numpy(ids), tp)
        assert got.dtype == tp.compute_dtype
        np.testing.assert_array_equal(got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)))


def test_sampled_softmax_loss_agrees():
    r = np.random.default_rng(9)
    pos, neg = (r.normal(size=(32,)) * 4).astype(np.float32), (r.normal(size=(32, 5)) * 4).astype(np.float32)
    want = j_common.sampled_softmax_loss(jnp.asarray(pos), jnp.asarray(neg))
    got = t_common.sampled_softmax_loss(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_allclose(float(got), float(want), **FP32_TOL)
    big = t_common.sampled_softmax_loss(torch.tensor([1e4]), torch.tensor([[-1e4, 0.0]]))
    assert float(big) == 0.0  # no overflow in the logsumexp


@pytest.mark.parametrize("arch", ["wide-deep", "sasrec", "mind"])
def test_param_tree_round_trips_under_reference_paths(arch):
    """``params_to_tree`` gives the reference's tree (key paths, shapes),
    and ``params_from_tree`` takes it back."""
    jm, tm, jcfg, cfg, params, model = _models(arch)
    tree = params_to_tree(model, model.state_dict())
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): v.detach().numpy()
           for p, v in jax.tree_util.tree_leaves_with_path(tree, is_leaf=torch.is_tensor)}
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = params_from_tree(model, tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("arch,extra", [("wide-deep", ("deep", "l2")), ("sasrec", ("block1",)),
                                        ("mind", ("out2",)), ("dlrm-mlperf", ("top", "l3"))])
def test_param_tree_with_an_extra_layer_is_refused(arch, extra):
    """A reference tree one layer deeper than the model (the first layers
    fitting) does not load truncated: ``params_from_tree`` names the leaves
    no parameter takes."""
    _, _, _, _, params, model = _models(arch)
    tree = jax.tree.map(np.copy, params)
    node = tree
    for part in extra[:-1]:
        node = node[part]
    node[extra[-1]] = {"w": np.zeros((4, 4), np.float32), "b": np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match="/".join(extra) + "/w"):
        params_from_tree(model, tree)
