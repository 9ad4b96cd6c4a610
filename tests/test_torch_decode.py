"""LM decode, JAX package against the PyTorch port on the CPU: the
single-token attention over a KV cache and its module apply (GQA, MHA and
MQA; the new token at position 0, mid-cache and at the cache's last
position), one decode step of the smoke stack, the serving invariant
(teacher-forced decode over a prompt equals the prefill's logits), and
three steps of the qwen2.5 smoke ``decode_32k`` and ``long_500k`` cells
(sizes cut) from a fresh state and from a filled cache whose last three
positions the steps write. Both packages take the same numpy inputs; the
port's cells get the JAX cell's state through
``convert.decode_state_from_numpy``.

Tolerances: FP32 within 1e-5; MIXED within ``MIXED_TOL`` of
tests/test_torch_lm.py (bf16 products round their sums once in each
framework, at other points of the stack). The cache is bf16 in both
precisions: the positions a step writes hold the new token's K and V, each
computed in each framework and rounded to bf16: fp32 values either side of
a rounding boundary land one bf16 ulp apart (at most 2^-7 of the value), so
they are held within that in FP32 and within ``MIXED_TOL`` in MIXED; every
other position is bit-equal."""
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
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tfm
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import transformer_from_numpy
from repro_torch.launch import lm_cell as t_lm
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tfm
from test_torch_lm import MIXED_TOL

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ROUNDING = dict(rtol=2.0 ** -7, atol=1e-6)  # one bf16 ulp
PRECS = {"fp32": (j_layers.FP32, t_layers.FP32), "mixed": (j_layers.MIXED, t_layers.MIXED)}
TOLS = {"fp32": FP32_TOL, "mixed": MIXED_TOL}
WRITTEN_TOLS = {"fp32": BF16_ROUNDING, "mixed": MIXED_TOL}
B, S, HD = 2, 32, 16
LAYOUTS = {"gqa": (4, 2), "mha": (4, 4), "mqa": (4, 1)}  # (H, Hk)
POSITIONS = {"first": 0, "mid": 13, "last": S - 1}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """Values that bf16 holds exactly (both packages store the cache so)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _cache(r, b: int, s: int, hk: int, hd: int, layers: int | None = None) -> np.ndarray:
    shape = (b, s, hk, hd) if layers is None else (layers, b, s, hk, hd)
    return _bf16_np(r.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("where", POSITIONS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("prec", PRECS)
def test_decode_attention_matches_reference(prec, layout, where):
    h, hk = LAYOUTS[layout]
    r = np.random.default_rng(h * 10 + hk)
    q = r.normal(size=(B, 1, h, HD)).astype(np.float32)
    k, v = _cache(r, B, S, hk, HD), _cache(r, B, S, hk, HD)
    pos = POSITIONS[where]
    jprec, tprec = PRECS[prec]
    jq = jnp.asarray(q, jprec.compute_dtype)
    want = _np(j_attn.decode_attention(jq, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                                       jnp.int32(pos), None, jprec))
    tq = torch.from_numpy(q).to(tprec.compute_dtype)
    got = t_attn.decode_attention(tq, torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16),
                                  torch.tensor(pos, dtype=torch.int32), None, tprec)
    assert got.shape == (B, 1, h * HD) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[prec])


def _attention_pair(h: int, hk: int, seed: int):
    """The reference's attention params (QKV bias made non-zero) and the
    port's module holding them."""
    cfg = j_attn.AttnConfig(d_model=64, n_heads=h, n_kv_heads=hk, qkv_bias=True)
    r = np.random.default_rng(seed)
    p = j_attn.make_attn(jax.random.PRNGKey(seed), cfg)
    p = {k: {**v, **({"b": jnp.asarray(r.normal(size=v["b"].shape).astype(np.float32) * 0.1)}
                     if "b" in v else {})} for k, v in p.items()}
    mod = t_attn.Attention(t_attn.AttnConfig(d_model=64, n_heads=h, n_kv_heads=hk, qkv_bias=True),
                           torch.Generator().manual_seed(0))
    sd = {}
    for k, v in p.items():
        sd[f"{k}.weight"] = torch.from_numpy(np.asarray(v["w"]).T.copy())
        if "b" in v:
            sd[f"{k}.bias"] = torch.from_numpy(np.asarray(v["b"]))
    mod.load_state_dict(sd)
    return cfg, p, mod


def _cache_close(got: torch.Tensor, want: np.ndarray, before: np.ndarray, pos_axis: int, written, tol) -> None:
    """Positions ``written`` (along ``pos_axis``) within ``tol`` of the
    reference's; every other position bit-equal to it and to ``before``."""
    g = got.float().numpy()
    mask = np.zeros(g.shape[pos_axis], bool)
    mask[list(written)] = True
    keep, new = np.compress(~mask, g, pos_axis), np.compress(mask, g, pos_axis)
    np.testing.assert_array_equal(keep, np.compress(~mask, want, pos_axis))
    np.testing.assert_array_equal(keep, np.compress(~mask, before, pos_axis))
    np.testing.assert_allclose(new, np.compress(mask, want, pos_axis), **tol)
    assert not np.array_equal(new, np.compress(mask, before, pos_axis)), "nothing was written"


@pytest.mark.parametrize("where", POSITIONS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("prec", PRECS)
def test_attn_decode_apply_matches_reference(prec, layout, where):
    """The module apply: the output, and the caches written at ``pos``
    alone, in place."""
    h, hk = LAYOUTS[layout]
    cfg, p, mod = _attention_pair(h, hk, seed=h + 7 * hk)
    r = np.random.default_rng(3)
    x = r.normal(size=(B, 1, 64)).astype(np.float32)
    k, v = _cache(r, B, S, hk, cfg.head_dim), _cache(r, B, S, hk, cfg.head_dim)
    pos = POSITIONS[where]
    jprec, tprec = PRECS[prec]
    jout, jk, jv = j_attn.attn_decode_apply(p, cfg, jnp.asarray(x, jprec.compute_dtype), jnp.asarray(k, jnp.bfloat16),
                                            jnp.asarray(v, jnp.bfloat16), jnp.int32(pos), None, jprec)
    tk, tv = torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)
    with torch.no_grad():
        tout = t_attn.attn_decode_apply(mod, torch.from_numpy(x).to(tprec.compute_dtype), tk, tv,
                                        torch.tensor(pos, dtype=torch.int32), None, tprec)
    np.testing.assert_allclose(tout.float().numpy(), _np(jout), **TOLS[prec])
    for got, want, before in ((tk, jk, k), (tv, jv, v)):
        _cache_close(got, _np(want), before, 1, [pos], WRITTEN_TOLS[prec])


def _smoke_cfgs():
    return j_get_config("qwen2.5-3b", smoke=True).model, t_get_config("qwen2.5-3b", smoke=True).model


def _transformer(jparams, tcfg):
    model = t_tfm.init(tcfg)
    model.load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return model


@pytest.mark.parametrize("prec", PRECS)
def test_decode_step_matches_reference(prec):
    """One token through the 2-layer smoke stack over a filled cache: the
    fp32 logits, and every layer's caches written at ``pos`` alone."""
    jcfg, tcfg = _smoke_cfgs()
    jparams = j_tfm.init(jax.random.PRNGKey(1), jcfg)
    r = np.random.default_rng(4)
    x = r.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    L, hk, hd, pos = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, 21
    k, v = _cache(r, B, S, hk, hd, L), _cache(r, B, S, hk, hd, L)
    jprec, tprec = PRECS[prec]
    jlogits, jcache = j_tfm.decode_step(jparams, jcfg, jnp.asarray(x),
                                        {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16)},
                                        jnp.int32(pos), j_tfm.MeshCtx(), jprec)
    tcache = {"k": torch.from_numpy(k).to(torch.bfloat16), "v": torch.from_numpy(v).to(torch.bfloat16)}
    with torch.no_grad():
        tlogits = t_tfm.decode_step(_transformer(jparams, tcfg), torch.from_numpy(x), tcache,
                                    torch.tensor(pos, dtype=torch.int32), None, tprec)
    assert tlogits.shape == (B, tcfg.vocab_size) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOLS[prec])
    for name, before in (("k", k), ("v", v)):
        _cache_close(tcache[name], _np(jcache[name]), before, 2, [pos], WRITTEN_TOLS[prec])


def test_init_cache_layout():
    _, tcfg = _smoke_cfgs()
    c = t_tfm.init_cache(tcfg, 3, 40)
    jc = j_tfm.init_cache(_smoke_cfgs()[0], 3, 40)
    for k in ("k", "v"):
        assert tuple(c[k].shape) == jc[k].shape and c[k].dtype == torch.bfloat16 and not c[k].any()


def test_decode_over_a_prompt_equals_prefill():
    """The serving invariant (tests/test_models.py:139-163): teacher-forced
    decode over a prompt, one token at a time into a bf16 cache, gives the
    prefill's logits at every position, FP32 within 5e-3."""
    _, tcfg = _smoke_cfgs()
    model = t_tfm.init(tcfg, seed=2)
    r = np.random.default_rng(8)
    b, t = 2, 12
    x = torch.from_numpy((r.normal(size=(b, t, tcfg.d_model)) * 0.5).astype(np.float32))
    with torch.no_grad():
        h, _, _ = t_tfm.apply(model, x, t_layers.FP32)
        full = t_layers.dense_apply(model.head, h, t_layers.FP32)
        cache = t_tfm.init_cache(tcfg, b, t)
        dec = torch.stack([t_tfm.decode_step(model, x[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32),
                                             None, t_layers.FP32) for i in range(t)], 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3, atol=5e-3)
    assert float((dec[:, 1:] - full[:, :-1]).abs().max()) > 5e-2  # the check tells positions apart


def test_decode_step_copies_no_cache_sized_tensor():
    """Under MIXED (the serving precision) no op of a decode step makes a
    tensor along the cache's sequence as large as one kv head's slice of a
    layer's cache: the cache is read in place (no expanded kv heads, no
    contiguous copy) and written in place."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg = _smoke_cfgs()
    model = t_tfm.init(tcfg, seed=1)
    b, s = 2, 256  # s appears in no other shape of the smoke stack
    cache = t_tfm.init_cache(tcfg, b, s)
    own = {c.untyped_storage().data_ptr() for c in cache.values()}
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if (torch.is_tensor(t) and s in t.shape and t.numel() >= b * s * tcfg.head_dim
                        and t.untyped_storage().data_ptr() not in own):
                    seen.append((str(func), tuple(t.shape)))
            return out

    with torch.no_grad(), Watch():
        logits = t_tfm.decode_step(model, torch.randn(b, 1, tcfg.d_model), cache, torch.tensor(5, dtype=torch.int32))
    assert logits.shape == (b, tcfg.vocab_size) and not seen, seen


# ------------------------------------------------------------------- cells

CELLS = {"decode_32k": {"seq_len": 128, "global_batch": 4},
         "long_500k": {"seq_len": 256, "global_batch": 1, "long_context": True}}
STARTS = ("fresh", "filled")
STEPS = 3


def _rows(engine, cfg, gkey: str, seed: int) -> dict:
    """Rows for every 7th vocab id left out (those tokens read as zero rows)."""
    vocab = jnp.arange(cfg.vocab_size, dtype=jnp.int64)
    ids = np.asarray(engine.engine_ids({"tokens": JRagged(vocab, jnp.array([0, cfg.vocab_size], jnp.int32))})[gkey])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    r = np.random.default_rng(seed)
    return {gkey: {"ids": ids, "emb": r.normal(size=(ids.size, cfg.d_model)).astype(np.float32),
                   "slots": {k: np.zeros((ids.size, cfg.d_model), np.float32) for k in ("m", "v")},
                   "last_use": np.ones(ids.size, np.int32)}}


@pytest.fixture(scope="module")
def cells():
    """The JAX decode cells (one device) and the port's, in FP32 and MIXED,
    three steps from each start: a fresh state (pos 0, a zero cache) and a
    cache filled with random bf16 values at pos S - 3, both over imported
    rows; the port takes the JAX cell's whole initial state."""
    mesh = make_test_mesh()
    out = {}
    for name, params in CELLS.items():
        jcell = j_build_cell("qwen2.5-3b", name, mesh, JOpts(), smoke=True,
                             shape_override=JShape(name, "decode", params))
        tcell = t_build_cell("qwen2.5-3b", name, smoke=True, shape_override=TShape(name, "decode", params),
                             device="cpu")
        cfg = jcell.arch.model
        jeng, gkey = j_lm._engine_for(cfg, mesh, params["global_batch"], JOpts())
        S_ = params["seq_len"]
        for prec in PRECS:
            j_lm.MIXED, t_lm.MIXED = PRECS[prec]
            try:
                with mesh:
                    jstep = jax.jit(jcell.step_fn)
                    for start in STARTS:
                        jst = jcell.init_state()
                        jst["sparse"] = jeng.import_rows(_rows(jeng, cfg, gkey, seed=len(name)))
                        if start == "filled":
                            r = np.random.default_rng(11)
                            shp = jst["cache"]["k"].shape
                            jst["cache"] = {k: jnp.asarray(r.normal(size=shp).astype(np.float32), jnp.bfloat16)
                                            for k in ("k", "v")}
                            jst["pos"] = jnp.int32(S_ - STEPS)
                        init = jax.tree.map(np.asarray, jst)
                        tst = convert.decode_state_from_numpy(init, tcell.init_state(),
                                                              long_context=bool(params.get("long_context")))
                        jo, to = [], []
                        for s in range(STEPS):
                            jst, o = jstep(jst, jcell.make_batch(s))
                            jo.append(jax.tree.map(np.asarray, o))
                            tst, o = tcell.step_fn(tst, tcell.make_batch(s))
                            to.append(o)
                        out[name, prec, start] = dict(
                            jout=jo, tout=to, init=init, jfinal=jax.tree.map(np.asarray, jst), tfinal=tst,
                            jcell=jcell, tcell=tcell)
            finally:
                j_lm.MIXED, t_lm.MIXED = j_layers.MIXED, t_layers.MIXED
    return out


CASES = [(n, p, s) for n in CELLS for p in PRECS for s in STARTS]


@pytest.mark.parametrize("name", CELLS)
def test_decode_batches_equal(cells, name):
    c = cells[name, "mixed", "fresh"]
    for s in range(STEPS):
        np.testing.assert_array_equal(c["tcell"].make_batch(s).numpy(), np.asarray(c["jcell"].make_batch(s)))


@pytest.mark.parametrize("name,prec,start", CASES)
def test_decode_cell_logits_match_reference(cells, name, prec, start):
    c = cells[name, prec, start]
    cfg = c["tcell"].arch.model
    for jo, to in zip(c["jout"], c["tout"]):
        assert to["logits"].shape == (CELLS[name]["global_batch"], cfg.vocab_size)
        assert to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy(), jo["logits"], **TOLS[prec])


@pytest.mark.parametrize("name,prec,start", CASES)
def test_decode_cell_metrics_equal(cells, name, prec, start):
    c = cells[name, prec, start]
    for jo, to in zip(c["jout"], c["tout"]):
        jm = {k: int(v) for k, v in jo.items() if "/" in k}
        assert {k: int(v) for k, v in to.items() if "/" in k} == jm
        assert jm[f"dim{c['tcell'].arch.model.d_model}/dev_rows_live"] > 0


@pytest.mark.parametrize("name,prec,start", CASES)
def test_decode_cell_cache_and_pos_match_reference(cells, name, prec, start):
    """``pos`` and ``step`` equal; the caches written at the three steps'
    positions alone, in place."""
    c = cells[name, prec, start]
    p0 = int(c["init"]["pos"])
    assert int(c["tfinal"]["pos"]) == int(c["jfinal"]["pos"]) == p0 + STEPS
    assert int(c["tfinal"]["step"]) == int(c["jfinal"]["step"]) == 0
    for k in ("k", "v"):
        _cache_close(c["tfinal"]["cache"][k], c["jfinal"]["cache"][k].astype(np.float32),
                     c["init"]["cache"][k].astype(np.float32), 2, range(p0, p0 + STEPS), WRITTEN_TOLS[prec])
