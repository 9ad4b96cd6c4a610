"""The MoE archs' smoke serve cells, JAX package against the PyTorch port on
the CPU in FP32 and MIXED: ``prefill_32k`` (T 64, batch 2) and
``decode_32k`` (S 64, batch 4; three steps from a fresh state and from a
cache filled with random bf16 values at S - 3) of ``qwen2-moe-a2.7b`` and
``moonshot-v1-16b-a3b``, one JAX cell per arch and kind (jitted once a
precision), over the same imported token rows (every 7th vocab id left
out) and the JAX cell's params. Prefill runs the grouped dispatch, decode
(B·k no more than the experts) the gathered one.

Integers are bit-equal. Logits and caches are held as
tests/test_torch_lm.py and tests/test_torch_decode.py hold them: FP32
logits within 1e-5 and bf16 cache values within one bf16 ulp, MIXED within
``MIXED_TOL``; cache positions no step wrote bit-equal. Under MIXED the
tokens whose top-k sits at a near-tie (``test_torch_moe.RoutingRecorder``)
are left out: the two frameworks' bf16 hidden states lie an ulp or two
apart, which moves a router probability by up to 0.79% of itself, and such
a token then rightly takes another expert in each. They are few (at most
``MAX_TIE_SHARE``); every other value is held."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.io.ragged import Ragged as JRagged
from repro.launch import lm_cell as j_lm
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.common import CellOptions as JOpts
from repro.configs.base import ShapeCell as JShape
from repro.launch.mesh import make_test_mesh
from repro_torch import convert
from repro_torch.configs.base import ShapeCell as TShape
from repro_torch.convert import transformer_from_numpy
from repro_torch.launch.cells import build_cell as t_build_cell
from repro.models import layers as j_layers
from repro_torch.launch import lm_cell as t_lm
from repro_torch.models import layers as t_layers
from test_torch_decode import BF16_ROUNDING, FP32_TOL
from test_torch_lm import MIXED_TOL
from test_torch_moe import MAX_TIE_SHARE, MOE_ARCHS, RoutingRecorder

T, B, B_DEC, STEPS = 64, 2, 4, 3
PREFILL = {"seq_len": T, "global_batch": B}
DECODE = {"seq_len": T, "global_batch": B_DEC}
STARTS = ("fresh", "filled")
SEEDS = (0, 1)
PRECS = {"fp32": (j_layers.FP32, t_layers.FP32), "mixed": (j_layers.MIXED, t_layers.MIXED)}
LOGIT_TOLS = {"fp32": FP32_TOL, "mixed": MIXED_TOL}
CACHE_TOLS = {"fp32": BF16_ROUNDING, "mixed": MIXED_TOL}


def _rows(engine, cfg, gkey: str, seed: int) -> dict:
    """Rows for every vocab id but every 7th (those tokens read as zero rows)."""
    vocab = jnp.arange(cfg.vocab_size, dtype=jnp.int64)
    ids = np.asarray(engine.engine_ids({"tokens": JRagged(vocab, jnp.array([0, cfg.vocab_size], jnp.int32))})[gkey])
    ids = np.delete(ids, np.arange(0, ids.size, 7))
    r = np.random.default_rng(seed)
    return {gkey: {"ids": ids, "emb": r.normal(size=(ids.size, cfg.d_model)).astype(np.float32),
                   "slots": {k: np.zeros((ids.size, cfg.d_model), np.float32) for k in ("m", "v")},
                   "last_use": np.ones(ids.size, np.int32)}}


def _prefill(arch_id: str, mesh, prec: str) -> dict:
    jcell = j_build_cell(arch_id, "prefill_32k", mesh, JOpts(), smoke=True,
                         shape_override=JShape("prefill_32k", "prefill", PREFILL))
    tcell = t_build_cell(arch_id, "prefill_32k", smoke=True, device="cpu",
                         shape_override=TShape("prefill_32k", "prefill", PREFILL))
    cfg = jcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B * T, JOpts())
    rows = _rows(jeng, cfg, gkey, seed=3)
    with mesh:
        jstate = jcell.init_state()
        jstate["sparse"] = jeng.import_rows(rows)
        jstep = jax.jit(jcell.step_fn)
        jout = [jax.tree.map(np.asarray, jstep(jstate, jcell.make_batch(s))) for s in SEEDS]
    tstate = tcell.init_state()
    tstate["sparse"] = tcell.engine.import_rows(rows)
    tstate["dense"].load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jstate["dense"]), tcell.arch.model))
    tout, ties = [], []
    for s in SEEDS:
        with RoutingRecorder() as rec:
            tout.append(tcell.step_fn(tstate, tcell.make_batch(s)))
        ties.append(rec.near_ties(B * T).reshape(B, T) & (prec == "mixed"))
    return dict(jcell=jcell, tcell=tcell, jout=jout, tout=tout, ties=ties, gkey=gkey)


def _decode(arch_id: str, mesh, prec: str) -> dict:
    jcell = j_build_cell(arch_id, "decode_32k", mesh, JOpts(), smoke=True,
                         shape_override=JShape("decode_32k", "decode", DECODE))
    tcell = t_build_cell(arch_id, "decode_32k", smoke=True, device="cpu",
                         shape_override=TShape("decode_32k", "decode", DECODE))
    cfg = jcell.arch.model
    jeng, gkey = j_lm._engine_for(cfg, mesh, B_DEC, JOpts())
    out = {}
    with mesh:
        jstep = jax.jit(jcell.step_fn)
        for start in STARTS:
            jst = jcell.init_state()
            jst["sparse"] = jeng.import_rows(_rows(jeng, cfg, gkey, seed=4))
            if start == "filled":
                shp = jst["cache"]["k"].shape
                r = np.random.default_rng(11)
                jst["cache"] = {k: jnp.asarray(r.normal(size=shp).astype(np.float32), jnp.bfloat16) for k in ("k", "v")}
                jst["pos"] = jnp.int32(T - STEPS)
            init = jax.tree.map(np.asarray, jst)
            tst = convert.decode_state_from_numpy(init, tcell.init_state())
            jo, to, ties = [], [], []
            for s in range(STEPS):
                jst, o = jstep(jst, jcell.make_batch(s))
                jo.append(jax.tree.map(np.asarray, o))
                with RoutingRecorder() as rec:
                    tst, o = tcell.step_fn(tst, tcell.make_batch(s))
                to.append(o)
                ties.append(rec.near_ties(B_DEC) & (prec == "mixed"))
            out[start] = dict(jout=jo, tout=to, ties=ties, init=init, jfinal=jax.tree.map(np.asarray, jst),
                              tfinal=tst)
    return dict(jcell=jcell, tcell=tcell, gkey=gkey, **out)


@pytest.fixture(scope="module")
def cells():
    """(arch, precision) → {"prefill", "decode"}; the cells' MIXED set to
    the precision, as tests/test_torch_decode.py does."""
    mesh = make_test_mesh()
    out = {}
    for prec in PRECS:
        j_lm.MIXED, t_lm.MIXED = PRECS[prec]
        try:
            for a in MOE_ARCHS:
                out[a, prec] = {"prefill": _prefill(a, mesh, prec), "decode": _decode(a, mesh, prec)}
        finally:
            j_lm.MIXED, t_lm.MIXED = j_layers.MIXED, t_layers.MIXED
    return out


CASES = [(a, p) for a in MOE_ARCHS for p in PRECS]


def _ints(o) -> dict:
    return {k: int(v) for k, v in o.items() if "/" in k}


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_batches_equal(cells, arch_id):
    for kind, seeds in (("prefill", SEEDS), ("decode", range(STEPS))):
        c = cells[arch_id, "mixed"][kind]
        for s in seeds:
            np.testing.assert_array_equal(c["tcell"].make_batch(s).numpy(), np.asarray(c["jcell"].make_batch(s)))


@pytest.mark.parametrize("arch_id,prec", CASES)
def test_moe_prefill_metrics_bit_equal(cells, arch_id, prec):
    c = cells[arch_id, prec]["prefill"]
    for jo, to in zip(c["jout"], c["tout"]):
        assert _ints(to) == _ints(jo) and _ints(to)[f"{c['gkey']}/dev_rows_live"] > 0


@pytest.mark.parametrize("arch_id,prec", CASES)
def test_moe_prefill_logits_and_cache_match_reference(cells, arch_id, prec):
    """Every row's last logits, and the caches at every token (MIXED: off a
    near-tie)."""
    c = cells[arch_id, prec]["prefill"]
    cfg = c["tcell"].arch.model
    for jo, to, ties in zip(c["jout"], c["tout"], c["ties"]):
        assert to["logits"].shape == (B, cfg.vocab_size) and to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy(), jo["logits"], **LOGIT_TOLS[prec])
        for k in ("cache_k", "cache_v"):
            assert to[k].shape == (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim) and to[k].dtype == torch.bfloat16
            got, want = to[k].float().numpy(), jo[k].astype(np.float32)
            np.testing.assert_allclose(got[:, ~ties], want[:, ~ties], **CACHE_TOLS[prec], err_msg=k)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_near_ties_are_few(cells, arch_id):
    """Under MIXED at most MAX_TIE_SHARE of the tokens are left out: of each
    prefill request's, and of the decode rows over both starts' steps."""
    c = cells[arch_id, "mixed"]
    for ties in c["prefill"]["ties"]:
        assert ties.mean() <= MAX_TIE_SHARE, ties
    dec = np.stack([t for start in STARTS for t in c["decode"][start]["ties"]])
    assert dec.mean() <= MAX_TIE_SHARE, dec


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("arch_id,prec", CASES)
def test_moe_decode_metrics_equal(cells, arch_id, prec, start):
    c = cells[arch_id, prec]["decode"]
    for jo, to in zip(c[start]["jout"], c[start]["tout"]):
        assert _ints(to) == _ints(jo) and _ints(to)[f"{c['gkey']}/dev_rows_live"] > 0


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("arch_id,prec", CASES)
def test_moe_decode_logits_match_reference(cells, arch_id, prec, start):
    """Each step's logits (B, V) at every row (MIXED: off a near-tie)."""
    c = cells[arch_id, prec]["decode"]
    cfg = c["tcell"].arch.model
    for jo, to, tie in zip(c[start]["jout"], c[start]["tout"], c[start]["ties"]):
        assert to["logits"].shape == (B_DEC, cfg.vocab_size) and to["logits"].dtype == torch.float32
        np.testing.assert_allclose(to["logits"].numpy()[~tie], jo["logits"][~tie], **LOGIT_TOLS[prec])


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("arch_id,prec", CASES)
def test_moe_decode_cache_and_pos_match_reference(cells, arch_id, prec, start):
    """``pos`` and ``step`` equal; the caches written at the three steps'
    positions alone, in place: the written rows (MIXED: off a near-tie)
    held, every position no step wrote bit-equal to the reference's and to
    the start."""
    c = cells[arch_id, prec]["decode"][start]
    p0 = int(c["init"]["pos"])
    assert int(c["tfinal"]["pos"]) == int(c["jfinal"]["pos"]) == p0 + STEPS
    assert int(c["tfinal"]["step"]) == int(c["jfinal"]["step"]) == 0
    written = np.zeros(T, bool)
    written[p0:p0 + STEPS] = True
    for k in ("k", "v"):
        got = c["tfinal"]["cache"][k].float().numpy()
        want, before = c["jfinal"]["cache"][k].astype(np.float32), c["init"]["cache"][k].astype(np.float32)
        np.testing.assert_array_equal(got[:, :, ~written], want[:, :, ~written])
        np.testing.assert_array_equal(got[:, :, ~written], before[:, :, ~written])
        for s, tie in enumerate(c["ties"]):
            p = p0 + s
            np.testing.assert_allclose(got[:, ~tie, p], want[:, ~tie, p], **CACHE_TOLS[prec], err_msg=f"{k} at {p}")
            assert not np.array_equal(got[:, :, p], before[:, :, p]), "nothing was written"
