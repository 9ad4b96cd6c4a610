"""The MoE FFN and the MoE transformer stack, JAX package against the
PyTorch port on the CPU: the one-device MoE (the reference's
``_moe_single``, its params from ``make_moe``) against the port's grouped
and gathered dispatch and its dense plain version, with and without shared
experts, top-k 2, 4 and 6 and expert counts that are no power of two; the
tie order of the top-k; that the dispatch makes no (E, N, ·) tensor and that
a decode-sized call neither casts every expert nor waits for the device;
the stack's hidden state and aux loss; the params' conversion; the
draw on the device; and what the MoE archs refuse over a group (their
training: tests/test_torch_moe_train.py and tests/test_torch_moe_grad.py).

Tolerances: FP32 within 1e-5 of the largest magnitude (fp32 sums in
another order); MIXED within ``MIXED_TOL`` of tests/test_torch_lm.py (the
products round to bf16 once in each framework: one bf16 ulp apart at
most, 2^-8 of the largest magnitude here). The selected experts are equal
and the aux loss within 1e-6 (relative: the mean of fp32 probabilities
summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tfm
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import transformer_from_numpy
from repro_torch.launch.cells import build_cell as t_build_cell
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tfm
from test_torch_lm import MIXED_TOL

PRECS = {"fp32": (j_layers.FP32, t_layers.FP32), "mixed": (j_layers.MIXED, t_layers.MIXED)}
D, F = 64, 96
# (experts, top-k, shared experts): 60 is qwen2-moe's count, 12 and 6 no power of two either
MOE_CASES = {"e8_k2_shared1": (8, 2, 1), "e60_k4_shared4": (60, 4, 4), "e12_k6": (12, 6, 0),
             "e6_k4_shared2": (6, 4, 2)}
# tokens: 256 (N·k above E: the grouped dispatch) and 1 (N·k at most E: gathered)
TOKENS = {"grouped": 256, "gathered": 1}
MOE_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
# Under MIXED the two frameworks' bf16 hidden states lie an ulp or two
# apart at some elements, which moves a router probability by up to 0.79%
# of itself in these smoke stacks (layer by layer, both sides' routers
# compared on their own hidden states). A token whose k-th and (k+1)-th
# probabilities lie closer than twice that (NEAR_TIE_REL of the k-th) can
# take another expert in each framework, and is left out of a MIXED stack
# comparison; at most MAX_TIE_SHARE of the tokens may be so. Each MoE layer
# is also held alone on the port's own input, where the routing is equal.
NEAR_TIE_REL = 2e-2
MAX_TIE_SHARE = 0.25


class RoutingRecorder:
    """Within ``with``, keeps the port's routing probabilities of every MoE
    call (``moe.route``)."""

    def __enter__(self):
        self.calls, self._real = [], t_moe.route

        def recorded(router, x, top_k):
            out = self._real(router, x, top_k)
            self.calls.append((out[0].detach().float().numpy(), top_k))
            return out

        t_moe.route = recorded
        return self

    def __exit__(self, *exc):
        t_moe.route = self._real

    def near_ties(self, n: int) -> np.ndarray:
        """(n,) bool: the tokens whose k-th and (k+1)-th probabilities lie
        within NEAR_TIE_REL of the k-th, and are not equal, at some
        recorded call. Equal ones (a zero row's uniform probabilities) are
        equal in both frameworks, where the lower expert index wins."""
        tie = np.zeros(n, bool)
        for probs, k in self.calls:
            p = -np.sort(-probs, axis=-1)
            gap = p[:, k - 1] - p[:, k]
            tie |= (gap > 0) & (gap < NEAR_TIE_REL * p[:, k - 1])
        return tie


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_frac(got, want, frac, what):
    err, top = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= frac * top, f"{what}: max diff {err} against largest magnitude {top}"


def _close(got: np.ndarray, want: np.ndarray, prec: str, what: str) -> None:
    if prec == "fp32":
        _within_frac(got, want, 1e-5, what)
    else:
        np.testing.assert_allclose(got, want, **MIXED_TOL, err_msg=what)


def _moe_pair(e: int, k: int, shared: int, seed: int = 0):
    """The reference's params (``make_moe``, one device: no padding) and a
    port ``MoE`` holding them."""
    jcfg = j_moe.MoEConfig(d_model=D, d_ff=F, n_experts=e, top_k=k, n_shared=shared)
    p = jax.tree.map(np.asarray, j_moe.make_moe(jax.random.PRNGKey(seed), jcfg, e))
    m = t_moe.MoE(t_moe.MoEConfig(d_model=D, d_ff=F, n_experts=e, top_k=k, n_shared=shared),
                  torch.Generator().manual_seed(seed))
    sd = {n: torch.from_numpy(p[n]) for n in ("router", "gate", "up", "down")}
    if shared:
        sd.update({f"shared.{n}.weight": torch.from_numpy(p["shared"][n].T.copy()) for n in ("gate", "up", "down")})
    m.load_state_dict(sd)
    return jcfg, p, m


def _inputs(n: int, prec: str, seed: int = 1):
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    if prec == "mixed":  # the stack hands the FFN its normed hidden state in the compute type
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _reference_experts(p, jcfg, jx) -> np.ndarray:
    """The reference's routing steps (``_moe_single``): its selected experts."""
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ p["router"], -1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


@pytest.mark.parametrize("path", TOKENS)
@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_matches_reference(case, prec, path):
    """``moe_apply`` (grouped or gathered) and ``moe_dense_ref`` against
    ``_moe_single``: y, the selected experts and the aux loss."""
    jcfg, p, m = _moe_pair(*MOE_CASES[case])
    jx, tx = _inputs(TOKENS[path], prec)
    jprec, tprec = PRECS[prec]
    jy, jaux, _ = j_tfm._moe_single(p, jcfg, jx, jprec)
    with torch.no_grad():
        _, _, top_e = t_moe.route(m.router, tx, jcfg.top_k)
        for fn in (t_moe.moe_apply, t_moe.moe_dense_ref):
            ty, taux = fn(m, tx, tprec)
            assert ty.shape == tx.shape and ty.dtype == tx.dtype
            _close(ty.float().numpy(), _np(jy), prec, f"{fn.__name__} y")
            np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(top_e.numpy(), _reference_experts(p, jcfg, jx))


@pytest.mark.parametrize("k", (2, 4, 6))
def test_ties_pick_the_reference_experts(k):
    """Zero rows give every expert the same probability: the reference's
    ``jax.lax.top_k`` picks experts 0..k-1, and so must the port (a stable
    descending sort; ``torch.topk`` picks others)."""
    jcfg, p, m = _moe_pair(60, k, 0)
    jx, tx = jnp.zeros((3, D), jnp.float32), torch.zeros((3, D))
    with torch.no_grad():
        probs, top_w, top_e = t_moe.route(m.router, tx, k)
    want = _reference_experts(p, jcfg, jx)
    np.testing.assert_array_equal(want, np.broadcast_to(np.arange(k), (3, k)))
    np.testing.assert_array_equal(top_e.numpy(), want)
    np.testing.assert_allclose(top_w.numpy(), 1.0 / k, rtol=1e-6)
    jy, jaux, _ = j_tfm._moe_single(p, jcfg, jx, j_layers.FP32)
    with torch.no_grad():
        ty, taux = t_moe.moe_apply(m, tx, t_layers.FP32)
    np.testing.assert_array_equal(ty.numpy(), _np(jy))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


class _Sizes:
    """Every op's output sizes (``TorchDispatchMode``) and the grouped
    dispatch's waits for the device (``moe._group_sizes``)."""

    def __init__(self, monkeypatch):
        from torch.utils._python_dispatch import TorchDispatchMode

        self.outputs, self.waits = [], 0
        sizes, real = self, t_moe._group_sizes

        def counted(counts):
            sizes.waits += 1
            return real(counts)

        monkeypatch.setattr(t_moe, "_group_sizes", counted)

        class Watch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in out if isinstance(out, (tuple, list)) else [out]:
                    if torch.is_tensor(t):
                        sizes.outputs.append((str(func), tuple(t.shape), t.numel()))
                return out

        self.mode = Watch

    def largest(self) -> tuple:
        return max(self.outputs, key=lambda o: o[2])


@pytest.mark.parametrize("prec", PRECS)
def test_moe_makes_no_expert_by_token_tensor(monkeypatch, prec):
    """Prefill-sized (N 128: the grouped dispatch) no op makes a tensor of
    E·N·min(d, f) elements or more (the reference's (E, N, f) products),
    and the host waits once; decode-sized (N 2, N·k no more than E: the
    gathered dispatch) no op makes a tensor of E·d·f elements (every
    expert's weights cast) and the host never waits."""
    e, k, n = 8, 2, 128
    _, _, m = _moe_pair(e, k, 1)
    tprec = PRECS[prec][1]
    sizes = _Sizes(monkeypatch)
    x = _inputs(n, prec)[1]
    with torch.no_grad(), sizes.mode():
        y, _ = t_moe.moe_apply(m, x, tprec)
    assert y.shape == (n, D) and sizes.waits == 1
    assert sizes.largest()[2] < e * n * min(D, F), sizes.largest()
    sizes.outputs, sizes.waits = [], 0
    with torch.no_grad(), sizes.mode():
        y, _ = t_moe.moe_apply(m, x[:2], tprec)
    assert y.shape == (2, D) and sizes.waits == 0
    assert sizes.largest()[2] < e * D * F, sizes.largest()
    sizes.outputs = []
    with torch.no_grad(), sizes.mode():  # the check sees the dense form's (E, N, f) products
        t_moe.moe_dense_ref(m, x, tprec)
    assert sizes.largest()[2] >= e * n * min(D, F)


@pytest.mark.parametrize("path", TOKENS)
def test_moe_without_aux_gives_the_same_y_and_skips_its_work(monkeypatch, path):
    """``with_aux=False`` (a decode step, which drops the aux) gives the
    same y bit for bit and no aux; decode-sized (the gathered dispatch) it
    counts no assignments and computes no loss, so it makes fewer ops."""
    _, _, m = _moe_pair(8, 2, 1)
    x = _inputs(TOKENS[path], "mixed")[1]
    sizes, ops = _Sizes(monkeypatch), {}
    for with_aux in (True, False):
        sizes.outputs = []
        with torch.no_grad(), sizes.mode():
            ops[with_aux] = t_moe.moe_apply(m, x, t_layers.MIXED, with_aux), [o[0] for o in sizes.outputs]
    (y, aux), with_ops = ops[True]
    (y_no, aux_no), no_ops = ops[False]
    assert torch.equal(y_no, y) and aux is not None and aux_no is None
    assert len(no_ops) < len(with_ops)
    if y.shape[0] * 2 <= 8:  # gathered
        assert not any("index_add" in o for o in no_ops) and any("index_add" in o for o in with_ops)


def _smoke(arch_id: str):
    return j_get_config(arch_id, smoke=True).model, t_get_config(arch_id, smoke=True).model


def _transformer(jparams, tcfg):
    model = t_tfm.init(tcfg)
    model.load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    return model


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_transformer_apply_with_moe_matches_reference(arch_id, prec):
    """The 2-layer smoke stack (Pallas attention in interpret mode on the
    JAX side): the hidden state after the final norm, every layer's K and
    V, and the summed aux loss (two layers' routings)."""
    jcfg, tcfg = _smoke(arch_id)
    jparams = j_tfm.init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(5).normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    jprec, tprec = PRECS[prec]
    jh, jaux, (jk, jv) = j_tfm.apply(jparams, jcfg, jnp.asarray(x), j_tfm.MeshCtx(), jprec,
                                     attn_impl="pallas", collect_cache=True)
    layer_io, real = [], t_moe.moe_apply

    def recorded(m, h, p, with_aux=True):
        out = real(m, h, p, with_aux)
        layer_io.append((h.float().numpy(), out[0].float().numpy()))
        return out

    with torch.no_grad(), RoutingRecorder() as rec, pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_moe, "moe_apply", recorded)
        th, taux, (tk, tv) = t_tfm.apply(_transformer(jparams, tcfg), torch.from_numpy(x), tprec,
                                         collect_cache=True)
    assert len(rec.calls) == len(layer_io) == tcfg.n_layers
    for i, (h, y) in enumerate(layer_io):  # each MoE layer on the port's own input
        lp = jax.tree.map(lambda v: np.asarray(v)[i], jparams["layers"])
        jy, _, _ = j_tfm._moe_single(lp["moe"], jcfg.moe, jprec.cast(jnp.asarray(h)), jprec)
        _close(y, _np(jy), prec, f"layer {i} moe")
    ties = rec.near_ties(x.shape[0] * x.shape[1]).reshape(x.shape[:2])
    assert ties.mean() <= MAX_TIE_SHARE
    for got, want, what in [(th[None], jh[None], "hidden"), (tk, jk, "cache k"), (tv, jv, "cache v")]:
        if prec == "fp32":
            _within_frac(got.numpy(), _np(want), 1e-4, what)
        else:  # the tokens (b, t) off a near-tie
            np.testing.assert_allclose(got.float().numpy()[:, ~ties], _np(want)[:, ~ties], **MIXED_TOL, err_msg=what)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6 if prec == "fp32" else 1e-3)


def test_dense_stack_aux_is_zero():
    _, tcfg = _smoke("qwen2-moe-a2.7b")
    tcfg = dataclasses.replace(tcfg, moe=None)
    with torch.no_grad():
        _, aux, cache = t_tfm.apply(t_tfm.init(tcfg), torch.zeros(1, 4, tcfg.d_model), t_layers.FP32)
    assert float(aux) == 0.0 and cache is None


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_transformer_from_numpy_with_moe_round_trip(arch_id):
    """Every leaf of the reference's MoE tree lands once in the state dict:
    the stacked experts and the router as they are, the shared experts'
    matrices transposed into ``nn.Linear`` layout; an expert count padded
    for expert parallelism (60 → 64) raises."""
    jcfg, tcfg = _smoke(arch_id)
    tree = jax.tree.map(np.asarray, j_tfm.init(jax.random.PRNGKey(3), jcfg))
    sd = transformer_from_numpy(tree, tcfg)
    model = t_tfm.init(tcfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert sum(v.numel() for v in model.state_dict().values()) == n_leaves
    for i in range(tcfg.n_layers):
        lt = jax.tree.map(lambda x: x[i], tree["layers"])
        m = model.layers[i].moe
        for n in ("router", "gate", "up", "down"):
            np.testing.assert_array_equal(getattr(m, n).detach().numpy(), lt["moe"][n])
        if tcfg.moe.n_shared:
            for n in ("gate", "up", "down"):
                np.testing.assert_array_equal(getattr(m.shared, n).weight.detach().numpy(), lt["moe"]["shared"][n].T)
        else:
            assert m.shared is None and "shared" not in lt["moe"]
        assert not hasattr(model.layers[i], "ffn")
    padded = jax.tree.map(np.asarray, j_tfm.init(jax.random.PRNGKey(3), jcfg, ep_size=3))  # 8 → 9 experts
    with pytest.raises(ValueError, match="moe.router|moe.gate"):
        transformer_from_numpy(padded, tcfg)


@pytest.mark.parametrize("arch_id", ("qwen2.5-3b", *MOE_ARCHS))
def test_init_from_a_given_generator_gives_init(arch_id):
    """A model drawn from a given CPU generator seeded s holds
    ``init(cfg, s)``'s weights bit for bit: the card's draw in
    ``chip_smoke.py`` (a CUDA generator given as ``gen``) follows the
    package's law and order."""
    _, tcfg = _smoke(arch_id)
    got = t_tfm.init(tcfg, seed=0, gen=torch.Generator().manual_seed(4)).state_dict()
    want = t_tfm.init(tcfg, seed=4).state_dict()
    assert set(got) == set(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_decode_over_a_prompt_equals_prefill(arch_id):
    """Teacher-forced decode (the gathered dispatch) over a prompt gives the
    prefill's logits (the grouped dispatch) at every position, FP32 within
    5e-3, as for the dense stack (tests/test_torch_decode.py)."""
    _, tcfg = _smoke(arch_id)
    model = t_tfm.init(tcfg, seed=2)
    x = torch.from_numpy((np.random.default_rng(8).normal(size=(2, 12, tcfg.d_model)) * 0.5).astype(np.float32))
    with torch.no_grad():
        h, _, _ = t_tfm.apply(model, x, t_layers.FP32)
        full = t_layers.dense_apply(model.head, h, t_layers.FP32)
        cache = t_tfm.init_cache(tcfg, 2, 12)
        dec = torch.stack([t_tfm.decode_step(model, x[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32),
                                             None, t_layers.FP32) for i in range(12)], 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3, atol=5e-3)
    assert float((dec[:, 1:] - full[:, :-1]).abs().max()) > 5e-2


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_decode_over_a_group_refuses(arch_id):
    """A MoE decode cell over a group (its expert-parallel dispatch) raises
    and names ROADMAP A7g; prefill over a group raises as for every LM."""
    with pytest.raises(NotImplementedError, match="A7g"):
        t_build_cell(arch_id, "decode_32k", smoke=True, device="cpu", group=object())
    with pytest.raises(NotImplementedError, match="A7g"):
        t_build_cell(arch_id, "prefill_32k", smoke=True, device="cpu", group=object())


def test_moe_configs_match_reference():
    for arch_id in MOE_ARCHS:
        for smoke in (False, True):
            ja, ta = j_get_config(arch_id, smoke=smoke), t_get_config(arch_id, smoke=smoke)
            for f in dataclasses.fields(ta.model.moe):  # the port's fields; the EP knobs wait for A7g
                assert getattr(ja.model.moe, f.name) == getattr(ta.model.moe, f.name), f.name
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab_size", "qkv_bias", "rope_theta"):
                assert getattr(ja.model, f) == getattr(ta.model, f), f
            assert (ja.arch_id, ja.family, ja.source) == (ta.arch_id, ta.family, ta.source)
            assert [(s.name, s.kind, dict(s.params)) for s in ja.shapes] == \
                   [(s.name, s.kind, dict(s.params)) for s in ta.shapes]
