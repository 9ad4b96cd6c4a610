"""The MoE layer's backward and the LM train options, JAX package against
the PyTorch port on the CPU:

* the gradients of one MoE layer (the grouped dispatch and its
  ``GroupedSwiGLU`` backward) in its input, router, gate, up, down and
  shared experts, against ``jax.grad`` of the reference's ``_moe_single``
  with the aux loss added, for both smoke archs' MoE configs, in FP32 and
  MIXED; the aux term must show in the router's gradient;
* that the backward makes no (E, N, ·) tensor and does not wait for the
  device again;
* the chunked loss (``fused_ce``) against the reference's ``_chunked_ce``
  and against the plain loss;
* ``remat_policy="dots"`` against ``"full"``.

Tolerances: FP32 within 1e-4 of each gradient's largest magnitude (fp32
products summed in another order, a softmax and the top-k weights'
normalisation in between), the loss within 1e-5. MIXED at ``MIXED_TOL``
(tests/test_torch_lm.py) in units of each gradient's largest magnitude
(bf16 inputs an ulp apart move a sum over the tokens by about an ulp of
its largest terms, not of each element): the products round to bf16 once
in each framework, and a token's k assignments are summed in bf16 in the port's
gather gradient where the reference sums them inside its einsum; a token
whose k-th and (k+1)-th probabilities lie within ``NEAR_TIE_REL`` gets no
output gradient, as tests/test_torch_moe.py leaves it out."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tfm
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tfm
from test_torch_lm import MIXED_TOL
from test_torch_moe import MAX_TIE_SHARE, MOE_ARCHS, RoutingRecorder, _Sizes

PRECS = {"fp32": (j_layers.FP32, t_layers.FP32), "mixed": (j_layers.MIXED, t_layers.MIXED)}
N = 256
GRADS = ("x", "router", "gate", "up", "down", "shared.gate", "shared.up", "shared.down")


def _pair(arch_id: str, aux_weight: float | None = None):
    """The arch's smoke MoE config: the reference's params (``make_moe``)
    and a port ``MoE`` holding them (``aux_weight`` replaces the port's
    router aux weight)."""
    jmc, tmc = j_get_config(arch_id, smoke=True).model.moe, t_get_config(arch_id, smoke=True).model.moe
    p = jax.tree.map(np.asarray, j_moe.make_moe(jax.random.PRNGKey(7), jmc, jmc.n_experts))
    if aux_weight is not None:
        tmc = dataclasses.replace(tmc, router_aux_weight=aux_weight)
    m = t_moe.MoE(tmc, torch.Generator().manual_seed(0))
    sd = {n: torch.from_numpy(np.array(p[n])) for n in ("router", "gate", "up", "down")}
    if tmc.n_shared:
        sd.update({f"shared.{n}.weight": torch.from_numpy(p["shared"][n].T.copy()) for n in ("gate", "up", "down")})
    m.load_state_dict(sd)
    return jmc, p, m


def _inputs(d: int, prec: str):
    r = np.random.default_rng(3)
    x = r.normal(size=(N, d)).astype(np.float32)
    c = r.normal(size=(N, d)).astype(np.float32)  # the output's cotangent
    if prec == "mixed":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, c


def _port_grads(m, x: np.ndarray, c: np.ndarray, prec: str) -> dict:
    """d(sum(y · c) / N + aux) in x and every param of ``m``."""
    tprec = PRECS[prec][1]
    tx = torch.from_numpy(x).to(tprec.compute_dtype).requires_grad_()
    y, aux = t_moe.moe_apply(m, tx, tprec)
    loss = torch.sum(y.float() * torch.from_numpy(c)) / N + aux
    names = [n for n, _ in m.named_parameters()]
    g = torch.autograd.grad(loss, [tx, *m.parameters()])
    out = {"x": g[0]}
    for n, v in zip(names, g[1:]):
        out[n.replace(".weight", "")] = v.T if n.startswith("shared.") else v  # the reference's layout
    return {k: v.float().numpy() for k, v in out.items()}


def _ref_grads(jmc, p, x: np.ndarray, c: np.ndarray, prec: str) -> dict:
    jprec = PRECS[prec][0]

    def f(p, x):
        y, aux, _ = j_tfm._moe_single(p, jmc, jprec.cast(x) if prec == "mixed" else x, jprec)
        return jnp.sum(y.astype(jnp.float32) * c) / N + aux

    gp, gx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out = {"x": gx, **{n: gp[n] for n in ("router", "gate", "up", "down")}}
    if "shared" in gp:
        out.update({f"shared.{n}": gp["shared"][n] for n in ("gate", "up", "down")})
    return {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in out.items()}


def _frac(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_moe_grads_match_reference(arch_id, prec):
    jmc, p, m = _pair(arch_id)
    x, c = _inputs(jmc.d_model, prec)
    if prec == "mixed":  # no output gradient at a near-tie token (the aux term still reaches it)
        with torch.no_grad(), RoutingRecorder() as rec:
            t_moe.moe_apply(m, torch.from_numpy(x).to(torch.bfloat16), t_layers.MIXED)
        ties = rec.near_ties(N)
        assert ties.mean() <= MAX_TIE_SHARE
        c = c * ~ties[:, None]
    got, want = _port_grads(m, x, c, prec), _ref_grads(jmc, p, x, c, prec)
    assert set(got) == set(want) == {g for g in GRADS if jmc.n_shared or not g.startswith("shared")}
    for n in want:
        assert got[n].shape == want[n].shape, n
        if prec == "fp32":
            assert _frac(got[n], want[n]) <= 1e-4, (n, _frac(got[n], want[n]))
        else:  # in units of the largest magnitude, where a zero gradient fails
            top = np.abs(want[n]).max()
            np.testing.assert_allclose(got[n] / top, want[n] / top, **MIXED_TOL, err_msg=n)


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_router_grad_sees_the_aux_term(arch_id):
    """With the aux weight set to 0 the port's router gradient leaves the
    reference's (which has it) by more than the FP32 tolerance, so the check
    above holds the aux term's gradient too."""
    jmc, p, m = _pair(arch_id, aux_weight=0.0)
    x, c = _inputs(jmc.d_model, "fp32")
    got, want = _port_grads(m, x, c, "fp32"), _ref_grads(jmc, p, x, c, "fp32")
    assert _frac(got["router"], want["router"]) > 1e-3, _frac(got["router"], want["router"])
    assert _frac(got["gate"], want["gate"]) <= 1e-4


@pytest.mark.parametrize("prec", PRECS)
def test_moe_backward_makes_no_expert_by_token_tensor(monkeypatch, prec):
    """Through the backward too (N 128, the grouped dispatch, as
    tests/test_torch_moe.py checks the forward): no op makes a tensor of
    E·N·min(d, f) elements or more, and the backward does not wait for the
    group sizes again (one wait for the forward and backward); the check
    sees the dense form's backward."""
    e, n = 8, 128
    _, _, m = _pair("qwen2-moe-a2.7b")
    d, f = m.cfg.d_model, m.cfg.d_ff
    tprec = PRECS[prec][1]
    sizes = _Sizes(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(n, d)).astype(np.float32))
    x = x.to(tprec.compute_dtype).requires_grad_()
    y, aux = t_moe.moe_apply(m, x, tprec)
    assert sizes.waits == 1
    with sizes.mode():
        grads = torch.autograd.grad(y.float().sum() + aux, [x, *m.parameters()])
    assert sizes.waits == 1 and sizes.outputs
    assert sizes.largest()[2] < e * n * min(d, f), sizes.largest()
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    sizes.outputs = []
    yd, auxd = t_moe.moe_dense_ref(m, x, tprec)
    with sizes.mode():
        torch.autograd.grad(yd.float().sum() + auxd, [x, *m.parameters()])
    assert sizes.largest()[2] >= e * n * min(d, f)


def test_grouped_swiglu_gives_zero_gradients_to_idle_experts():
    """An expert that got no rows gets zeros in all three of its
    gradients; every other expert's are held to the plain per-expert loop
    under autograd (FP32, 1e-6 of the largest magnitude)."""
    e, d, f = 5, 16, 24
    r = torch.Generator().manual_seed(2)
    xs = torch.randn(20, d, generator=r, requires_grad=True)
    w = [torch.randn(e, *s, generator=r, requires_grad=True) for s in ((d, f), (d, f), (f, d))]
    sizes = [6, 0, 9, 5, 0]
    dy = torch.randn(20, d, generator=r)
    got = torch.autograd.grad(t_moe.GroupedSwiGLU.apply(xs, *w, t_moe._spans(sizes)), [xs, *w], dy)
    lo, parts = 0, []
    for i, cnt in enumerate(sizes):
        xe = xs[lo:lo + cnt]
        parts.append((torch.nn.functional.silu(xe @ w[0][i]) * (xe @ w[1][i])) @ w[2][i])
        lo += cnt
    want = torch.autograd.grad(torch.cat(parts), [xs, *w], dy)
    for g, wg in zip(got, want):
        assert float((g - wg).abs().max()) <= 1e-6 * float(wg.abs().max())
    for g in got[1:]:
        assert torch.count_nonzero(g[1]) == 0 and torch.count_nonzero(g[4]) == 0
        assert torch.count_nonzero(g[0]) > 0


def _head_and_h(t: int):
    """A smoke head (d 64, V 512) in both layouts, hidden states and labels."""
    tcfg = t_get_config("qwen2-moe-a2.7b", smoke=True).model
    r = np.random.default_rng(9)
    w = (r.uniform(-1, 1, size=(tcfg.d_model, tcfg.vocab_size)) / 8).astype(np.float32)
    h = r.normal(size=(2, t, tcfg.d_model)).astype(np.float32)
    labels = r.integers(0, tcfg.vocab_size, size=(2, t)).astype(np.int32)
    head = torch.nn.Linear(tcfg.d_model, tcfg.vocab_size, bias=False)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(w.T.copy()))
    return {"w": jnp.asarray(w)}, head, h, labels


@pytest.mark.parametrize("t", (300, 512, 40))
def test_chunked_ce_matches_reference_and_plain_loss(t):
    """``_chunked_ce`` (chunks of 256, the tail on its own: T 300 has a
    44-position tail, 512 none, 40 is one short chunk) against the
    reference's ``_chunked_ce`` and against the plain loss, FP32: the loss
    within 1e-5, the gradients in h and the head within 1e-5 of their
    largest magnitude."""
    jhead, head, h, labels = _head_and_h(t)
    want = float(j_tfm._chunked_ce(jhead, jnp.asarray(h), jnp.asarray(labels), j_tfm.MeshCtx(), j_layers.FP32))
    th, tl = torch.from_numpy(h).requires_grad_(), torch.from_numpy(labels)
    got = t_tfm._chunked_ce(head, th, tl, t_layers.FP32)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    g_chunk = torch.autograd.grad(got, [th, head.weight])
    plain = torch.mean(t_tfm._ce_terms(head, th, tl, t_layers.FP32))
    np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-5)
    g_plain = torch.autograd.grad(plain, [th, head.weight])
    for a, b in zip(g_chunk, g_plain):
        assert _frac(a.numpy(), b.numpy()) <= 1e-5


@pytest.mark.parametrize("arch_id", MOE_ARCHS)
def test_lm_loss_fused_ce_matches_reference(arch_id):
    """The smoke stack's ``lm_loss`` with ``fused_ce`` (T 300: a chunk and
    a tail) against the reference's with ``fused_ce``, FP32, remat on in
    both: the loss within 1e-5 and the aux loss within 1e-6 (relative)."""
    from repro_torch.convert import transformer_from_numpy

    jcfg = j_get_config(arch_id, smoke=True).model
    tcfg = t_get_config(arch_id, smoke=True).model
    jparams = j_tfm.init(jax.random.PRNGKey(4), jcfg)
    model = t_tfm.init(tcfg)
    model.load_state_dict(transformer_from_numpy(jax.tree.map(np.asarray, jparams), tcfg))
    r = np.random.default_rng(6)
    x = r.normal(size=(1, 300, jcfg.d_model)).astype(np.float32)
    labels = r.integers(0, jcfg.vocab_size, size=(1, 300)).astype(np.int32)
    jloss, jaux = j_tfm.lm_loss(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels), j_tfm.MeshCtx(),
                                j_layers.FP32, attn_impl="chunked", fused_ce=True)
    tloss, taux = t_tfm.lm_loss(model, torch.from_numpy(x).requires_grad_(), torch.from_numpy(labels),
                                t_layers.FP32, fused_ce=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("prec", PRECS)
@pytest.mark.parametrize("arch_id", (*MOE_ARCHS, "qwen2.5-3b"))
def test_dots_policy_equals_full_remat_with_fewer_products(arch_id, prec):
    """``remat_policy="dots"`` keeps the plain products' outputs: loss, aux
    and every gradient bit-equal to ``"full"`` on the CPU, with fewer
    ``aten.mm`` and ``aten.addmm`` calls in the backward (the recomputed
    layers skip their projections, SwiGLU and router products) and the
    same expert and attention recompute."""
    cfg = t_get_config(arch_id, smoke=True).model
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.normal(size=(2, 64, cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, cfg.vocab_size, size=(2, 64)))
    tprec = PRECS[prec][1]
    out = {}
    for policy in ("full", "dots"):
        model = t_tfm.init(dataclasses.replace(cfg, remat_policy=policy), seed=1)
        xe = x.clone().requires_grad_()
        loss, aux = t_tfm.lm_loss(model, xe, labels, tprec)
        with _CountOps() as ops:
            grads = torch.autograd.grad(loss + aux, [*model.parameters(), xe])
        out[policy] = (loss, aux, grads, ops.n)
    (lf, af, gf, nf), (ld, ad, gd, nd) = out["full"], out["dots"]
    assert torch.equal(lf, ld) and torch.equal(af, ad)
    assert all(torch.equal(a, b) for a, b in zip(gf, gd))
    mm, addmm = torch.ops.aten.mm.default, torch.ops.aten.addmm.default
    assert nd[mm] + nd[addmm] < nf[mm] + nf[addmm], (nd, nf)
    assert nd[torch.ops.aten.mm.out] == nf[torch.ops.aten.mm.out]


@pytest.mark.parametrize("prec", PRECS)
def test_grouped_swiglu_without_grad_gives_the_same_values_and_saves_nothing(prec):
    """Where no gradient is taken (prefill under ``inference_mode``) the
    grouped dispatch runs ``_grouped_swiglu``: the layer's output equal bit
    for bit to the autograd Function's forward, and no (N·k, f) buffer left
    alive for a backward that never runs."""
    _, _, m = _pair("qwen2-moe-a2.7b")
    tprec = PRECS[prec][1]
    x = torch.from_numpy(_inputs(m.cfg.d_model, prec)[0]).to(tprec.compute_dtype)
    with torch.no_grad():
        y_serve, _ = t_moe.moe_apply(m, x, tprec)
    y_train, _ = t_moe.moe_apply(m, x, tprec)
    assert y_train.requires_grad and torch.equal(y_serve, y_train.detach())
    calls = []
    real = t_moe.GroupedSwiGLU.apply
    t_moe.GroupedSwiGLU.apply = lambda *a: calls.append(a) or real(*a)
    try:
        with torch.inference_mode():
            y_inf, _ = t_moe.moe_apply(m, x, tprec)
    finally:
        t_moe.GroupedSwiGLU.apply = real
    assert not calls and torch.equal(y_inf, y_serve)


@pytest.mark.parametrize("policy", ("none", "Dots", ""))
def test_unknown_remat_policy_raises(policy):
    """``remat_policy`` is "full" or "dots"; any other value raises, at the
    config and through the train cell's options."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.common import CellOptions

    cfg = t_get_config("qwen2-moe-a2.7b", smoke=True).model
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(cfg, remat_policy=policy)
    with pytest.raises(ValueError, match="remat_policy"):
        build_cell("qwen2-moe-a2.7b", "train_4k", smoke=True, device="cpu",
                   shape_override=ShapeCell("train_4k", "train", {"seq_len": 32, "global_batch": 2}),
                   opts=CellOptions(remat_policy=policy))
