"""Mixture-of-Experts FFN on one device (port of ``repro/models/moe.py``'s
config and params, and of ``repro/models/transformer.py``'s one-device
``_moe_single``).

The router scores every token in fp32, keeps its top-k experts (a stable
descending sort: on ties the lower expert index wins, as ``jax.lax.top_k``
does) with their weights renormalised, and adds the experts' SwiGLU
outputs, weighted, then the shared experts' SwiGLU. The reference runs
every expert on every token (one-hot weights); here each expert runs on
its own rows only, dropless, and no tensor with (E, N, ·) elements is
made:

* **grouped** (more assignments than experts: prefill and training): the
  N·k assignments sorted by expert (stable), their tokens gathered, one
  product per expert over its rows; the group sizes reach the host once a
  call (``_group_sizes``). The experts' SwiGLU is one autograd Function
  (``GroupedSwiGLU``) whose backward reuses the forward's group sizes and
  writes each expert's gradients with its own products, so no per-expert
  select of the stacks is differentiated. A train step therefore waits
  for the device once a MoE layer in the forward and, under ``remat``,
  once more where the layer is recomputed in the backward;
* **gathered** (no more assignments than experts: a decode step, which
  runs under ``inference_mode``): each assignment's expert weights gathered
  and one batched product over them; the host never waits, and only the
  chosen experts' weights are read.

Rounding is the reference's: the expert products come out in the compute
type, the routing weight is rounded to it before it multiplies, the k
weighted outputs are summed in fp32 and rounded once (the reference's
einsum ``"end,ne->nd"``), then the shared output is added in the compute
type. ``moe_dense_ref`` is the reference's dense form itself, for the
tests and ``chip_smoke.py`` to hold the dispatch against.

The expert-parallel dispatch (``moe_apply_local`` with
``core/bucketing.py``, with the reference config's ``capacity_factor`` and
``n_local_experts`` and the expert padding) runs only over a mesh's
"model" axis, and waits for the LM cells over a group (ROADMAP A7g).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MIXED, Precision, SwiGLU, uniform_


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0
    router_aux_weight: float = 0.01


class MoE(nn.Module):
    """``router`` (d, E), ``gate`` and ``up`` (E, d, f), ``down`` (E, f, d),
    stacked as in the reference's tree, and ``shared``, the shared experts
    as one SwiGLU of width ``n_shared·f`` (None without them). Weights
    U(±1/√d), ``down`` U(±1/√f) and the shared ``down`` U(±1/√(n_shared·f)),
    the reference's law, drawn from ``gen`` (``uniform_``). Applied by
    ``moe_apply``."""

    def __init__(self, cfg: MoEConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty((d, e), device=device))
        self.gate = nn.Parameter(torch.empty((e, d, f), device=device))
        self.up = nn.Parameter(torch.empty((e, d, f), device=device))
        self.down = nn.Parameter(torch.empty((e, f, d), device=device))
        s = 1.0 / np.sqrt(d)
        for p, bound in ((self.router, s), (self.gate, s), (self.up, s), (self.down, 1.0 / np.sqrt(f))):
            uniform_(p, bound, gen)
        self.shared = SwiGLU(d, cfg.n_shared * f, gen, device) if cfg.n_shared else None


def route(router: torch.Tensor, x: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, d) → (probs (N, E) fp32, top_w (N, k) renormalised by
    max(sum, 1e-9), top_e (N, k) int64). The top k by a stable descending
    sort: ties go to the lower expert index."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    return probs, top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def _aux_loss(cfg: MoEConfig, probs: torch.Tensor, counts: torch.Tensor, n_assigned: int) -> torch.Tensor:
    """The Switch load-balance loss over the real ``n_experts``: weight · E
    · Σ_e mean_n(probs) · (assignments to e) / (N·k)."""
    ce = counts[:cfg.n_experts].to(torch.float32) / n_assigned
    return cfg.router_aux_weight * cfg.n_experts * torch.sum(probs.mean(0) * ce)


def _group_sizes(counts: torch.Tensor) -> list[int]:
    """The rows of each expert's group, on the host: the grouped dispatch's
    one wait for the device a call."""
    return counts.tolist()


class GroupedSwiGLU(torch.autograd.Function):
    """Each expert's SwiGLU over its own rows of the expert-sorted ``xs``
    (N·k, d): rows ``[lo, hi)`` of span ``(e, lo, hi)`` go through
    ``gate[e]``, ``up[e]`` (d, f) and ``down[e]`` (f, d), one product per
    expert and weight written into a preallocated output (the stacks are
    the cast ones). Saves ``xs``, the stacks and the gate and up
    pre-activations; the backward writes dxs and the stacks' gradients,
    each expert's slice by its own products, with zeros only for the
    experts that got no rows, and takes the forward's ``spans`` (no second
    wait). The elementwise steps are autograd's own for ``silu(g) * u``
    (the product's gradient rounded to the compute type, then
    ``silu_backward``); dxs adds its up product, rounded to the compute
    type, onto its gate product, rounded too (``addmm_``), so it rounds
    twice. Without a gradient to take ``_grouped_swiglu`` runs instead."""

    @staticmethod
    def forward(ctx, xs, gate, up, down, spans: list[tuple[int, int, int]]):
        g, u = _gate_up(xs, gate, up, spans)
        ys = _down(F.silu(g).mul_(u), down, spans, xs)
        ctx.save_for_backward(xs, gate, up, down, g, u)
        ctx.spans = spans
        return ys

    @staticmethod
    def backward(ctx, dys):
        xs, gate, up, down, g, u = ctx.saved_tensors
        spans = ctx.spans
        sg = F.silu(g)
        h = sg * u
        dh = torch.empty_like(g)
        dgate, dup, ddown = torch.empty_like(gate), torch.empty_like(up), torch.empty_like(down)
        for e, lo, hi in spans:
            torch.mm(dys[lo:hi], down[e].t(), out=dh[lo:hi])
            torch.mm(h[lo:hi].t(), dys[lo:hi], out=ddown[e])
        del h
        du = dh * sg
        dg = torch.ops.aten.silu_backward(dh.mul_(u), g)
        del dh, sg
        dxs = torch.empty_like(xs)
        for e, lo, hi in spans:
            torch.mm(xs[lo:hi].t(), dg[lo:hi], out=dgate[e])
            torch.mm(xs[lo:hi].t(), du[lo:hi], out=dup[e])
            torch.mm(dg[lo:hi], gate[e].t(), out=dxs[lo:hi])
            dxs[lo:hi].addmm_(du[lo:hi], up[e].t())
        for e in set(range(gate.shape[0])) - {e for e, _, _ in spans}:  # the experts that got no rows
            for grad in (dgate, dup, ddown):
                grad[e].zero_()
        return dxs, dgate, dup, ddown, None


def _gate_up(xs, gate, up, spans) -> tuple[torch.Tensor, torch.Tensor]:
    """The gate and up pre-activations (N·k, f), one product per expert each."""
    g = xs.new_empty((xs.shape[0], gate.shape[2]))
    u = torch.empty_like(g)
    for e, lo, hi in spans:
        torch.mm(xs[lo:hi], gate[e], out=g[lo:hi])
        torch.mm(xs[lo:hi], up[e], out=u[lo:hi])
    return g, u


def _down(h, down, spans, xs) -> torch.Tensor:
    ys = torch.empty_like(xs)
    for e, lo, hi in spans:
        torch.mm(h[lo:hi], down[e], out=ys[lo:hi])
    return ys


def _grouped_swiglu(xs, gate, up, down, spans) -> torch.Tensor:
    """``GroupedSwiGLU``'s forward where no gradient is taken (prefill under
    ``inference_mode``): silu(g)·u written over g and u freed before the
    down products, nothing saved. The same values."""
    g, u = _gate_up(xs, gate, up, spans)
    h = F.silu(g, inplace=True).mul_(u)
    del u
    return _down(h, down, spans, xs)


def _spans(sizes: list[int]) -> list[tuple[int, int, int]]:
    """(expert, first row, end row) of each expert with rows, from the group sizes."""
    out, lo = [], 0
    for e, c in enumerate(sizes):
        if c:
            out.append((e, lo, lo + c))
        lo += c
    return out


def _experts_grouped(m, xc: torch.Tensor, top_e: torch.Tensor, counts: torch.Tensor,
                     prec: Precision) -> torch.Tensor:
    """Each expert's SwiGLU over its own rows: the N·k assignments sorted by
    expert (stable), their tokens gathered, ``GroupedSwiGLU`` over them;
    the outputs (N, k, d) in the assignments' order (``_grouped_swiglu``
    where no gradient is taken)."""
    n, k = top_e.shape
    order = torch.argsort(top_e.reshape(-1), stable=True)
    xs = xc.index_select(0, order // k)
    args = (xs, prec.cast(m.gate), prec.cast(m.up), prec.cast(m.down), _spans(_group_sizes(counts)))
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:4]):
        ys = GroupedSwiGLU.apply(*args)
    else:
        ys = _grouped_swiglu(*args)
    del args
    return torch.empty_like(ys).index_copy_(0, order, ys).view(n, k, -1)


def _experts_gathered(m, xc: torch.Tensor, top_e: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Each assignment's SwiGLU through its expert's weights, gathered: one
    batched product per weight; the outputs (N, k, d)."""
    n, k = top_e.shape
    a_e = top_e.reshape(-1)
    xa = xc.repeat_interleave(k, dim=0).unsqueeze(1)                      # (N·k, 1, d)
    h = F.silu(torch.bmm(xa, prec.cast(m.gate.index_select(0, a_e))))
    h.mul_(torch.bmm(xa, prec.cast(m.up.index_select(0, a_e))))
    return torch.bmm(h, prec.cast(m.down.index_select(0, a_e))).view(n, k, -1)


def moe_apply(m, x: torch.Tensor, prec: Precision = MIXED,
              with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x (N, d) → (y (N, d) in x's type, the aux loss, fp32 0-d, or None
    without ``with_aux``: a decode step, which drops it, skips its work).
    ``m`` is a ``MoE`` (or anything with its ``cfg``, ``router``, ``gate``,
    ``up``, ``down`` and ``shared``). Grouped when the N·k assignments
    outnumber the experts, else gathered (no host sync)."""
    cfg = m.cfg
    n = x.shape[0]
    probs, top_w, top_e = route(m.router, x, cfg.top_k)
    e_total = m.gate.shape[0]
    grouped = top_e.numel() > e_total
    counts = aux = None
    if grouped or with_aux:
        counts = torch.zeros(e_total, dtype=torch.int64, device=x.device).index_add_(
            0, top_e.reshape(-1), torch.ones_like(top_e.reshape(-1)))
    if with_aux:
        aux = _aux_loss(cfg, probs, counts, top_e.numel())
    xc = prec.cast(x)
    if grouped:
        ye = _experts_grouped(m, xc, top_e, counts, prec)
    else:
        ye = _experts_gathered(m, xc, top_e, prec)
    w = top_w.to(x.dtype)  # the routing weight rounded to x's type before it multiplies
    acc = torch.zeros((n, ye.shape[2]), dtype=torch.float32, device=x.device)
    for j in range(cfg.top_k):  # summed in fp32, rounded once
        acc.addcmul_(ye[:, j], w[:, j, None])
    y = acc.to(ye.dtype)
    if m.shared is not None:
        y = y + m.shared(x, prec)
    return y.to(x.dtype), aux


def moe_dense_ref(m, x: torch.Tensor, prec: Precision = MIXED) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense form (``_moe_single``): every expert on every
    token, one-hot routing weights, (E, N, ·) products. The plain version
    that the tests and ``chip_smoke.py`` hold ``moe_apply`` to; on no path."""
    cfg = m.cfg
    probs, top_w, top_e = route(m.router, x, cfg.top_k)
    e_total = m.gate.shape[0]
    onehot = F.one_hot(top_e, e_total).to(x.dtype)                       # (N, k, E)
    w_e = (onehot * top_w[..., None].to(x.dtype)).sum(1)                 # (N, E)
    xc = prec.cast(x)
    g = F.silu(torch.einsum("nd,edf->enf", xc, prec.cast(m.gate)))
    u = torch.einsum("nd,edf->enf", xc, prec.cast(m.up))
    ye = torch.einsum("enf,efd->end", g * u, prec.cast(m.down))
    y = torch.einsum("end,ne->nd", ye, w_e.to(ye.dtype))
    counts = torch.zeros(e_total, dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), device=x.device))
    aux = _aux_loss(cfg, probs, counts, top_e.numel())
    if m.shared is not None:
        y = y + m.shared(x, prec)
    return y.to(x.dtype), aux
