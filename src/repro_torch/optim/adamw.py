"""Dense-side AdamW with ZeRO-1 sharding and compressed gradient sums (port
of ``repro/optim/adamw.py``).

Clips by the global norm over all gradients, decays every parameter
(biases included) and corrects the bias from the float32 step, as the
reference does; ``torch.optim.AdamW`` differs on the last two. Params and
moments are updated in place.

ZeRO-1 (``zero1_pspec``, ``zero1_init``, ``zero1_update``): each rank of a
data-parallel group keeps ``m`` and ``v`` for its slice of every large
param only (the dimension the reference's rule picks), updates that slice
and all-gathers the params; the result is the unsharded ``update``'s, bit
for bit. ``compressed_psum`` sums a gradient over a group as int8 with a
shared scale and error feedback, the reference's bandwidth option for
manual data parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.distributed as dist

from repro_torch.core import comm


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: float | None = 1.0


def init(params: Mapping[str, torch.Tensor]) -> dict:
    def z():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    return {"m": z(), "v": z()}


def _prologue(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], step: torch.Tensor):
    """The global-norm clip scale (None without clipping) and the two bias
    corrections of a step."""
    step = step.to(torch.float32)
    scale = None
    if cfg.grad_clip_norm is not None:
        gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return scale, 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step


def _step_param(cfg: AdamWConfig, p, g, m, v, scale, bc1, bc2) -> torch.Tensor:
    """Moments updated in place; returns the new param values."""
    g = g.to(torch.float32)
    if scale is not None:
        g = g * scale
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
    u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
    return p - cfg.lr * u


@torch.no_grad()
def update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: dict, step: torch.Tensor) -> dict:
    """One AdamW step, in place on ``params`` and ``state``; returns the
    state. ``step`` is 1-based."""
    scale, bc1, bc2 = _prologue(cfg, grads, step)
    for k, p in params.items():
        p.copy_(_step_param(cfg, p, grads[k], state["m"][k], state["v"][k], scale, bc1, bc2))
    return state


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer state sharded over the data-parallel group
# ---------------------------------------------------------------------------

def zero1_pspec(param_specs: Mapping[str, tuple], params: Mapping[str, torch.Tensor],
                shard_axis: str = "data", min_size: int = 1 << 16) -> dict[str, tuple]:
    """The reference's rule on PartitionSpec-like tuples (one entry a
    dimension: a mesh axis name, or None where unsharded; a short tuple
    leaves the rest unsharded): a param of at least ``min_size`` elements
    gains ``shard_axis`` on its first unsharded dimension of size 128 or
    more; the others keep their spec."""
    out = {}
    for k, p in params.items():
        spec = tuple(param_specs.get(k, ()))
        out[k] = spec
        if p.numel() < min_size:
            continue
        entries = list(spec) + [None] * (p.dim() - len(spec))
        for i, (e, d) in enumerate(zip(entries, p.shape)):
            if e is None and d >= 128:
                entries[i] = shard_axis
                out[k] = tuple(entries)
                break
    return out


def zero1_dims(param_specs: Mapping[str, tuple], params: Mapping[str, torch.Tensor],
               min_size: int = 1 << 16) -> dict[str, int | None]:
    """Each param's ZeRO-1 dimension (``zero1_pspec``'s), or None."""
    marker = object()
    specs = zero1_pspec(param_specs, params, marker, min_size)
    return {k: next((i for i, e in enumerate(s) if e is marker), None) for k, s in specs.items()}


def _span(n: int, group) -> tuple[int, int]:
    """This rank's [lo, lo + len) of a dimension of size n cut in D chunks
    of ceil(n / D) (the last ones shorter, or empty)."""
    chunk = -(-n // comm.size(group))
    lo = min(comm.rank(group) * chunk, n)
    return lo, min(chunk, n - lo)


def zero1_init(params: Mapping[str, torch.Tensor], dims: Mapping[str, int | None], group) -> dict:
    """AdamW moments of this rank's slice of every sharded param (whole
    moments for the others)."""
    def z():
        out = {}
        for k, p in params.items():
            x = p if dims[k] is None else p.narrow(dims[k], *_span(p.shape[dims[k]], group))
            out[k] = torch.zeros_like(x, dtype=torch.float32)
        return out

    return {"m": z(), "v": z()}


def _gather_dim(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """Every rank's slice along ``dim`` (padded to one chunk for the
    collective), in rank order, cut back to size n."""
    chunk = -(-n // comm.size(group))
    pad = list(x.shape)
    pad[dim] = chunk - x.shape[dim]
    full = torch.cat([x, x.new_zeros(pad)], dim=dim) if pad[dim] else x
    return torch.cat(comm.all_gather(full, group).unbind(0), dim=dim).narrow(dim, 0, n)


@torch.no_grad()
def zero1_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: dict, step: torch.Tensor,
                 dims: Mapping[str, int | None], group) -> dict:
    """``update`` with the moments of ``zero1_init``: every rank takes the
    same clip scale from the whole (already summed) gradients, updates its
    slice, and the params are all-gathered, in parameter order on every
    rank. Equal to ``update``, element for element."""
    scale, bc1, bc2 = _prologue(cfg, grads, step)
    for k, p in params.items():
        m, v, d = state["m"][k], state["v"][k], dims[k]
        if d is None:
            p.copy_(_step_param(cfg, p, grads[k], m, v, scale, bc1, bc2))
            continue
        lo, n = _span(p.shape[d], group)
        new = _step_param(cfg, p.narrow(d, lo, n), grads[k].narrow(d, lo, n), m, v, scale, bc1, bc2)
        p.copy_(_gather_dim(new, d, p.shape[d], group))
    return state


# ---------------------------------------------------------------------------
# gradient compression (int8 and error feedback) for manual data parallelism
# ---------------------------------------------------------------------------

def quantize(gf: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, int8 payload) of fp32 ``gf`` under the group's ``amax``:
    round half to even, as ``jnp.round``."""
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return scale, torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def compressed_psum(g: torch.Tensor, group, error: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantise to int8 with one scale shared by the group (an all-reduce
    MAX of |g + error|), sum the payloads exactly in int32, dequantise; the
    quantisation residual is carried as the new error feedback. Returns
    (the summed gradient, new_error)."""
    gf = g.to(torch.float32) + error
    amax = comm.all_reduce(torch.max(torch.abs(gf)).reshape(1), group, dist.ReduceOp.MAX)[0]
    scale, q = quantize(gf, amax)
    # the residual rounded once, as the fused multiply-add XLA emits for it:
    # q * scale is exact in float64 (8 + 24 significant bits)
    new_error = (gf.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)
    summed = comm.all_reduce(q.to(torch.int32), group).to(torch.float32)
    return summed * scale, new_error
