"""Dense-side AdamW (port of ``repro/optim/adamw.py``; the ZeRO-1 specs and
gradient compression wait for the multi-rank slice).

Clips by the global norm over all gradients, decays every parameter
(biases included) and corrects the bias from the float32 step, as the
reference does; ``torch.optim.AdamW`` differs on the last two. Params and
moments are updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


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


@torch.no_grad()
def update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
           grads: Mapping[str, torch.Tensor], state: dict, step: torch.Tensor) -> dict:
    """One AdamW step, in place on ``params`` and ``state``; returns the
    state. ``step`` is 1-based."""
    step = step.to(torch.float32)
    scale = None
    if cfg.grad_clip_norm is not None:
        gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
        scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        if scale is not None:
            g = g * scale
        m, v = state["m"][k], state["v"][k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        p.copy_(p - cfg.lr * u)
    return state
