"""SparseAdam / SparseAdamW — row-wise lazy optimizer for Blocks (port of
``repro/optim/sparse_adam.py``).

Only the rows touched by the step are read, updated and written back. Moment
decay is lazy (untouched rows keep their moments) and bias correction uses
the global step. The rows are read through the gather kernel and the
deltas written back through the scatter-add kernel, in place: three
gathers and three scatters per dim-group and step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.blocks import Blocks
from repro_torch.kernels.fused_gather import ops as fg_ops
from repro_torch.kernels.fused_scatter import ops as fs_ops


@dataclasses.dataclass(frozen=True)
class SparseAdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # > 0 → SparseAdamW (decoupled decay)
    grad_clip_norm: float | None = None

    @property
    def slot_names(self) -> tuple[str, ...]:
        return ("m", "v")


def apply_row_updates(cfg: SparseAdamConfig, b: Blocks, offsets: torch.Tensor,
                      grads: torch.Tensor, valid: torch.Tensor, step: torch.Tensor) -> Blocks:
    """One Adam(W) step on exactly the touched rows, in place.

    offsets (k,) int32 rows, unique where ``valid``; grads (k, dim), the
    gradient of the loss in the gathered rows; step () 1-based global step.
    """
    step = step.to(torch.float32)
    g = grads.to(torch.float32)
    if cfg.grad_clip_norm is not None:
        gn = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        g = g * torch.clamp(cfg.grad_clip_norm / torch.clamp(gn, min=1e-12), max=1.0)

    off = torch.clamp(offsets, 0, b.n_rows - 1)
    m0 = fg_ops.gather_rows(b.slots["m"], off)
    v0 = fg_ops.gather_rows(b.slots["v"], off)
    w0 = fg_ops.gather_rows(b.emb, off)

    m1 = cfg.b1 * m0 + (1.0 - cfg.b1) * g
    v1 = cfg.b2 * v0 + (1.0 - cfg.b2) * g * g
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    upd = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps)
    if cfg.weight_decay > 0.0:
        upd = upd + cfg.weight_decay * w0

    fs_ops.scatter_add_rows(b.emb, off, -cfg.lr * upd, valid)
    fs_ops.scatter_add_rows(b.slots["m"], off, m1 - m0, valid)
    fs_ops.scatter_add_rows(b.slots["v"], off, v1 - v0, valid)
    return b
