"""Dense-side building blocks (port of ``repro/models/layers.py``).

Params live in fp32; ``Precision.compute_dtype`` is the type the dense
compute runs in (bf16 under ``MIXED``). As in the reference, a dense layer
casts its input, its weight and its bias to the compute type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Precision:
    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


FP32 = Precision(compute_dtype=torch.float32)
MIXED = Precision()


def uniform_(t: torch.Tensor, s: float, gen: torch.Generator) -> None:
    """t ~ U(-s, s), drawn on ``gen``'s device and copied into t: from a
    CPU generator (the package's default) every device gets the same
    numbers from one seed; from a card's generator a model on that card is
    drawn where it lies."""
    w = torch.empty(t.shape, dtype=torch.float32, device=gen.device).uniform_(-s, s, generator=gen)
    with torch.no_grad():
        t.copy_(w)


def dense_init_(layer: nn.Linear, gen: torch.Generator) -> None:
    """weight ~ U(-1/sqrt(d_in), 1/sqrt(d_in)) (``uniform_``), bias (if any) = 0."""
    uniform_(layer.weight, 1.0 / np.sqrt(layer.weight.shape[1]), gen)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def dense(d_in: int, d_out: int, gen: torch.Generator, bias: bool = True, device=None) -> nn.Linear:
    """An ``nn.Linear`` drawn by ``dense_init_`` (the reference's ``make_dense``)."""
    layer = nn.Linear(d_in, d_out, bias=bias, device=device)
    dense_init_(layer, gen)
    return layer


def dense_apply(layer: nn.Linear, x: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
    b = layer.bias
    return F.linear(prec.cast(x), prec.cast(layer.weight), None if b is None else prec.cast(b))


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x²) + eps) * scale`` in fp32, returned in x's type;
    ``scale`` starts at ones."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * self.scale).to(x.dtype)


class MLP(nn.Module):
    """dims = (d_in, h1, ..., d_out), layers ``l0``, ``l1``, ...; ReLU
    between layers (and after the last when ``final_act``)."""

    def __init__(self, dims: tuple[int, ...], gen: torch.Generator, device=None):
        super().__init__()
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"l{i}", dense(dims[i], dims[i + 1], gen, device=device))

    def forward(self, x: torch.Tensor, prec: Precision = MIXED, final_act: bool = False) -> torch.Tensor:
        for i in range(self.n_layers):
            x = dense_apply(getattr(self, f"l{i}"), x, prec)
            if i < self.n_layers - 1 or final_act:
                x = F.relu(x)
        return x


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) · up(x))``, no biases."""

    def __init__(self, d_model: int, d_ff: int, gen: torch.Generator, device=None):
        super().__init__()
        self.gate = dense(d_model, d_ff, gen, bias=False, device=device)
        self.up = dense(d_model, d_ff, gen, bias=False, device=device)
        self.down = dense(d_ff, d_model, gen, bias=False, device=device)

    def forward(self, x: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
        g = F.silu(dense_apply(self.gate, x, prec))
        return dense_apply(self.down, g * dense_apply(self.up, x, prec), prec)


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with fp32 statistics,
    returned in x's type; ``scale`` starts at ones, ``bias`` at zeros (the
    reference's ``make_layernorm`` / ``layernorm_apply``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        return ((xf - mu) * torch.rsqrt(var + eps) * self.scale + self.bias).to(x.dtype)


class Embedding(nn.Module):
    """A small dense table (positions and the like, not the sparse engine):
    ``table`` ~ N(0, 0.02²), drawn on the CPU from ``gen``; a lookup returns
    the rows in the compute type (the reference's ``make_embedding`` /
    ``embedding_apply``)."""

    def __init__(self, n: int, dim: int, gen: torch.Generator, device=None):
        super().__init__()
        table = torch.randn((n, dim), generator=gen, dtype=torch.float32) * 0.02
        self.table = nn.Parameter(table.to(device))

    def forward(self, ids: torch.Tensor, prec: Precision = MIXED) -> torch.Tensor:
        return prec.cast(self.table[ids])
