"""Weights and state carried across from the JAX package's formats.

Dense params: the reference keeps a nested dict of numpy-convertible arrays
``{"bot": {"l0": {"w": (d_in, d_out), "b": (d_out,)}, ...}, "top": ...}``;
``dense_from_numpy`` turns it into the port's ``DLRM`` state dict
(``nn.Linear.weight`` is (d_out, d_in), so ``w`` is transposed). The AdamW
moments ``{"m": tree, "v": tree}`` have the params' layout and convert the
same way (``adamw_from_numpy``). The transformer's tree stacks every layer
leaf on axis 0; ``transformer_from_numpy`` unstacks it into ``layers.{i}``.

Engine rows need no converter: the dict the reference's
``EmbeddingEngine.export_rows`` returns is what the port's ``import_rows``
takes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.recsys.dlrm import DLRMConfig
from repro_torch.models.transformer import TransformerConfig


def dense_from_numpy(tree: Mapping, cfg: DLRMConfig) -> dict[str, torch.Tensor]:
    """Reference dense param tree → state dict for ``DLRM(cfg)``."""
    out = {}
    for part, dims in (("bot", cfg.bot_dims()), ("top", cfg.top_dims())):
        layers = tree[part]
        if len(layers) != len(dims) - 1:
            raise ValueError(f"{part}: {len(layers)} layers, config has {len(dims) - 1}")
        for i in range(len(dims) - 1):
            w = np.asarray(layers[f"l{i}"]["w"], dtype=np.float32)
            b = np.asarray(layers[f"l{i}"]["b"], dtype=np.float32)
            if w.shape != (dims[i], dims[i + 1]) or b.shape != (dims[i + 1],):
                raise ValueError(f"{part}.l{i}: shapes {w.shape}, {b.shape} do not fit {dims}")
            out[f"{part}.l{i}.weight"] = torch.tensor(w.T)
            out[f"{part}.l{i}.bias"] = torch.tensor(b)
    return out


def adamw_from_numpy(opt: Mapping, cfg: DLRMConfig) -> dict:
    """Reference AdamW state ``{"m": tree, "v": tree}`` → the port's
    ``{"m": {param name: tensor}, "v": {...}}``, on the CPU like
    ``dense_from_numpy``."""
    return {k: dense_from_numpy(opt[k], cfg) for k in ("m", "v")}


def _linear(p: Mapping, name: str, d_in: int, d_out: int, bias: bool) -> dict[str, torch.Tensor]:
    """{"w": (d_in, d_out), "b": (d_out,)} → nn.Linear's weight (and bias)."""
    w = np.asarray(p["w"], dtype=np.float32)
    if w.shape != (d_in, d_out) or ("b" in p) != bias:
        raise ValueError(f"{name}: w {w.shape}, bias {'b' in p}; expected ({d_in}, {d_out}), bias {bias}")
    out = {f"{name}.weight": torch.tensor(w.T)}
    if bias:
        out[f"{name}.bias"] = torch.tensor(np.asarray(p["b"], dtype=np.float32))
    return out


def transformer_from_numpy(tree: Mapping, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """Reference transformer tree ``{"layers": {...stacked on axis 0},
    "final_norm": {"scale"}, "head": {"w"}}`` → state dict for
    ``Transformer(cfg)``."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    linears = {"attn.wq": (d, cfg.n_heads * hd, cfg.qkv_bias),
               "attn.wk": (d, cfg.n_kv_heads * hd, cfg.qkv_bias),
               "attn.wv": (d, cfg.n_kv_heads * hd, cfg.qkv_bias),
               "attn.wo": (cfg.n_heads * hd, d, False),
               "ffn.gate": (d, cfg.d_ff, False), "ffn.up": (d, cfg.d_ff, False),
               "ffn.down": (cfg.d_ff, d, False)}
    layers = tree["layers"]
    n = np.asarray(layers["attn_norm"]["scale"]).shape[0]
    if n != L:
        raise ValueError(f"tree has {n} layers, config has {L}")
    out = {}
    for i in range(L):
        for norm in ("attn_norm", "ffn_norm"):
            out[f"layers.{i}.{norm}.scale"] = torch.tensor(np.asarray(layers[norm]["scale"][i], np.float32))
        for name, (d_in, d_out, bias) in linears.items():
            part, leaf = name.split(".")
            p = {k: np.asarray(v)[i] for k, v in layers[part][leaf].items()}
            out.update(_linear(p, f"layers.{i}.{name}", d_in, d_out, bias))
    out["final_norm.scale"] = torch.tensor(np.asarray(tree["final_norm"]["scale"], np.float32))
    out.update(_linear(tree["head"], "head", d, cfg.vocab_size, False))
    return out
