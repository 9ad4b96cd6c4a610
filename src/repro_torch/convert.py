"""Weights and state carried across from the JAX package's formats.

Dense params: the reference keeps a nested dict of numpy-convertible arrays
``{"bot": {"l0": {"w": (d_in, d_out), "b": (d_out,)}, ...}, "top": ...}``;
``dense_from_numpy`` turns it into the port's ``DLRM`` state dict
(``nn.Linear.weight`` is (d_out, d_in), so ``w`` is transposed). The AdamW
moments ``{"m": tree, "v": tree}`` have the params' layout and convert the
same way (``adamw_from_numpy``).

Engine rows need no converter: the dict the reference's
``EmbeddingEngine.export_rows`` returns is what the port's ``import_rows``
takes.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.recsys.dlrm import DLRMConfig


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
