"""Weights and state carried across from the JAX package's formats.

Dense params: the reference keeps a nested dict of numpy-convertible arrays
``{"bot": {"l0": {"w": (d_in, d_out), "b": (d_out,)}, ...}, "top": ...}``;
``dense_from_numpy`` turns it into the port's ``DLRM`` state dict
(``nn.Linear.weight`` is (d_out, d_in), so ``w`` is transposed). The AdamW
moments ``{"m": tree, "v": tree}`` have the params' layout and convert the
same way (``adamw_from_numpy``). The transformer's tree stacks every layer
leaf on axis 0; ``transformer_from_numpy`` unstacks it into ``layers.{i}``.
``mse_dense_from_numpy`` takes the MSE example's attention projections and
DNN. ``linears_to_numpy`` gives any module of linears back in the
reference's layout, and ``linears_from_numpy`` takes it in again.

Engine rows need no converter: the dict the reference's
``EmbeddingEngine.export_rows`` returns is what the port's ``import_rows``
takes. ``sparse_to_tree`` lays the engine state out as the reference's
pytree flattens it (a Blocks as ``(emb, (slots by name))``, an IDMap as the
tuple of its tensor fields), and ``train_state_to_tree`` a whole MSE or
DLRM train state, so a checkpoint holds the reference's leaf names
(``state/dense/attn_k/w``, ``state/sparse/dim8/idmap/2``, ...) and a
checkpoint of either package restores in the other.

A tiered engine's state comes across two ways. The reference's union
``export_rows`` (both tiers, with per-id counts) is what a tiered engine's
``import_rows`` takes: it refills the device tier with the hottest rows and
the host tier with the rest. Or the device tier as a pytree (the layout
above) with the store's ``checkpoint_payload``, which
``tiered_state_from_numpy`` loads as they are; the same keys name the host
tier in a checkpoint's ``extra.safetensors``, so the reference's tiered
checkpoint resumes through the port's Trainer hooks unchanged.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib, idmap as idmap_lib
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


def mse_dense_from_numpy(tree: Mapping, dim: int = 8,
                         dnn_dims: tuple[int, ...] = (496, 64, 64, 32, 32, 1)) -> dict[str, torch.Tensor]:
    """The MSE example's dense tree ``{"attn_q": dense, "attn_k": dense,
    "dnn": mlp}`` (``examples/train_mse.py``) → state dict for the twin's
    ``MSEDense`` (``repro_torch/examples/train_mse.py``)."""
    out = {}
    for name in ("attn_q", "attn_k"):
        out.update(_linear(tree[name], name, dim, dim, True))
    out.update(mlp_from_numpy(tree["dnn"], dnn_dims, "dnn."))
    return out


def mlp_from_numpy(layers: Mapping, dims: tuple[int, ...], prefix: str = "") -> dict[str, torch.Tensor]:
    """The reference's ``make_mlp`` tree ``{"l0": {"w", "b"}, ...}`` → state
    dict for ``layers.MLP(dims)``, its keys under ``prefix``."""
    if len(layers) != len(dims) - 1:
        raise ValueError(f"{prefix or 'mlp'}: {len(layers)} layers, expected {len(dims) - 1}")
    out = {}
    for i in range(len(dims) - 1):
        out.update(_linear(layers[f"l{i}"], f"{prefix}l{i}", dims[i], dims[i + 1], True))
    return out


def linears_to_numpy(sd: Mapping[str, torch.Tensor]) -> dict:
    """A state dict of ``nn.Linear`` layers (or AdamW moments keyed alike)
    → the reference's nested tree: ``a.b.weight`` becomes ``{"a": {"b":
    {"w": (d_in, d_out)}}}`` and ``a.b.bias`` its ``"b"``. The tensors stay
    where they are (``w`` is a transposed view)."""
    out: dict = {}
    for key, x in sd.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[{"weight": "w", "bias": "b"}[leaf]] = x.t() if leaf == "weight" else x
    return out


def linears_from_numpy(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The inverse of ``linears_to_numpy``: the reference's nested tree of
    numpy leaves → a state dict on the CPU, ``w`` transposed."""
    out = {}
    for key, x in tree.items():
        if isinstance(x, Mapping):
            out.update(linears_from_numpy(x, f"{prefix}{key}."))
        else:
            a = np.asarray(x, dtype=np.float32)
            out[prefix + {"w": "weight", "b": "bias"}[key]] = torch.tensor(a.T if key == "w" else a)
    return out


def sparse_to_tree(sparse: Mapping) -> dict:
    """One device's engine state ``{group: {"idmap", "blocks"}}`` in the
    reference's pytree layout (the tensors themselves, not copies)."""
    return {g: {"blocks": (v["blocks"].emb, tuple(v["blocks"].slots[k] for k in sorted(v["blocks"].slots))),
                "idmap": tuple(getattr(v["idmap"], f) for f in idmap_lib.TENSOR_FIELDS)}
            for g, v in sparse.items()}


def sparse_from_tree(tree: Mapping, like: Mapping, device) -> dict:
    """The inverse of ``sparse_to_tree``: numpy leaves → an engine state on
    ``device`` shaped like ``like`` (which gives the static fields)."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)  # a copy: the step writes it in place

    out = {}
    for g, v in like.items():
        emb, slot_vals = tree[g]["blocks"]
        out[g] = {"idmap": idmap_lib.IDMap(*map(t, tree[g]["idmap"]), n_rows=v["idmap"].n_rows,
                                           max_probes=v["idmap"].max_probes),
                  "blocks": blocks_lib.Blocks(emb=t(emb), slots=dict(zip(sorted(v["blocks"].slots),
                                                                         map(t, slot_vals))))}
    return out


def tiered_state_from_numpy(engine, sparse: Mapping, payload: Mapping[str, np.ndarray] | None) -> dict:
    """The reference's tiered engine state in the port: ``sparse``, the
    device tier as ``sparse_to_tree`` lays it out (numpy leaves, stacked
    [D, ...]), goes onto ``engine.device``; ``payload``, the reference
    store's ``checkpoint_payload``, becomes ``engine.storage``'s host tier
    and access counts; the residency mirror is rebuilt from the IDMaps."""
    if engine.storage is None:
        raise ValueError("the engine has no tiered store (EngineConfig.storage)")
    state = sparse_from_tree(sparse, engine.init_state(), engine.device)
    engine.storage.restore_payload(payload)
    engine.storage.sync_from_state(state)
    return state


def train_state_to_tree(state: Mapping) -> dict:
    """A train state ``{"step", "dense": module of linears, "opt": {"m",
    "v"}, "sparse"}`` (the MSE example's twin, or the recsys cell's with its
    engine state stacked [1, ...]) in the layout of the reference's state.
    A state without ``sparse`` (a delta frame's dense part) gives a tree
    without it."""
    tree = {"step": state["step"], "dense": linears_to_numpy(state["dense"].state_dict()),
            "opt": {k: linears_to_numpy(state["opt"][k]) for k in ("m", "v")}}
    if "sparse" in state:
        tree["sparse"] = sparse_to_tree(state["sparse"])
    return tree


def train_state_from_tree(state: Mapping, tree: Mapping) -> dict:
    """The inverse of ``train_state_to_tree``: the reference-layout tree of
    numpy leaves loaded into ``state`` (its module and AdamW moments in
    place, a new step and engine state on the same device); a cell's
    ``load_state_tree``."""
    model = state["dense"]
    device = next(model.parameters()).device
    model.load_state_dict(linears_from_numpy(tree["dense"]))
    with torch.no_grad():
        for k in ("m", "v"):
            for name, x in linears_from_numpy(tree["opt"][k]).items():
                dst = state["opt"][k][name]
                if dst.shape != x.shape:
                    raise ValueError(f"opt/{k}/{name}: shape {tuple(x.shape)}, state has {tuple(dst.shape)}")
                dst.copy_(x)
    out = {"step": torch.tensor(np.asarray(tree["step"]), dtype=torch.int32, device=device),
           "dense": model, "opt": state["opt"]}
    if "sparse" in tree:
        out["sparse"] = sparse_from_tree(tree["sparse"], state["sparse"], device)
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
