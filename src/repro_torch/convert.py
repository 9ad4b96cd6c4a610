"""Weights and state carried across from the JAX package's formats.

Dense params: the reference keeps a nested dict of numpy-convertible arrays
(``{"bot": {"l0": {"w": (d_in, d_out), "b": (d_out,)}, ...}, "top": ...}``
for DLRM). ``params_from_tree(model, tree)`` turns it into a state dict for
the port's module (``nn.Linear.weight`` is (d_out, d_in), so ``w`` is
transposed; every other parameter, such as a LayerNorm's ``scale`` and
``bias``, SASRec's ``pos_emb``, MIND's ``S`` or Wide & Deep's 0-d
``bias``, keeps its name and layout), and ``params_to_tree`` gives it
back. The AdamW moments ``{"m": tree, "v": tree}`` have the params' layout
and convert the same way. The transformer's tree stacks every layer leaf
on axis 0; ``transformer_from_numpy`` unstacks it into ``layers.{i}``.
``gin_from_numpy`` turns the reference's GIN params into a state dict for
``models/gnn.GIN``.

Engine rows need no converter: the dict the reference's
``EmbeddingEngine.export_rows`` returns is what the port's ``import_rows``
takes. ``sparse_to_tree`` lays the engine state out as the reference's
pytree flattens it (a Blocks as ``(emb, (slots by name))``, an IDMap as the
tuple of its tensor fields), and ``train_state_to_tree`` a whole MSE or
recsys train state, so a checkpoint holds the reference's leaf names
(``state/dense/attn_k/w``, ``state/dense/block0/ln1/scale``,
``state/sparse/dim8/idmap/2``, ...) and a checkpoint of either package
restores in the other.

A tiered engine's state comes across two ways. The reference's union
``export_rows`` (both tiers, with per-id counts) is what a tiered engine's
``import_rows`` takes: it refills the device tier with the hottest rows and
the host tier with the rest. Or the device tier as a pytree (the layout
above) with the store's ``checkpoint_payload``, which
``tiered_state_from_numpy`` loads as they are; the same keys name the host
tier in a checkpoint's ``extra.safetensors``, so the reference's tiered
checkpoint resumes through the port's Trainer hooks unchanged.

The LM train state crosses with ``lm_train_state_to_tree`` and
``lm_train_state_from_tree``: the transformer and AdamW's ``m`` and ``v``
in the reference's stacked-layer tree (``transformer_to_numpy``, the
inverse of ``transformer_from_numpy``), so an LM checkpoint holds
``state/dense/layers/attn/wq/w``, ``state/opt/m/layers/ffn/gate/w``,
``state/dense/layers/moe/router``, ``state/sparse/dim2048/idmap/0`` and
``state/step`` as the reference's does, and restores in either package.

``decode_state_from_numpy`` loads the reference decode cell's whole state
(dense params, engine state, KV cache, ``pos``) into a port decode cell's
state; over a group each rank takes its shard of the engine state and its
slice of the cache.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core import blocks as blocks_lib, idmap as idmap_lib
from repro_torch.models import gnn
from repro_torch.models.transformer import TransformerConfig


def _linear(p: Mapping, name: str, d_in: int, d_out: int, bias: bool) -> dict[str, torch.Tensor]:
    """{"w": (d_in, d_out), "b": (d_out,)} → nn.Linear's weight (and bias)."""
    w = np.asarray(p["w"], dtype=np.float32)
    if w.shape != (d_in, d_out) or ("b" in p) != bias:
        raise ValueError(f"{name}: w {w.shape}, bias {'b' in p}; expected ({d_in}, {d_out}), bias {bias}")
    out = {f"{name}.weight": torch.tensor(w.T)}
    if bias:
        out[f"{name}.bias"] = torch.tensor(np.asarray(p["b"], dtype=np.float32))
    return out


def tree_paths(model: nn.Module) -> dict[str, tuple[tuple[str, ...], bool]]:
    """Each parameter name of ``model`` → (its key path in the reference's
    dense tree, whether it is stored transposed). An ``nn.Linear``'s
    ``weight`` and ``bias`` are the reference's ``w`` (d_in, d_out) and
    ``b``; every other parameter (a LayerNorm's ``scale`` and ``bias``,
    ``pos_emb``, MIND's ``S``, Wide & Deep's 0-d ``bias``) keeps its name
    and layout."""
    linear = {n for n, m in model.named_modules() if isinstance(m, nn.Linear)}
    out = {}
    for name, _ in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        path = tuple(mod.split(".")) if mod else ()
        if mod in linear:
            out[name] = (path + ({"weight": "w", "bias": "b"}[leaf],), leaf == "weight")
        else:
            out[name] = (path + (leaf,), False)
    return out


def params_to_tree(model: nn.Module, named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors keyed by ``model``'s parameter names (its state dict, or
    AdamW moments keyed alike) → the reference's nested tree. The tensors
    stay where they are (``w`` is a transposed view)."""
    paths = tree_paths(model)
    out: dict = {}
    for name, x in named.items():
        path, transposed = paths[name]
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = x.t() if transposed else x
    return out


def _leaf_paths(tree: Mapping, prefix: tuple[str, ...] = ()):
    """The key path of each leaf of a nested mapping."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def params_from_tree(model: nn.Module, tree: Mapping) -> dict[str, torch.Tensor]:
    """The inverse of ``params_to_tree``: the reference's nested tree of
    numpy-convertible leaves → a state dict for ``model`` on the CPU, each
    shape checked. A leaf of ``tree`` that no parameter takes is an error."""
    params, paths = dict(model.named_parameters()), tree_paths(model)
    extra = sorted(set(_leaf_paths(tree)) - {path for path, _ in paths.values()})
    if extra:
        raise ValueError(f"leaves with no parameter of {type(model).__name__}: {['/'.join(p) for p in extra]}")
    out = {}
    for name, (path, transposed) in paths.items():
        node = tree
        for part in path:
            node = node[part]
        a = np.asarray(node, dtype=np.float32)
        x = torch.tensor(a.T if transposed else a)
        if x.shape != params[name].shape:
            raise ValueError(f"{'/'.join(path)}: shape {a.shape} does not fit {name} {tuple(params[name].shape)}")
        out[name] = x
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


def _state_to_tree(state: Mapping, to_tree) -> dict:
    """A train state ``{"step", "dense": module, "opt": {"m", "v"},
    ["sparse"]}`` in the reference's layout, ``to_tree(model, named)``
    laying out the params and each moment."""
    model = state["dense"]
    tree = {"step": state["step"], "dense": to_tree(model, model.state_dict()),
            "opt": {k: to_tree(model, state["opt"][k]) for k in ("m", "v")}}
    if "sparse" in state:
        tree["sparse"] = sparse_to_tree(state["sparse"])
    return tree


def _state_from_tree(state: Mapping, tree: Mapping, from_tree) -> dict:
    """The inverse of ``_state_to_tree``: ``from_tree(model, subtree)``
    gives a state dict on the CPU, loaded into the module and the AdamW
    moments in place, each shape checked; a new step and engine state on
    the module's device."""
    model = state["dense"]
    device = next(model.parameters()).device
    model.load_state_dict(from_tree(model, tree["dense"]))
    with torch.no_grad():
        for k in ("m", "v"):
            for name, x in from_tree(model, tree["opt"][k]).items():
                dst = state["opt"][k][name]
                if dst.shape != x.shape:
                    raise ValueError(f"opt/{k}/{name}: shape {tuple(x.shape)}, state has {tuple(dst.shape)}")
                dst.copy_(x)
    out = {"step": torch.tensor(np.asarray(tree["step"]), dtype=torch.int32, device=device),
           "dense": model, "opt": state["opt"]}
    if "sparse" in tree:
        out["sparse"] = sparse_from_tree(tree["sparse"], state["sparse"], device)
    return out


def train_state_to_tree(state: Mapping) -> dict:
    """A train state ``{"step", "dense": module, "opt": {"m", "v"},
    "sparse"}`` (the MSE example's twin, or a recsys cell's with its engine
    state stacked [1, ...]) in the layout of the reference's state.
    A state without ``sparse`` (a delta frame's dense part) gives a tree
    without it."""
    return _state_to_tree(state, params_to_tree)


def train_state_from_tree(state: Mapping, tree: Mapping) -> dict:
    """The inverse of ``train_state_to_tree``: the reference-layout tree of
    numpy leaves loaded into ``state`` (its module and AdamW moments in
    place, a new step and engine state on the same device); a cell's
    ``load_state_tree``."""
    return _state_from_tree(state, tree, params_from_tree)


def lm_train_state_to_tree(state: Mapping) -> dict:
    """An LM train cell's state ``{"step", "dense": Transformer, "opt":
    {"m", "v"}, "sparse"}`` in the layout of the reference's: the params and
    each moment as ``transformer_to_numpy`` stacks them. A state without
    ``sparse`` gives a tree without it."""
    return _state_to_tree(state, lambda model, named: _transformer_tree(named, model.cfg))


def lm_train_state_from_tree(state: Mapping, tree: Mapping) -> dict:
    """The inverse of ``lm_train_state_to_tree``, loaded into ``state`` as
    ``train_state_from_tree`` loads a recsys state; the LM train cell's
    ``load_state_tree``."""
    return _state_from_tree(state, tree, lambda model, sub: transformer_from_numpy(sub, model.cfg))


def transformer_from_numpy(tree: Mapping, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """Reference transformer tree ``{"layers": {...stacked on axis 0},
    "final_norm": {"scale"}, "head": {"w"}}`` → state dict for
    ``Transformer(cfg)``. A MoE layer's ``moe`` subtree: ``router`` (d, E),
    ``gate``, ``up`` (E, d, f) and ``down`` (E, f, d) kept as they are, the
    shared experts' ``shared.{gate, up, down}`` matrices as ``nn.Linear``
    weights; its expert count must be the config's (one device: unpadded)."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    linears = {"attn.wq": (d, cfg.n_heads * hd, cfg.qkv_bias),
               "attn.wk": (d, cfg.n_kv_heads * hd, cfg.qkv_bias),
               "attn.wv": (d, cfg.n_kv_heads * hd, cfg.qkv_bias),
               "attn.wo": (cfg.n_heads * hd, d, False)}
    m = cfg.moe
    if m is None:
        linears.update({"ffn.gate": (d, cfg.d_ff, False), "ffn.up": (d, cfg.d_ff, False),
                        "ffn.down": (cfg.d_ff, d, False)})
    else:
        experts = {"router": (d, m.n_experts), "gate": (m.n_experts, d, m.d_ff),
                   "up": (m.n_experts, d, m.d_ff), "down": (m.n_experts, m.d_ff, d)}
        fs = m.n_shared * m.d_ff
        shared = {"gate": (d, fs), "up": (d, fs), "down": (fs, d)} if m.n_shared else {}
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
        if m is None:
            continue
        for leaf, shape in experts.items():
            w = np.asarray(layers["moe"][leaf][i], np.float32)
            if w.shape != shape:
                raise ValueError(f"layers.{i}.moe.{leaf}: {w.shape}; expected {shape}")
            out[f"layers.{i}.moe.{leaf}"] = torch.tensor(w)
        for leaf, (d_in, d_out) in shared.items():
            p = {"w": np.asarray(layers["moe"]["shared"][leaf])[i]}
            out.update(_linear(p, f"layers.{i}.moe.shared.{leaf}", d_in, d_out, False))
    out["final_norm.scale"] = torch.tensor(np.asarray(tree["final_norm"]["scale"], np.float32))
    out.update(_linear(tree["head"], "head", d, cfg.vocab_size, False))
    return out


def _transformer_path(name: str) -> tuple[tuple[str, ...], int | None, bool]:
    """A ``Transformer`` state-dict name → (its key path in the reference's
    tree, its layer (stacked on axis 0) or None, whether it is stored
    transposed). An ``nn.Linear``'s ``weight`` is the reference's ``w``
    (d_in, d_out) and its ``bias`` ``b``; the shared experts' matrices are
    bare arrays (``moe/shared/gate``); every other leaf keeps its name."""
    parts, layer = name.split("."), None
    if parts[0] == "layers":
        layer, parts = int(parts[1]), ["layers", *parts[2:]]
    if parts[-1] == "weight":
        return tuple(parts[:-1] if "shared" in parts else [*parts[:-1], "w"]), layer, True
    if parts[-1] == "bias":
        return tuple([*parts[:-1], "b"]), layer, False
    return tuple(parts), layer, False


def _transformer_tree(named: Mapping[str, torch.Tensor], cfg: TransformerConfig) -> dict:
    """Tensors keyed by ``Transformer(cfg)``'s parameter names (its state
    dict, or AdamW moments keyed alike) → the reference's tree of float32
    numpy arrays, every layer leaf stacked on axis 0 in layer order."""
    stacks: dict[tuple[str, ...], list] = {}
    tree: dict = {}
    for name, x in named.items():
        path, layer, transposed = _transformer_path(name)
        a = x.detach().to("cpu", torch.float32).numpy()
        a = a.T if transposed else a
        if layer is None:
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = np.array(a, order="C")  # a copy: the step updates the params in place
        else:
            stacks.setdefault(path, [None] * cfg.n_layers)[layer] = a
    for path, per_layer in stacks.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = out = np.empty((cfg.n_layers, *per_layer[0].shape), np.float32)
        for i, a in enumerate(per_layer):
            out[i] = a
    return tree


def transformer_to_numpy(model) -> dict:
    """The inverse of ``transformer_from_numpy``: a ``Transformer``'s
    params as the reference's tree ``{"layers": {... stacked on axis 0},
    "final_norm": {"scale"}, "head": {"w"}}`` of float32 numpy arrays (the
    dense FFN, or the MoE subtree with its ``router``, ``gate``, ``up`` and
    ``down`` as they are and the shared experts' matrices transposed
    back)."""
    return _transformer_tree(model.state_dict(), model.cfg)


def gin_from_numpy(tree: Mapping, cfg: gnn.GINConfig) -> dict[str, torch.Tensor]:
    """The reference's ``gnn.init`` params (numpy leaves: ``encoder``,
    ``layer{l}/{mlp1, mlp2, eps}``, ``readout{l}``, ``head``) → a state
    dict for ``gnn.GIN(cfg)``, each shape checked."""
    return params_from_tree(gnn.GIN(cfg, device="meta"), tree)


def _bf16_tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 as JAX gives it, or a float type) → a bf16
    tensor with the same values (exact for values that bf16 holds)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _sparse_layout(v: Mapping) -> dict:
    """One engine group of the reference's state, IDMap and Blocks objects
    with numpy fields or already in ``sparse_to_tree``'s layout."""
    im, bl = v["idmap"], v["blocks"]
    if not isinstance(im, (tuple, list)):
        im = tuple(getattr(im, f) for f in idmap_lib.TENSOR_FIELDS)
    if not isinstance(bl, (tuple, list)):
        bl = (bl.emb, tuple(bl.slots[k] for k in sorted(bl.slots)))
    return {"idmap": tuple(im), "blocks": (bl[0], tuple(bl[1]))}


def decode_state_from_numpy(tree: Mapping, state: Mapping, rank: int = 0, n_ranks: int = 1,
                            long_context: bool = False) -> dict:
    """The reference decode cell's state ``{"step", "pos", "dense",
    "sparse", "cache"}`` (numpy leaves; the engine state stacked [D, ...]
    over the D = ``n_ranks`` devices, the cache (L, B, S, Hk, hd) whole)
    loaded into a port decode cell's ``state`` (from its ``init_state``):
    the params into its module, the cache into its cache in place, a new
    engine state, step and pos on the same device. On rank ``rank`` of a
    group the engine state is that rank's shard and the cache its slice:
    of the sequence for a ``long_context`` cell, else of the batch."""
    model = state["dense"]
    device = state["cache"]["k"].device
    model.load_state_dict(transformer_from_numpy(tree["dense"], model.cfg))
    sparse = {g: _sparse_layout(v) for g, v in tree["sparse"].items()}
    if n_ranks > 1:
        sparse = {g: {"idmap": tuple(np.asarray(a)[rank:rank + 1] for a in v["idmap"]),
                      "blocks": (np.asarray(v["blocks"][0])[rank:rank + 1],
                                 tuple(np.asarray(a)[rank:rank + 1] for a in v["blocks"][1]))}
                  for g, v in sparse.items()}
    axis = 2 if long_context else 1
    with torch.no_grad():
        for k, dst in state["cache"].items():
            whole = _bf16_tensor(tree["cache"][k])
            n = whole.shape[axis] // n_ranks
            part = whole.narrow(axis, rank * n, n)
            if part.shape != dst.shape:
                raise ValueError(f"cache/{k}: a rank's slice is {tuple(part.shape)}, the cell has {tuple(dst.shape)}")
            dst.copy_(part)

    def scalar(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    return {"step": scalar(tree["step"]), "pos": scalar(tree["pos"]), "dense": model,
            "sparse": sparse_from_tree(sparse, state["sparse"], device), "cache": state["cache"]}
