"""What each gloo rank of the multi-rank parity tests runs (the port's side;
tests/torch_ranks.py spawns the ranks). Imports no JAX: every rank returns
numpy results that the test compares with the JAX side's."""
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import saver as t_saver
from repro_torch.checkpoint.sharded import from_flat, gather_rows
from repro_torch.core import comm
from repro_torch.core import exchange as t_exchange
from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import local_view
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig

SPECS = [FeatureSpec("f", transform="hash", emb_dim=4, pooling="sum"),
         FeatureSpec("g", transform="hash", emb_dim=4, pooling="mean")]
EL_SPECS = [FeatureSpec("f", transform="hash", emb_dim=4, pooling="sum")]


def exchange_cfg(D: int, kind: str) -> dict:
    """The engine budgets of an exchange case: "normal" fits every id;
    "tight" overflows the send buckets and the owner merge; "one" is one
    device over the global batch."""
    if kind == "normal":
        return dict(rows_per_shard=512, map_capacity_per_shard=1024, u_budget=32, per_dest_cap=32,
                    recv_budget=min(64, 32 * D))
    if kind == "one":  # one device, the global batch
        return dict(rows_per_shard=512, map_capacity_per_shard=1024, u_budget=128, per_dest_cap=128,
                    recv_budget=128)
    return dict(rows_per_shard=512, map_capacity_per_shard=1024, u_budget=32, per_dest_cap=3, recv_budget=4)


def elastic_cfg(D: int) -> dict:
    """The reference's elastic test engine (tests/test_multidevice.py)."""
    return dict(rows_per_shard=128, map_capacity_per_shard=256, u_budget=16, per_dest_cap=16,
                recv_budget=min(64, 16 * D))


PLAN_FIELDS = ("inv_u", "ok_val", "owner_u", "pos_u", "ok_u", "inv_r", "ok_r", "offsets_r", "valid_r")


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ragged(vals, splits) -> Ragged:
    return Ragged(torch.from_numpy(np.asarray(vals)), torch.from_numpy(np.asarray(splits)))


def global_ids(inp, D: int, name: str, budget: int) -> Ragged:
    """Every device's rows of feature ``name`` as one batch (the one-rank
    run of the same global batch)."""
    vals, splits = inp[f"d{D}_{name}_vals"], inp[f"d{D}_{name}_splits"]
    rows = [vals[d][splits[d][i]:splits[d][i + 1]] for d in range(D) for i in range(len(splits[d]) - 1)]
    return Ragged.from_lists(rows, nnz_budget=budget)


def exchange_case(rank: int, group, D: int, kind: str, inp) -> dict:
    """One fetch (train) and the activations with their ``rows_r``
    gradient, on this rank's slice; group None runs the one-rank engine
    over the global batch."""
    eng = EmbeddingEngine(SPECS, EngineConfig(n_devices=comm.size(group), group=group,
                                              **exchange_cfg(comm.size(group), kind)), "cpu")
    if group is None:
        ids = {n: global_ids(inp, D, n, D * inp[f"d{D}_f_vals"].shape[1]) for n in ("f", "g")}
        w = {n: torch.from_numpy(inp[f"d{D}_w_{n}"].reshape(-1, 4)) for n in ("f", "g")}
    else:
        ids = {n: _ragged(inp[f"d{D}_{n}_vals"][rank], inp[f"d{D}_{n}_splits"][rank]) for n in ("f", "g")}
        w = {n: torch.from_numpy(inp[f"d{D}_w_{n}"][rank]) for n in ("f", "g")}
    spec = eng.groups["dim4"].exchange
    send, _, _ = t_exchange.build_send(eng.engine_ids(ids)["dim4"], spec)
    with torch.no_grad():
        _, rows_r, plans, met = eng.fetch_local(local_view(eng.init_state()), ids,
                                                torch.tensor(1, dtype=torch.int32))
        met = comm.sum_metrics(met, group)
    rows = rows_r["dim4"].requires_grad_()
    acts = eng.activations({"dim4": rows}, plans, ids)
    loss = (acts["f"] * w["f"]).sum() + (acts["g"] * w["g"]).sum()
    (grad,) = torch.autograd.grad(loss, [rows])
    out = {"send": _np(send), "rows_r": _np(rows), "acts_f": _np(acts["f"]), "acts_g": _np(acts["g"]),
           "grad": _np(grad), "metrics": {k: int(v) for k, v in met.items()}}
    out.update({f: _np(getattr(plans["dim4"], f)) for f in PLAN_FIELDS})
    return out


def _restore_rows(directory) -> dict:
    """The saver's rows, shaped as they were saved (the union's size is
    the checkpoint's own)."""
    import json

    d = sorted(pathlib.Path(directory).glob("step_*"))[-1]
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    like = {}
    for key, info in leaves.items():
        node = like
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = np.zeros(info["shape"], np.dtype(info["dtype"]))
    return t_saver.restore(d.parent, like, int(d.name.split("_")[1]))


def _wait_for(path: pathlib.Path, timeout: float = 600.0) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def exchange_ranks(rank: int, world, inputs: str, out_dir: str) -> dict:
    """Four ranks: the exchange at D 2 (ranks 0-1) and 3 (ranks 0-2), the
    elastic restores, ``compressed_psum`` at D 2 and 4, ZeRO-1 at D 2."""
    inp = dict(np.load(inputs))
    out = pathlib.Path(out_dir)
    groups = {2: dist.new_group([0, 1]), 3: dist.new_group([0, 1, 2]), 4: world}
    res = {}
    for D in (2, 3):
        if rank < D:
            for kind in ("normal", "tight"):
                res[f"d{D}_{kind}"] = exchange_case(rank, groups[D], D, kind, inp)
            if rank == 0:
                res[f"d{D}_one_rank"] = exchange_case(0, None, D, "one", inp)

    # elastic: train at 2 ranks, save the union, restore onto 3 ranks
    if rank < 2:
        eng = EmbeddingEngine(EL_SPECS, EngineConfig(n_devices=2, group=groups[2], **elastic_cfg(2)), "cpu")
        ids = {"f": _ragged(inp["el_vals"][rank], inp["el_splits"][rank])}
        step = torch.tensor(1, dtype=torch.int32)
        with torch.no_grad():
            st, rr, pl, _ = eng.fetch_local(local_view(eng.init_state()), ids, step)
            st = eng.update_local(st, pl, {k: torch.ones_like(v) for k, v in rr.items()},
                                  SparseAdamConfig(lr=0.1), step)
        sparse = {k: {"idmap": v["idmap"].map(lambda x: x.unsqueeze(0)),
                      "blocks": v["blocks"].map(lambda x: x.unsqueeze(0))} for k, v in st.items()}
        res["el2_own"] = eng.export_rows(sparse)
        union = gather_rows(eng, sparse, groups[2])
        if rank == 0:
            t_saver.save(union, out / "el2", step=1, n_shards=2)
    dist.barrier()
    if rank < 3:
        eng = EmbeddingEngine(EL_SPECS, EngineConfig(n_devices=3, group=groups[3], **elastic_cfg(3)), "cpu")
        res["el_2to3"] = eng.export_rows(eng.import_rows(_restore_rows(out / "el2")))

    # compressed sums and ZeRO-1
    for D in (2, 4):
        if rank < D:
            g, err = (torch.from_numpy(inp[f"cps{D}_{k}"][rank]) for k in ("g", "e"))
            summed, new_err = adamw.compressed_psum(g, groups[D], err)
            gf = g + err
            amax = comm.all_reduce(gf.abs().max().reshape(1), groups[D], dist.ReduceOp.MAX)[0]
            _, q = adamw.quantize(gf, amax)
            isum = comm.all_reduce(q.to(torch.int32), groups[D])
            res[f"cps{D}"] = {"summed": _np(summed), "new_error": _np(new_err), "q": _np(q), "isum": _np(isum)}
    if rank < 2:
        res["zero1"] = zero1_case(groups[2])

    # a JAX 4-device export restored onto 2 ranks
    if rank < 2:
        _wait_for(out / "jax4.done")
        eng = EmbeddingEngine(EL_SPECS, EngineConfig(n_devices=2, group=groups[2], **elastic_cfg(2)), "cpu")
        res["el_j4to2"] = eng.export_rows(eng.import_rows(_restore_rows(out / "jax4")))
    return res


ZERO1_SHAPES = {"w_rows": (300, 256), "w_cols": (64, 2048), "bias": (256,), "w_odd": (257, 300),
                "w_tp": (512, 96), "w_narrow": (1024, 100)}
ZERO1_SPECS = {"w_tp": ("model",), "w_narrow": (None, "model")}
ZERO1_MIN = 1 << 14


def zero1_params(seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen) for k, s in ZERO1_SHAPES.items()}


def zero1_case(group, steps: int = 3) -> dict:
    """ZeRO-1 against the unsharded update over ``steps`` steps on the
    same gradients: every param bit-equal after each step."""
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip_norm=1.0)
    ref, sh = zero1_params(), zero1_params()
    dims = adamw.zero1_dims(ZERO1_SPECS, sh, ZERO1_MIN)
    st_ref, st_sh = adamw.init(ref), adamw.zero1_init(sh, dims, group)
    gen = torch.Generator().manual_seed(1)
    equal = []
    for s in range(1, steps + 1):
        grads = {k: torch.randn(p.shape, generator=gen) * 0.1 for k, p in ref.items()}
        adamw.update(cfg, ref, grads, st_ref, torch.tensor(s))
        adamw.zero1_update(cfg, sh, grads, st_sh, torch.tensor(s), dims, group)
        equal.append({k: bool(torch.equal(ref[k], sh[k])) for k in ref})
    return {"dims": dims, "equal": equal,
            "moment_shapes": {k: tuple(v.shape) for k, v in st_sh["m"].items()}}


# ---------------------------------------------------------------- the cells
CELL_BATCH, CELL_STEPS = 16, 3
TRAIN_CASES = {"dlrm": "dlrm-mlperf", "sasrec": "sasrec"}
WD_CHANGE = {"embed_dim": 16}  # two dim groups: the deep table at 16, the wide at 8


def wide_deep_arch():
    import dataclasses

    from repro_torch.configs import get_config

    a = get_config("wide-deep", smoke=True)
    return dataclasses.replace(a, model=dataclasses.replace(a.model, **WD_CHANGE))


def local_batch(bat: dict, key: str, s: int, rank: int, D: int) -> dict:
    """This rank's slice of a global batch in the reference's layout (each
    device's CSR local, its ``n`` values and ``b_loc + 1`` splits)."""
    out = {}
    for name in sorted({k.split("/")[2] for k in bat if k.startswith(f"{key}/{s}/")}):
        vals, splits = bat[f"{key}/{s}/{name}/values"], bat[f"{key}/{s}/{name}/splits"]
        n, b1 = vals.size // D, splits.size // D
        out[name] = _ragged(vals[rank * n:(rank + 1) * n], splits[rank * b1:(rank + 1) * b1])
    return out


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def cells_ranks(rank: int, group, d: str) -> dict:
    """Two ranks: the dlrm and SASRec smoke train cells for three FP32 steps
    from the JAX cell's initial dense state, Wide & Deep's two-group serve
    over imported rows, the dlrm cell in MIXED from the port's own initial
    state (what the train driver runs), and the refusals at D 2."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import idmap as t_idmap
    from repro_torch.launch import recsys_cell
    from repro_torch.launch.cells import build_arch_cell, build_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import layers
    from repro_torch.storage.tiered import StorageConfig

    d = pathlib.Path(d)
    D = comm.size(group)
    bat = dict(np.load(d / "batches.npz"))
    train_shape = ShapeCell("train_batch", "train", {"batch": CELL_BATCH})
    res = {}
    recsys_cell.MIXED = layers.FP32
    try:
        for key, arch_id in TRAIN_CASES.items():
            cell = build_arch_cell(get_config(arch_id, smoke=True), train_shape, device="cpu", group=group)
            state = cell.init_state()
            state = cell.load_state_tree(state, t_saver.restore(d / f"{key}_init", cell.state_tree(state)))
            steps = []
            for s in range(CELL_STEPS):
                state, o = cell.step_fn(state, local_batch(bat, key, s, rank, D))
                steps.append({
                    "out": {k: float(v) if k == "loss" else int(v) for k, v in o.items()},
                    "idmap": {g: {f: _np(getattr(v["idmap"], f)[0]) for f in t_idmap.TENSOR_FIELDS}
                              for g, v in state["sparse"].items()},
                    "rows": cell.engine.export_rows(state["sparse"]),
                    "tree": t_saver._flatten(cell.state_tree(state))})
            res[key] = steps
            spec = cell.engine.state_sharding_spec()
            res["shard_spec"] = (spec.shards, state["sparse"]["dim16"]["idmap"].keys.shape[0])

        cell = build_arch_cell(wide_deep_arch(), ShapeCell("serve_p99", "serve", {"batch": CELL_BATCH}),
                               device="cpu", group=group)
        state = cell.init_state()
        state["sparse"] = cell.engine.import_rows(from_flat(dict(np.load(d / "wd_rows.npz"))))
        model = state["dense"]
        like = {"dense": convert.params_to_tree(model, model.state_dict())}
        model.load_state_dict(convert.params_from_tree(model, t_saver.restore(d / "wd_init", like)["dense"]))
        res["wd"] = [{k: _np(v) for k, v in cell.step_fn(state, local_batch(bat, "wd", s, rank, D)).items()}
                     for s in range(2)]
    finally:
        recsys_cell.MIXED = layers.MIXED

    cell = build_arch_cell(get_config("dlrm-mlperf", smoke=True), train_shape, device="cpu", group=group)
    state, losses = cell.init_state(), []
    for s in range(CELL_STEPS):
        state, o = cell.step_fn(state, cell.make_batch(s))
        losses.append(float(o["loss"]))
    res["driver_losses"] = losses

    dlrm = get_config("dlrm-mlperf", smoke=True)
    res["refused"] = {
        "retrieval": _raises(lambda: build_arch_cell(dlrm, ShapeCell("retrieval_cand", "retrieval",
                                                                     {"n_candidates": 64}),
                                                     device="cpu", group=group), NotImplementedError),
        "tiered": _raises(lambda: build_arch_cell(dlrm, train_shape, CellOptions(
            storage=StorageConfig(policy="lru"), storage_device_rows=1024), device="cpu", group=group),
            NotImplementedError),
        "lm": _raises(lambda: build_cell("qwen2.5-3b", "train_4k", smoke=True, device="cpu", group=group),
                      NotImplementedError)}
    return res


def launch_counts() -> dict:
    from repro_torch.kernels.fused_gather import ops as fg
    from repro_torch.kernels.fused_scatter import ops as fs
    from repro_torch.kernels.segment_reduce import ops as sr

    return {"gather": fg.LAUNCHES, "group_sum": sr.GROUP_LAUNCHES, "group_sum_bwd": sr.GROUP_LAUNCHES_BWD,
            "scatter_add": fs.LAUNCHES_ADD, "scatter_set": fs.LAUNCHES_SET}


def cuda_train_ranks(rank: int, group, batch: int, steps: int) -> dict:
    """The dlrm smoke train cell on the card over the group (ranks sharing
    one card: gloo, host-staged): losses, each step's kernel launches on
    this rank, and this rank's export."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = build_cell("dlrm-mlperf", "train_batch", smoke=True, device=dev, group=group,
                      shape_override=ShapeCell("train_batch", "train", {"batch": batch}))
    state, losses, launches = cell.init_state(), [], []
    staged = comm.STAGED_BYTES
    for s in range(steps):
        before = launch_counts()
        state, o = cell.step_fn(state, cell.make_batch(s))
        torch.cuda.synchronize()
        launches.append({k: v - before[k] for k, v in launch_counts().items()})
        losses.append(float(o["loss"]))
    return {"losses": losses, "launches": launches, "rows": cell.engine.export_rows(state["sparse"]),
            "staged_bytes": comm.STAGED_BYTES - staged, "transport": comm.transport(group, dev)}


# ---------------------------------------------------------------- the GNN cells
GNN_STEPS = 3
# (case, shape name, kind, params, compress_grads, ranks): the edge-parallel
# full graph at ogb_products' widths (scale cut, E odd so that it is padded
# to D), the minibatch cell, and the molecule cell with compressed sums
GNN_CASES = [
    ("ogb_d2", "ogb_products", "full_graph",
     {"n_nodes": 4_000, "n_edges": 30_001, "d_feat": 100, "n_classes": 47}, False, 2),
    ("ogb_d3", "ogb_products", "full_graph",
     {"n_nodes": 4_000, "n_edges": 30_001, "d_feat": 100, "n_classes": 47}, False, 3),
    ("minibatch_d2", "minibatch_lg", "minibatch",
     {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 16, "fanout": (15, 10), "d_feat": 602,
      "n_classes": 41}, False, 2),
    ("molecule_d2_compressed", "molecule", "graph_batch",
     {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "n_classes": 2}, True, 2),
]


def _flat_np(tree, prefix: str = "") -> dict:
    """A state tree's leaves as numpy copies under "a/b/c" keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.array(tree.detach().cpu() if torch.is_tensor(tree) else tree)}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def gnn_ranks(rank: int, group, d: str) -> dict:
    """The GIN smoke cells of GNN_CASES with this group's size, FP32, from
    the reference's initial params (``d/gnn_init_<case>.npz``), GNN_STEPS
    steps on the reference's batches: the losses, and the state tree after
    the first and the last step (the residuals all-gathered over the ranks)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import gnn_cell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import layers

    d = pathlib.Path(d)
    res = {}
    gnn_cell.MIXED = layers.FP32
    try:
        for case, name, kind, params, compress, n_ranks in GNN_CASES:
            if n_ranks != comm.size(group):
                continue
            cell = build_arch_cell(get_config("gin-tu", smoke=True), ShapeCell(name, kind, params),
                                   CellOptions(compress_grads=compress), device="cpu", group=group)
            state = cell.init_state()
            init = _nest(dict(np.load(d / f"gnn_init_{case}.npz")))
            state["dense"].load_state_dict(convert.params_from_tree(state["dense"], init))
            out = {"loss": [], "rank_shard": {f: _np(x) for f, x in cell.make_batch(0)._asdict().items()}}
            for s in range(GNN_STEPS):
                state, o = cell.step_fn(state, cell.make_batch(s))
                out["loss"].append(float(o["loss"]))
                if s == 0:
                    out["step1"] = _flat_np(cell.state_tree(state))
            out["final"] = _flat_np(cell.state_tree(state))
            res[case] = out
    finally:
        gnn_cell.MIXED = layers.MIXED
    return res


# The decode cells at D 2 (tests/test_torch_decode_ranks.py): (case, shape,
# its params, the first step's position). long_500k shards the cache's 256
# positions over the ranks, 128 each, and its three steps write positions
# 126, 127 (rank 0) and 128 (rank 1); decode_32k splits its batch of 4.
DECODE_CASES = [("long", "long_500k", {"seq_len": 256, "global_batch": 1, "long_context": True}, 126),
                ("batch", "decode_32k", {"seq_len": 128, "global_batch": 4}, 125)]
DECODE_STEPS = 3
DECODE_PRECS = ("fp32", "mixed")


def _decode_tree(flat: dict) -> dict:
    """The reference decode state saved flat (the IDMap's fields by index,
    the Blocks' slots by name) in ``convert.decode_state_from_numpy``'s
    layout."""
    tree = _nest(flat)
    tree["sparse"] = {g: {"idmap": tuple(v["idmap"][str(i)] for i in range(len(v["idmap"]))),
                          "blocks": (v["blocks"]["emb"],
                                     tuple(v["blocks"]["slots"][k] for k in sorted(v["blocks"]["slots"])))}
                      for g, v in tree["sparse"].items()}
    return tree


def decode_ranks(rank: int, group, d: str) -> dict:
    """The qwen2.5 smoke decode cells of DECODE_CASES over this group, in
    FP32 and MIXED, from the reference cell's initial state
    (``d/decode_init.npz``): each step's logits and summed metrics, this
    rank's slice of the final cache, ``pos``, and this rank's batch; then
    whether the LM train and prefill cells refuse the group."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import lm_cell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.models import layers

    d = pathlib.Path(d)
    _wait_for(d / "decode_init.npz")
    ref = dict(np.load(d / "decode_init.npz"))
    arch = get_config("qwen2.5-3b", smoke=True)
    res = {}
    try:
        for case, name, params, _ in DECODE_CASES:
            p = f"{case}/"
            tree = _decode_tree({k[len(p):]: v for k, v in ref.items() if k.startswith(p)})
            for prec in DECODE_PRECS:
                lm_cell.MIXED = layers.FP32 if prec == "fp32" else layers.MIXED
                cell = build_arch_cell(arch, ShapeCell(name, "decode", params), device="cpu", group=group)
                st = convert.decode_state_from_numpy(tree, cell.init_state(), rank, comm.size(group),
                                                     bool(params.get("long_context")))
                out = {"logits": [], "metrics": [], "batch": _np(cell.make_batch(0))}
                for s in range(DECODE_STEPS):
                    st, o = cell.step_fn(st, cell.make_batch(s))
                    out["logits"].append(_np(o["logits"]))
                    out["metrics"].append({k: int(v) for k, v in o.items() if "/" in k})
                out.update(cache={k: _np(v.float()) for k, v in st["cache"].items()}, pos=int(st["pos"]),
                           step=int(st["step"]))
                res[case, prec] = out
    finally:
        lm_cell.MIXED = layers.MIXED
    for name in ("train_4k", "prefill_32k"):
        try:
            build_arch_cell(arch, arch.shape(name), device="cpu", group=group)
            res[name] = "built"
        except NotImplementedError as e:
            res[name] = str(e)
    return res
