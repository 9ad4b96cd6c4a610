#!/usr/bin/env python3
"""The PyTorch port serving and training dlrm-mlperf on one NVIDIA card,
through its own CUDA kernels.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/csrc`` (into ``build/``), then:

  1. device   — the card, its power limit, the kernel build time;
  2. kernels  — each CUDA kernel against its plain PyTorch version on random
                inputs (PAD and out-of-range ids, unsorted and empty
                segments, invalid scatter slots, D not a multiple of 4,
                unaligned pointers, views of stacked tables);
  3. smoke    — the smoke-size serve cell, then three steps of the smoke
                train cell, on the card against the same cells on the CPU:
                same rows, params and batches;
  4. serve    — full-width dlrm-mlperf (vocab cut to 250,000 per feature):
                6.5 M rows imported, 20 serve_p99 requests (batch 512) and
                two serve_bulk requests (batch 262,144: the first at that
                size, then a warm one), with the kernels' launch counts
                over that run, then torch.profiler traces of
                five serve_p99 requests and one serve_bulk request (device
                busy time, idle share, device operations per request);
     train    — full-width train_batch (batch 65,536) from a fresh state:
                3 warm-up and 10 timed steps with the kernels' launch counts
                over the 13, state checks, a torch.profiler trace of three
                steps, and ten steps on one repeated batch (the loss falls);
  5. a ``{"kernels": [...]}`` line: each kernel on the exact inputs the
     serve and train paths fed it, against its plain version, timed beside
     the plain version, one PyTorch library call and the card's bound.

Every check raises on failure, so the script exits non-zero. It prints one
JSON object per line; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
VOCAB = 250_000             # per feature; the published 4,000,000 needs 240 GB
N_P99_REQUESTS, N_WARMUP = 20, 3
N_TRAIN_WARMUP, N_TRAIN_STEPS, N_REPEAT = 3, 10, 10
MIXED_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 logits and loss, card against CPU
# Train state, card against CPU after 3 smoke steps (bf16 dense compute; the
# reasons are in tests/test_torch_train.py): rows and params within
# 2 * lr * steps, the rows' moments within 5e-2 of their largest magnitude.
TRAIN_PARAM_ATOL = 2 * 1e-3 * 3
TRAIN_MOMENT_FRAC = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.feature_engine import FeatureEngine
    from repro_torch.io.ragged import Ragged
    from repro_torch.core import idmap as idmap_lib
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.launch import recsys_cell
    from repro_torch.launch.cells import build_cell

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1 device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load_library()
    build_s = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "library": str(lib_path.relative_to(ROOT))})

    # ------------------------------------------------- 2 kernels vs plain, random
    rng = np.random.default_rng(SEED)
    cases = []

    def unaligned(x: torch.Tensor) -> torch.Tensor:
        """The same values at an address 4 bytes past a 16-byte boundary."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    for R, D, K, idt, misalign in [(100_000, 128, 26_624, torch.int32, False),
                                   (5_000, 13, 1_000, torch.int64, False),
                                   (4_000, 128, 3_000, torch.int64, True), (7, 4, 1, torch.int32, False)]:
        table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32)).to(dev)
        table = unaligned(table) if misalign else table
        ids = torch.from_numpy(rng.integers(-2, R + 2, size=K)).to(idt).to(dev)
        got, want = fg_ops.gather_rows(table, ids), fg_ref.gather_rows(table, ids)
        torch.cuda.synchronize()
        cases.append({"kernel": "gather_rows", "R": R, "D": D, "K": K, "ids": str(idt),
                      "unaligned": misalign, "bit_equal": bool(torch.equal(got, want))})
        check(torch.equal(got, want), f"gather_rows disagrees at {cases[-1]}")
    for N, D, S, sort, misalign in [(512, 128, 512, True, False), (4_096, 128, 9_000, True, False),
                                    (5_000, 64, 100, False, False), (777, 13, 111, True, False),
                                    (2_000, 128, 300, False, True)]:
        vals = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32)).to(dev)
        vals = unaligned(vals) if misalign else vals
        seg = rng.integers(-1, S + 2, size=N).astype(np.int32)  # out-of-range both sides
        seg = torch.from_numpy(np.sort(seg) if sort else seg).to(dev)
        got = sr_ops.segment_sum(vals, seg, S, sorted_ids=sort)
        want = sr_ref.segment_sum(vals.cpu(), seg.cpu(), S)
        err = float((got.cpu() - want).abs().max())
        cases.append({"kernel": "segment_sum", "N": N, "D": D, "S": S, "sorted": sort,
                      "unaligned": misalign, "max_abs_err": err})
        check(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5), f"segment_sum disagrees at {cases[-1]}")
    for n_rows, D, budget, sdt, misalign in [(512, 128, 512, torch.int32, False),
                                             (300, 128, 1_000, torch.int64, False),
                                             (200, 13, 700, torch.int32, False),
                                             (400, 64, 1_500, torch.int32, True)]:
        lengths = rng.integers(0, 4, size=n_rows)
        lengths[::5] = 0  # empty rows
        splits = np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget)  # padding tail
        vals = torch.from_numpy(rng.normal(size=(budget, D)).astype(np.float32)).to(dev)
        vals = unaligned(vals) if misalign else vals
        sp = torch.from_numpy(splits).to(sdt).to(dev)
        got = sr_ops.segment_sum_csr(vals, sp)
        want = sr_ref.segment_sum_csr(vals.cpu(), sp.cpu())
        err = float((got.cpu() - want).abs().max())
        cases.append({"kernel": "segment_sum_csr", "n_rows": n_rows, "D": D, "N": budget,
                      "splits": str(sdt), "unaligned": misalign, "max_abs_err": err})
        check(torch.allclose(got.cpu(), want, rtol=1e-5, atol=1e-5),
              f"segment_sum_csr disagrees at {cases[-1]}")
    for R, D, K, idt, misalign, with_valid in [(100_000, 128, 30_000, torch.int32, False, True),
                                               (5_000, 13, 1_000, torch.int64, False, True),
                                               (4_000, 128, 3_000, torch.int64, True, True),
                                               (2_000, 64, 500, torch.int32, False, False),
                                               (50, 8, 0, torch.int32, False, True)]:
        for op in ("add", "set"):
            stacked = torch.from_numpy(rng.normal(size=(2, R, D)).astype(np.float32)).to(dev)
            ids = torch.from_numpy(rng.permutation(R + 4)[:K] - 2).to(idt).to(dev)  # unique, some out of range
            valid = torch.from_numpy(rng.random(K) < 0.7).to(dev)
            ids = torch.where(ids == 0, -1, ids)  # no live slot on row 0 ...
            if with_valid:  # ... only invalid ones, which must leave it as it is
                ids[: K // 10] = torch.where(valid[: K // 10], ids[: K // 10], 0)
            rows = torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32)).to(dev)
            rows = unaligned(rows) if misalign else rows
            v = valid if with_valid else None
            want = stacked[1].clone()
            (fs_ref.scatter_add_rows if op == "add" else fs_ref.scatter_set_rows)(want, ids, rows, v)
            before = (fs_ops.LAUNCHES_ADD, fs_ops.LAUNCHES_SET)
            other = stacked[0].clone()
            (fs_ops.scatter_add_rows if op == "add" else fs_ops.scatter_set_rows)(stacked[1], ids, rows, v)
            torch.cuda.synchronize()
            launched = (fs_ops.LAUNCHES_ADD, fs_ops.LAUNCHES_SET) != before
            cases.append({"kernel": f"scatter_{op}_rows", "R": R, "D": D, "K": K, "ids": str(idt),
                          "valid": with_valid, "unaligned_rows": misalign, "launched": launched,
                          "bit_equal": bool(torch.equal(stacked[1], want))})
            check(torch.equal(stacked[1], want) and torch.equal(stacked[0], other),
                  f"scatter disagrees at {cases[-1]}")
            check(launched == (K > 0), f"scatter launch count at {cases[-1]}")
    for n_rows, D, budget, sdt, stride in [(512, 128, 512, torch.int32, 128), (300, 128, 1_000, torch.int64, 128),
                                           (200, 13, 700, torch.int32, 13), (65_536, 128, 65_536, torch.int32, 26 * 128),
                                           (400, 64, 1_500, torch.int64, 3 * 64)]:
        lengths = rng.integers(0, 4, size=n_rows)
        lengths[::5] = 0  # empty rows
        splits = np.minimum(np.concatenate([[0], np.cumsum(lengths)]), budget)  # padding tail
        wide = torch.from_numpy(rng.normal(size=(n_rows, stride)).astype(np.float32)).to(dev)
        g = wide[:, stride - D:]  # a column block of a wider gradient, as the model's stack gives
        sp = torch.from_numpy(splits).to(sdt).to(dev)
        before = sr_ops.LAUNCHES_BWD
        got = sr_ops.segment_expand_csr(g, sp, budget)
        torch.cuda.synchronize()
        want = sr_ref.segment_expand_csr(g.cpu(), sp.cpu(), budget)
        cases.append({"kernel": "segment_expand_csr", "n_rows": n_rows, "D": D, "N": budget,
                      "splits": str(sdt), "g_row_stride": stride, "bit_equal": bool(torch.equal(got.cpu(), want))})
        check(torch.equal(got.cpu(), want), f"segment_expand_csr disagrees at {cases[-1]}")
        check(sr_ops.LAUNCHES_BWD == before + 1, "segment_expand_csr did not launch")
    emit({"phase": "kernels_vs_plain", "cases": cases, "tolerance": {
        "gather_rows": "bit-equal", "segment_sum": "rtol=atol=1e-5 (summation order)",
        "segment_sum_csr": "rtol=atol=1e-5 (summation order)",
        "scatter_add_rows": "bit-equal", "scatter_set_rows": "bit-equal",
        "segment_expand_csr": "bit-equal (a copy)"}})

    # ----------------------------------------------- 3 smoke serve, card vs CPU
    shape = ShapeCell("serve_p99", "serve", {"batch": 32})
    smoke = {d: build_cell("dlrm-mlperf", "serve_p99", smoke=True, shape_override=shape, device=d)
             for d in ("cpu", "cuda")}
    seeds = (0, 1, 2)
    eng = torch.cat([smoke["cpu"].engine.engine_ids(smoke["cpu"].ids_fn(smoke["cpu"].make_batch(s)))["dim16"]
                     for s in seeds])
    ids = np.unique(eng[eng != -1].numpy())
    ids = np.delete(ids, np.arange(0, ids.size, 7))  # some ids missing: they read as zero rows
    n = ids.size
    rows = {"dim16": {"ids": ids, "emb": rng.normal(size=(n, 16)).astype(np.float32),
                      "slots": {k: np.zeros((n, 16), np.float32) for k in ("m", "v")},
                      "last_use": np.ones(n, np.int32)}}
    states = {}
    for d, cell in smoke.items():
        st = cell.init_state()
        st["sparse"] = cell.engine.import_rows(rows)
        states[d] = st
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    max_diff = 0.0
    for s in seeds:
        outs = {d: smoke[d].step_fn(states[d], smoke[d].make_batch(s)) for d in smoke}
        met = {d: {k: int(v) for k, v in o.items() if k != "logits"} for d, o in outs.items()}
        check(met["cuda"] == met["cpu"], f"smoke metrics differ: {met}")
        lc, lg = outs["cpu"]["logits"], outs["cuda"]["logits"].cpu()
        check(bool(torch.isfinite(lg).all()) and lg.shape == (32,), "smoke logits not finite")
        check(torch.allclose(lg, lc, **MIXED_TOL), f"smoke logits differ by {(lg - lc).abs().max()}")
        max_diff = max(max_diff, float((lg - lc).abs().max()))
    emit({"phase": "smoke_serve_card_vs_cpu", "batch": 32, "requests": len(seeds),
          "metrics": met["cuda"], "max_abs_logit_diff": max_diff, "tolerance": MIXED_TOL})
    del smoke, states

    # ----------------------------------------------- 3 smoke train, card vs CPU
    tshape = ShapeCell("train_batch", "train", {"batch": 32})
    tsmoke = {d: build_cell("dlrm-mlperf", "train_batch", smoke=True, shape_override=tshape, device=d)
              for d in ("cpu", "cuda")}
    rows["dim16"]["slots"] = {"m": rng.normal(scale=1e-3, size=(n, 16)).astype(np.float32),
                              "v": rng.random(size=(n, 16)).astype(np.float32) * 1e-5}
    states = {}
    for d, cell in tsmoke.items():
        st = cell.init_state()
        st["sparse"] = cell.engine.import_rows(rows)
        states[d] = st
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    losses = []
    for s in seeds:  # the ids left out of the import are inserted on the way
        outs = {}
        for d, cell in tsmoke.items():
            states[d], outs[d] = cell.step_fn(states[d], cell.make_batch(s))
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        check(met["cuda"] == met["cpu"], f"smoke train metrics differ: {met}")
        lc, lg = float(outs["cpu"]["loss"]), float(outs["cuda"]["loss"])
        check(np.isfinite(lg) and abs(lg - lc) <= MIXED_TOL["atol"] + MIXED_TOL["rtol"] * abs(lc),
              f"smoke train loss {lg} on the card, {lc} on the CPU")
        losses.append({"cpu": lc, "cuda": lg})
    for f in idmap_lib.TENSOR_FIELDS:
        got, want = (getattr(states[d]["sparse"]["dim16"]["idmap"], f).cpu() for d in ("cuda", "cpu"))
        check(torch.equal(got, want), f"smoke train IDMap field {f} differs")
    exp = {d: tsmoke[d].engine.export_rows(states[d]["sparse"])["dim16"] for d in states}
    for k in ("ids", "last_use"):
        check(np.array_equal(exp["cuda"][k], exp["cpu"][k]), f"smoke train export {k} differs")
    diffs = {"emb": float(np.abs(exp["cuda"]["emb"] - exp["cpu"]["emb"]).max())}
    check(diffs["emb"] <= TRAIN_PARAM_ATOL, f"smoke train rows differ by {diffs['emb']}")
    for k in ("m", "v"):
        got, want = exp["cuda"]["slots"][k], exp["cpu"]["slots"][k]
        diffs[k] = float(np.abs(got - want).max())
        check(diffs[k] <= TRAIN_MOMENT_FRAC * np.abs(want).max(), f"smoke train {k} differs by {diffs[k]}")
    dense = {d: states[d]["dense"].state_dict() for d in states}
    diffs["dense"] = max(float((dense["cuda"][k].cpu() - v).abs().max()) for k, v in dense["cpu"].items())
    check(diffs["dense"] <= TRAIN_PARAM_ATOL, f"smoke train dense params differ by {diffs['dense']}")
    emit({"phase": "smoke_train_card_vs_cpu", "batch": 32, "steps": len(seeds), "loss": losses,
          "metrics": met["cuda"], "idmap_equal": True, "export_ids_equal": True,
          "max_abs_diff": diffs, "tolerance": {
              "loss": MIXED_TOL, "emb_and_dense_atol": TRAIN_PARAM_ATOL,
              "moments": f"{TRAIN_MOMENT_FRAC} of the largest magnitude"}})
    del tsmoke, states, exp, dense

    # ------------------------------------------------------ 4 full-width serve
    arch = dataclasses.replace(dlrm_mlperf.ARCH, model=dataclasses.replace(
        dlrm_mlperf.ARCH.model, vocab_per_feature=VOCAB))
    mcfg = arch.model
    p99 = recsys_cell.build(arch, arch.shape("serve_p99"), device=dev)
    bulk = recsys_cell.build(arch, arch.shape("serve_bulk"), device=dev)
    g = p99.engine.groups["dim128"]
    check(g.rows_per_shard == bulk.engine.groups["dim128"].rows_per_shard, "cells disagree on rows")

    t0 = time.perf_counter()
    hash_specs = [s for s in recsys_cell._model_mod(arch.arch_id).feature_specs(mcfg)
                  if s.transform == "hash"]
    raw = torch.arange(VOCAB, dtype=torch.int64, device=dev)
    splits = torch.arange(VOCAB + 1, dtype=torch.int32, device=dev)
    ids_by_feature, _ = FeatureEngine(hash_specs, dev).apply({s.name: Ragged(raw, splits) for s in hash_specs})
    all_ids = p99.engine.engine_ids(ids_by_feature)["dim128"]
    n_rows = all_ids.numel()
    check(n_rows == mcfg.n_sparse * VOCAB, "engine ids")
    check(torch.unique(all_ids).numel() == n_rows, "engine ids of distinct raw ids collide")
    emb = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (n_rows, mcfg.embed_dim), dtype=np.float32))
    emb.mul_(0.05)
    zeros = torch.zeros((n_rows, mcfg.embed_dim), dtype=torch.float32, device=dev)
    rows = {"dim128": {"ids": all_ids, "emb": emb, "slots": {"m": zeros, "v": zeros},
                       "last_use": torch.zeros(n_rows, dtype=torch.int32, device=dev)}}
    state = p99.init_state()
    state["sparse"] = p99.engine.import_rows(rows)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    del rows, emb, zeros, all_ids, ids_by_feature, raw, splits
    state_bytes = sum(t.numel() * t.element_size() for t in _tensors(state["sparse"]))
    state_bytes += sum(p.numel() * p.element_size() for p in state["dense"].parameters())
    live = int(state["sparse"]["dim128"]["idmap"].n_live())
    check(live == n_rows, f"{live} rows live after import, expected {n_rows}")

    # record the first inputs each kernel gets from the serve path, per cell
    recorded: dict = {}
    phase = {"name": None}

    def keep(a, whole: bool):
        """A copy with the same strides; tables over 2^28 elements are kept
        as they are unless ``whole`` (the scatter writes into its table)."""
        if not torch.is_tensor(a) or (a.numel() >= (1 << 28) and not whole):
            return a
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device).copy_(a.detach())

    def recorder(mod, fn_name, whole: bool = False):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            key = (fn_name, phase["name"])
            if phase["name"] and key not in recorded:
                recorded[key] = ([keep(a, whole) for a in args], kw)
            return fn(*args, **kw)
        setattr(mod, fn_name, wrapper)
        return fn

    real = {"gather_rows": recorder(fg_ops, "gather_rows"),
            "segment_sum_csr": recorder(sr_ops, "segment_sum_csr"),
            "segment_expand_csr": recorder(sr_ops, "segment_expand_csr"),
            "scatter_add_rows": recorder(fs_ops, "scatter_add_rows", whole=True),
            "scatter_set_rows": recorder(fs_ops, "scatter_set_rows", whole=True)}

    def counts() -> dict:
        return {"fused_gather.gather_rows": fg_ops.LAUNCHES,
                "segment_reduce.segment_sum": sr_ops.LAUNCHES,
                "segment_reduce.segment_expand_csr": sr_ops.LAUNCHES_BWD,
                "fused_scatter.scatter_add_rows": fs_ops.LAUNCHES_ADD,
                "fused_scatter.scatter_set_rows": fs_ops.LAUNCHES_SET}

    def reset_counts() -> None:
        fg_ops.LAUNCHES = sr_ops.LAUNCHES = sr_ops.LAUNCHES_BWD = 0
        fs_ops.LAUNCHES_ADD = fs_ops.LAUNCHES_SET = 0

    batches = {s: p99.make_batch(s, vocab=VOCAB) for s in range(N_WARMUP + N_P99_REQUESTS)}
    bulk_batch = bulk.make_batch(10_000, vocab=VOCAB)
    torch.cuda.synchronize()
    reset_counts()
    lat_ms, outs = [], []
    for s in range(N_WARMUP + N_P99_REQUESTS):
        phase["name"] = "serve_p99" if s >= N_WARMUP else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = p99.step_fn(state, batches[s])
        end.record()
        end.synchronize()
        if s >= N_WARMUP:
            lat_ms.append(start.elapsed_time(end))
            outs.append(out)
    phase["name"] = "serve_bulk"
    torch.cuda.reset_peak_memory_stats()
    bulk_ms = []  # the first request at this size pays one-time costs; the second is warm
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        bulk_out = bulk.step_fn(state, bulk_batch)
        end.record()
        end.synchronize()
        bulk_ms.append(start.elapsed_time(end))
        phase["name"] = None
    peak_bytes = torch.cuda.max_memory_allocated()
    launches = counts()
    n_req = N_WARMUP + N_P99_REQUESTS + 2
    check(launches["fused_gather.gather_rows"] == n_req, f"gather launches {launches}")
    check(launches["segment_reduce.segment_sum"] == n_req * mcfg.n_sparse, f"segment_sum launches {launches}")

    for out, batch_size in [(o, p99.shape["batch"]) for o in outs] + [(bulk_out, bulk.shape["batch"])]:
        logits = out["logits"]
        check(logits.shape == (batch_size,) and bool(torch.isfinite(logits).all()), "logits")
        met = {k: int(v) for k, v in out.items() if k != "logits"}
        check(all(v == 0 for k, v in met.items() if "overflow" in k), f"overflow: {met}")
        check(met["dim128/dev_rows_live"] == n_rows, f"rows live: {met}")
    # every live unique id of each request was found (valid_r), checked after
    # the counted run so these fetches do not count as serve launches
    n_found = []
    for cell, batch in [(p99, batches[s]) for s in range(N_WARMUP, N_WARMUP + N_P99_REQUESTS)] \
            + [(bulk, bulk_batch)]:
        with torch.inference_mode():
            ids = cell.ids_fn(batch)
            eng = cell.engine.engine_ids(ids)["dim128"]
            _, _, plans, _ = cell.engine.fetch_local(
                recsys_cell._local(state["sparse"]), ids, state["step"], train=False)
        want = torch.unique(eng[eng != -1]).numel()
        got = int(plans["dim128"].valid_r.sum())
        check(got == want, f"{got} of {want} live unique ids found")
        n_found.append(got)
        del plans
    lat = np.array(lat_ms)
    emit({"phase": "full_serve", "arch": arch.arch_id, "widths": {
              "n_dense": mcfg.n_dense, "n_sparse": mcfg.n_sparse, "embed_dim": mcfg.embed_dim,
              "bot_mlp": mcfg.bot_mlp, "top_mlp": mcfg.top_mlp},
          "reduced": {"vocab_per_feature": [4_000_000, VOCAB], "devices": [256, 1]},
          "rows_loaded": n_rows, "rows_per_shard": g.rows_per_shard,
          "map_capacity": g.map_capacity_per_shard, "import_s": import_s,
          "state_bytes": state_bytes,
          "serve_p99": {"batch": p99.shape["batch"], "requests": N_P99_REQUESTS, "warmup": N_WARMUP,
                        "latency_ms_p50": float(np.percentile(lat, 50)),
                        "latency_ms_p99": float(np.percentile(lat, 99)),
                        "latency_ms_mean": float(lat.mean()), "latency_ms": lat_ms,
                        "unique_ids_found": n_found[:-1]},
          "serve_bulk": {"batch": bulk.shape["batch"], "ms": bulk_ms[0], "ms_warm": bulk_ms[1],
                         "unique_ids_found": n_found[-1],
                         "max_memory_allocated_bytes": peak_bytes},
          "launches": launches, "launches_per_request": {
              k: v / n_req for k, v in launches.items()}})
    del outs, bulk_out
    emit(profile_requests("serve_p99", lambda b: p99.step_fn(state, b),
                          [batches[s] for s in range(N_WARMUP, N_WARMUP + 5)]))
    emit(profile_requests("serve_bulk", lambda b: bulk.step_fn(state, b), [bulk_batch]))
    del batches, bulk_batch, state
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 4 full-width train
    train = recsys_cell.build(arch, arch.shape("train_batch"), device=dev)
    B = train.shape["batch"]
    n_steps = N_TRAIN_WARMUP + N_TRAIN_STEPS
    tbatches = [train.make_batch(20_000 + s, vocab=VOCAB) for s in range(n_steps + 3 + 1)]
    # the distinct engine ids of each batch, and of all batches up to it
    # (what dev_rows_live must count after that step)
    step_ids, expect_live = [], []
    seen = torch.empty(0, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for b in tbatches[:n_steps]:
            eng = train.engine.engine_ids(train.ids_fn(b))["dim128"]
            step_ids.append(torch.unique(eng[eng != -1]))
            seen = torch.unique(torch.cat([seen, step_ids[-1]]))
            expect_live.append(seen.numel())
    tstate = train.init_state()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()  # the state and what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, losses, inserted, rows_check = [], [], [], None
    for s in range(n_steps):
        probe = s == N_TRAIN_WARMUP - 1  # the last warm-up step: row checks, kernel inputs
        if probe:
            sample = _row_sample(tstate, step_ids[s], torch.unique(torch.cat(step_ids[:s])), idmap_lib)
        phase["name"] = "train" if probe else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tstate, out = train.step_fn(tstate, tbatches[s])
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= N_TRAIN_WARMUP:
            step_ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in out.items() if k != "loss"}
        losses.append(float(out["loss"]))
        inserted.append(met["dim128/idmap_inserted"])
        check(all(v == 0 for k, v in met.items() if "overflow" in k), f"train overflow at step {s + 1}: {met}")
        check(np.isfinite(losses[-1]), f"train loss {losses[-1]} at step {s + 1}")
        check(met["dim128/dev_rows_live"] == expect_live[s],
              f"step {s + 1}: {met['dim128/dev_rows_live']} rows live, {expect_live[s]} ids seen")
        if s == N_TRAIN_WARMUP - 2:  # steps 1-2: before the probe step's recorded copies
            train_peak = torch.cuda.max_memory_allocated()
        if probe:
            rows_check = _rows_moved(tstate, sample, idmap_lib)
            del sample
    train_launches = counts()
    check(inserted[0] > 0, "step 1 inserted nothing")
    check(all(v > 0 for v in train_launches.values()), f"a kernel of the train path never ran: {train_launches}")
    check(train_launches["fused_gather.gather_rows"] == 4 * n_steps
          and train_launches["fused_scatter.scatter_add_rows"] == 3 * n_steps
          and train_launches["segment_reduce.segment_sum"] == mcfg.n_sparse * n_steps
          and train_launches["segment_reduce.segment_expand_csr"] == mcfg.n_sparse * n_steps,
          f"train launches {train_launches}")
    tstate_bytes = sum(t.numel() * t.element_size() for t in _tensors(tstate["sparse"]))

    def run_step(b):
        nonlocal tstate
        tstate, _ = train.step_fn(tstate, b)

    emit(profile_requests("train_batch", run_step, tbatches[n_steps:n_steps + 3]))
    repeat = []
    for _ in range(N_REPEAT):  # one batch again and again: the loss must fall
        tstate, out = train.step_fn(tstate, tbatches[-1])
        repeat.append(float(out["loss"]))
    check(all(np.isfinite(repeat)) and repeat[-1] < repeat[0], f"loss on one repeated batch: {repeat}")
    st = np.array(step_ms)
    emit({"phase": "full_train", "arch": arch.arch_id, "batch": B, "widths": {
              "n_dense": mcfg.n_dense, "n_sparse": mcfg.n_sparse, "embed_dim": mcfg.embed_dim,
              "bot_mlp": mcfg.bot_mlp, "top_mlp": mcfg.top_mlp},
          "reduced": {"vocab_per_feature": [4_000_000, VOCAB], "devices": [256, 1]},
          "warmup": N_TRAIN_WARMUP, "steps": N_TRAIN_STEPS,
          "step_ms_p50": float(np.percentile(st, 50)), "step_ms_p99": float(np.percentile(st, 99)),
          "step_ms_mean": float(st.mean()), "step_ms": step_ms,
          "loss": losses, "idmap_inserted": inserted, "rows_live": expect_live,
          "rows_checked_at_step": N_TRAIN_WARMUP, **rows_check,
          "loss_on_one_repeated_batch": repeat,
          "max_memory_allocated_bytes_steps_1_2": train_peak, "allocated_before_bytes": base_bytes,
          "step_transient_bytes": train_peak - base_bytes, "state_bytes": tstate_bytes,
          "launches": train_launches,
          "launches_per_step": {k: v / n_steps for k, v in train_launches.items()}})
    for fn_name, fn in real.items():  # the wrappers record no more
        setattr(fg_ops if fn_name == "gather_rows" else fs_ops if fn_name.startswith("scatter") else sr_ops,
                fn_name, fn)
    del tstate, tbatches, train, step_ids, seen
    torch.cuda.empty_cache()

    # ------------------------------- 5 kernels on the serve and train inputs
    kernels_on_path = [  # (entry, wrapper, source, TPU kernel replaced, plain, paths, library call)
        ("fused_gather.gather_rows", "gather_rows", "fused_gather.cu",
         "src/repro/kernels/fused_gather/fused_gather.py:34", fg_ref.gather_rows,
         ("serve_p99", "serve_bulk", "train"), "torch.index_select"),
        ("segment_reduce.segment_sum", "segment_sum_csr", "segment_reduce.cu",
         "src/repro/kernels/segment_reduce/segment_reduce.py:87", sr_ref.segment_sum_csr,
         ("serve_p99", "serve_bulk", "train"), "zeros.index_add_"),
        ("segment_reduce.segment_expand_csr", "segment_expand_csr", "segment_reduce.cu",
         "src/repro/kernels/segment_reduce/ops.py:77", sr_ref.segment_expand_csr,
         ("train",), "torch.index_select (g[seg])"),
        ("fused_scatter.scatter_add_rows", "scatter_add_rows", "fused_scatter.cu",
         "src/repro/kernels/fused_scatter/fused_scatter.py:43", fs_ref.scatter_add_rows,
         ("train",), "index_add_"),
        ("fused_scatter.scatter_set_rows", "scatter_set_rows", "fused_scatter.cu",
         "src/repro/kernels/fused_scatter/fused_scatter.py:43", fs_ref.scatter_set_rows,
         ("train",), "index_copy_"),
    ]
    entries = []
    for full, kname, src_file, replaces, plain, paths, lib_call in kernels_on_path:
        at = {}
        for path in paths:
            args, kw = recorded.pop((kname, path))
            at[path] = _measure(kname, real[kname], plain, args, kw, 200 if path == "serve_p99" else 5, dev)
            del args
            torch.cuda.empty_cache()
        main_path = at[paths[0]]
        by_path = {"serve": launches[full], "train": train_launches[full]}
        entries.append({
            "name": full, "route": "cuda", "source": f"src/repro_torch/csrc/{src_file}",
            "replaces": replaces, "ok": True, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "main_path": paths[0],
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "max_err": max(a["max_abs_err"] for a in at.values()),
            "ms": main_path["ms"], "kernel_ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
            "library_ms": main_path["library_ms"], "library_call": lib_call, "at": at})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


def _measure(kname: str, real, plain, args: list, kw: dict, iters: int, dev) -> dict:
    """One kernel on one recorded input: checked against its plain version
    (bit-equal, or rtol = atol = 1e-5 for the sum), then timed beside the
    plain version and one PyTorch library call, with the card's bound."""
    n_ops = 0.0
    if kname.startswith("scatter"):  # in place: kernel and plain version on copies
        table, ids, rows = args[:3]
        valid = args[3] if len(args) > 3 else None
        mine, ref_copy = table.clone(), table.clone()
        real(mine, ids, rows, valid)
        plain(ref_copy, ids, rows, valid)
        torch.cuda.synchronize()
        ok, err = torch.equal(mine, ref_copy), 0.0
        del ref_copy
        live = (ids >= 0) & (ids < table.shape[0])
        live = live if valid is None else live & valid
        K, D, n_live = ids.numel(), table.shape[1], int(live.sum())
        idx, live_rows = ids[live].long(), rows[live]
        add = kname == "scatter_add_rows"
        n_bytes = n_live * D * 4 * (3 if add else 2) + K * (ids.element_size() + (valid is not None))
        n_ops = float(n_live * D) if add else 0.0
        shape = {"R": table.shape[0], "D": D, "K": K, "live_slots": n_live}
        lib = (lambda: mine.index_add_(0, idx, live_rows)) if add else (lambda: mine.index_copy_(0, idx, live_rows))
        run_kernel = lambda: real(mine, ids, rows, valid)
        run_plain = lambda: plain(mine, ids, rows, valid)
    else:
        got, want = real(*args, **kw), plain(*args)
        torch.cuda.synchronize()
        if kname == "segment_sum_csr":
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            err = float((got - want).abs().max()) if got.numel() else 0.0
        else:  # copies: bit-equal, no difference tensor at these sizes
            ok = torch.equal(got, want)
            err = 0.0 if ok else float("inf")
        del got, want
        run_kernel, run_plain = (lambda: real(*args, **kw)), (lambda: plain(*args))
        if kname == "gather_rows":
            tab, ids = args
            K, D = ids.numel(), tab.shape[1]
            idx = torch.where((ids >= 0) & (ids < tab.shape[0]), ids, 0).long()
            n_bytes = (torch.unique(idx).numel() + K) * D * 4 + K * ids.element_size()
            shape = {"R": tab.shape[0], "D": D, "K": K}
            lib = lambda: torch.index_select(tab, 0, idx)
        elif kname == "segment_sum_csr":
            vals, splits = args
            N, D = vals.shape
            S, live = splits.numel() - 1, int(splits[-1])
            pos = torch.arange(N, dtype=splits.dtype, device=dev)
            idx = torch.where(pos < live, torch.searchsorted(splits, pos, right=True) - 1, S)
            n_bytes = (live * D + S * D) * 4 + (S + 1) * splits.element_size()
            n_ops = float(live * D)
            shape = {"N": N, "live_rows": live, "D": D, "S": S}
            lib = lambda: torch.zeros((S + 1, D), device=dev).index_add_(0, idx, vals)
        else:  # segment_expand_csr: g (S, D) rows → n value rows
            g, splits, n = args
            S, D = g.shape
            pos = torch.arange(n, dtype=splits.dtype, device=dev)
            inside = (pos >= splits[0]) & (pos < splits[-1])
            idx = torch.where(inside, torch.searchsorted(splits, pos, right=True) - 1, S).long()
            g_ext = torch.cat([g, g.new_zeros((1, D))])  # the padding tail reads a zero row
            n_bytes = (S * D + n * D) * 4 + (S + 1) * splits.element_size()
            shape = {"S": S, "D": D, "N": n, "g_row_stride": g.stride(0)}
            lib = lambda: torch.index_select(g_ext, 0, idx)
    check(ok, f"{kname} disagrees with its plain version on the recorded inputs {shape}")
    lib_ms = time_ms(lib, iters)
    k_ms = time_ms(run_kernel, iters)
    p_ms = time_ms(run_plain, iters)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}


def _row_sample(state, touched: torch.Tensor, live: torch.Tensor, idmap_lib, n: int = 4096) -> dict:
    """Before a train step: offsets and rows (emb, m, v) of up to ``n`` live
    ids the step touches and of ``n`` live ids it does not."""
    gen = torch.Generator().manual_seed(SEED)
    old = touched[torch.isin(touched, live)]
    groups = {"touched": old, "untouched": live[~torch.isin(live, touched)]}
    m = state["sparse"]["dim128"]["idmap"].map(lambda x: x[0])
    b = state["sparse"]["dim128"]["blocks"].map(lambda x: x[0])
    out = {}
    for k, ids in groups.items():
        ids = ids[torch.randperm(ids.numel(), generator=gen)[:n].to(ids.device)]
        offs = idmap_lib.lookup(m, ids).long()
        check(ids.numel() > 0 and bool((offs != idmap_lib.OVERFLOW_ROW).all()), f"{k} ids not live")
        out[k] = (offs, b.emb[offs], b.slots["m"][offs], b.slots["v"][offs])
    return out


def _rows_moved(state, sample: dict, idmap_lib) -> dict:
    """After the step: every touched row moved (emb, m or v) and no
    untouched row changed a bit."""
    b = state["sparse"]["dim128"]["blocks"].map(lambda x: x[0])
    moved = {}
    for k, (offs, e0, m0, v0) in sample.items():
        e1, m1, v1 = b.emb[offs], b.slots["m"][offs], b.slots["v"][offs]
        changed = (e1 != e0).any(1) | (m1 != m0).any(1) | (v1 != v0).any(1)
        moved[k] = [int(changed.sum()), offs.numel()]
    check(moved["touched"][0] == moved["touched"][1], f"touched rows that did not move: {moved}")
    check(moved["untouched"][0] == 0, f"untouched rows that changed: {moved}")
    return {"touched_rows_moved": moved["touched"], "untouched_rows_changed": moved["untouched"]}


def profile_requests(cell_name: str, run, batches) -> dict:
    """Where a request's (or train step's) time goes: wall time (host clock,
    synced) against the union of the card's kernel intervals in a
    torch.profiler trace, the kernel count, and the kernels that take the
    most device time. ``run(batch)`` serves or trains on one batch. Device
    numbers are null when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            run(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of intervals
        if cur_e is None or s > cur_e:
            busy_us += (cur_e - cur_s) if cur_e is not None else 0.0
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += (cur_e - cur_s) if cur_e is not None else 0.0
    by_name: dict = {}
    for e in kern:  # names cut to 100 characters: template arguments run long
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    n = len(batches)
    measured = bool(kern)
    return {"phase": f"{cell_name}_profile", "requests": n, "wall_ms_per_request": wall_ms / n,
            "device_busy_ms_per_request": busy_us / 1e3 / n if measured else None,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if measured else None,
            "device_events_per_request": len(kern) / n if measured else None,
            "top_device_ms_per_request": {k: v / 1e3 / n for k, v in top} if measured else None}


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


if __name__ == "__main__":
    main()
