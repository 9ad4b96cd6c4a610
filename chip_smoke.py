#!/usr/bin/env python3
"""The PyTorch port serving dlrm-mlperf on one NVIDIA card, through its own
CUDA kernels.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/csrc`` (into ``build/``), then:

  1. device   — the card, its power limit, the kernel build time;
  2. kernels  — each CUDA kernel against its plain PyTorch version on random
                inputs (PAD and out-of-range ids, unsorted and empty
                segments, D not a multiple of 4, unaligned pointers);
  3. smoke    — the smoke-size serve cell on the card against the same cell
                on the CPU: same rows, params and batches;
  4. serve    — full-width dlrm-mlperf (vocab cut to 250,000 per feature):
                6.5 M rows imported, 20 serve_p99 requests (batch 512) and
                one serve_bulk request (batch 262,144), with the kernels'
                launch counts over that run, then torch.profiler traces of
                five serve_p99 requests and one serve_bulk request (device
                busy time, idle share, device operations per request);
  5. a ``{"kernels": [...]}`` line: each kernel on the exact inputs the
     serve path fed it, against its plain version, timed beside the plain
     version, one PyTorch library call and the card's bound.

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
MIXED_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 logits, card against CPU


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
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
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
    emit({"phase": "kernels_vs_plain", "cases": cases, "tolerance": {
        "gather_rows": "bit-equal", "segment_sum": "rtol=atol=1e-5 (summation order)",
        "segment_sum_csr": "rtol=atol=1e-5 (summation order)"}})

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

    def recorder(mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapper(*args, **kw):
            key = (fn_name, phase["name"])
            if phase["name"] and key not in recorded:
                recorded[key] = ([a.clone() if torch.is_tensor(a) and a.numel() < (1 << 28) else a
                                  for a in args], kw)
            return fn(*args, **kw)
        setattr(mod, fn_name, wrapper)
        return fn

    real_gather = recorder(fg_ops, "gather_rows")
    real_segsum = recorder(sr_ops, "segment_sum_csr")

    batches = {s: p99.make_batch(s, vocab=VOCAB) for s in range(N_WARMUP + N_P99_REQUESTS)}
    bulk_batch = bulk.make_batch(10_000, vocab=VOCAB)
    torch.cuda.synchronize()
    fg_ops.LAUNCHES = 0
    sr_ops.LAUNCHES = 0
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    bulk_out = bulk.step_fn(state, bulk_batch)
    end.record()
    end.synchronize()
    bulk_ms = start.elapsed_time(end)
    peak_bytes = torch.cuda.max_memory_allocated()
    phase["name"] = None
    launches = {"fused_gather.gather_rows": fg_ops.LAUNCHES,
                "segment_reduce.segment_sum": sr_ops.LAUNCHES}
    fg_ops.gather_rows, sr_ops.segment_sum_csr = real_gather, real_segsum
    n_req = N_WARMUP + N_P99_REQUESTS + 1
    check(launches["fused_gather.gather_rows"] == n_req, f"gather launches {launches}")
    check(launches["segment_reduce.segment_sum"] == n_req * mcfg.n_sparse, f"segment_sum launches {launches}")

    for out, batch_size in [(o, 512) for o in outs] + [(bulk_out, 262_144)]:
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
          "serve_p99": {"batch": 512, "requests": N_P99_REQUESTS, "warmup": N_WARMUP,
                        "latency_ms_p50": float(np.percentile(lat, 50)),
                        "latency_ms_p99": float(np.percentile(lat, 99)),
                        "latency_ms_mean": float(lat.mean()), "latency_ms": lat_ms,
                        "unique_ids_found": n_found[:-1]},
          "serve_bulk": {"batch": 262_144, "ms": bulk_ms, "unique_ids_found": n_found[-1],
                         "max_memory_allocated_bytes": peak_bytes},
          "launches": launches, "launches_per_request": {
              k: v / n_req for k, v in launches.items()}})
    del outs, bulk_out
    emit(profile_requests("serve_p99", p99, state,
                          [batches[s] for s in range(N_WARMUP, N_WARMUP + 5)]))
    emit(profile_requests("serve_bulk", bulk, state, [bulk_batch]))
    del batches, bulk_batch
    torch.cuda.empty_cache()

    # ------------------------------------------ 5 kernels on the serve inputs
    src = {"gather_rows": ("fused_gather", "gather_rows",
                           "src/repro/kernels/fused_gather/fused_gather.py:34"),
           "segment_sum_csr": ("segment_reduce", "segment_sum",
                               "src/repro/kernels/segment_reduce/segment_reduce.py:87")}
    entries = []
    for kname, real, plain in [("gather_rows", real_gather, fg_ref.gather_rows),
                               ("segment_sum_csr", real_segsum, sr_ref.segment_sum_csr)]:
        at = {}
        for cell_name in ("serve_p99", "serve_bulk"):
            args, kw = recorded[(kname, cell_name)]
            got = real(*args, **kw)
            want = plain(*args)
            torch.cuda.synchronize()
            if kname == "gather_rows":  # bit-equal, no difference tensor at 7 GB
                ok = torch.equal(got, want)
                err = 0.0 if ok else float("inf")
            else:
                ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
                err = float((got - want).abs().max()) if got.numel() else 0.0
            check(ok, f"{kname} disagrees with its plain version on the {cell_name} inputs")
            del got, want
            iters = 200 if cell_name == "serve_p99" else 5
            if kname == "gather_rows":
                tab, ids = args
                K, D = ids.numel(), tab.shape[1]
                idx = torch.where((ids >= 0) & (ids < tab.shape[0]), ids, 0).long()
                n_bytes = (torch.unique(idx).numel() + K) * D * 4 + K * ids.element_size()
                shape = {"R": tab.shape[0], "D": D, "K": K}
                lib_ms = time_ms(lambda: torch.index_select(tab, 0, idx), iters)
                n_ops = 0.0
            else:
                vals, splits = args
                N, D = vals.shape
                S, live = splits.numel() - 1, int(splits[-1])
                pos = torch.arange(N, dtype=splits.dtype, device=dev)
                idx = torch.where(pos < live, torch.searchsorted(splits, pos, right=True) - 1, S)
                n_bytes = (live * D + S * D) * 4 + (S + 1) * splits.element_size()
                n_ops = float(live * D)
                shape = {"N": N, "live_rows": live, "D": D, "S": S}
                lib_ms = time_ms(lambda: torch.zeros((S + 1, D), device=dev).index_add_(0, idx, vals),
                                 iters)
            k_ms = time_ms(lambda: real(*args, **kw), iters)
            p_ms = time_ms(lambda: plain(*args), iters)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            at[cell_name] = {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                             "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "bytes": n_bytes}
            del args, idx
            torch.cuda.empty_cache()
        main = at["serve_p99"]
        pkg, kernel, replaces = src[kname]
        full = f"{pkg}.{kernel}"
        entries.append({
            "name": full, "route": "cuda", "source": f"src/repro_torch/csrc/{pkg}.cu",
            "replaces": replaces, "ok": True, "launches": launches[full],
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "max_err": max(a["max_abs_err"] for a in at.values()),
            "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": "torch.index_select" if kname == "gather_rows" else "zeros.index_add_",
            "at": at})
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


def profile_requests(cell_name: str, cell, state, batches) -> dict:
    """Where a request's time goes: wall time (host clock, synced)
    against the union of the card's kernel intervals in a torch.profiler
    trace, the kernel count, and the kernels that take the most device time.
    Device numbers are null when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cell.step_fn(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            cell.step_fn(state, b)
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
