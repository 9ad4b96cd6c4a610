#!/usr/bin/env python3
"""The PyTorch port serving and training dlrm-mlperf, and serving the
qwen2.5-3b prefill, on one NVIDIA card, through its own CUDA kernels.

    python3 chip_smoke.py

Builds the kernels from ``src/repro_torch/csrc`` (into ``build/``), then:

  1. device   — the card, its power limit, the kernel build time;
  2. kernels  — each CUDA kernel against its plain PyTorch version on random
                inputs (PAD and out-of-range ids, unsorted and empty
                segments, invalid scatter slots, D not a multiple of 4,
                unaligned pointers, views of stacked tables; flash
                attention over head dims 16-128, T not a multiple of the
                tile, grouped kv heads, bf16 and fp32, strided inputs, an
                unaligned q refused);
  3. smoke    — the smoke-size serve cell, then three steps of the smoke
                train cell, then two qwen2.5 smoke prefill requests, on the
                card against the same cells on the CPU: same rows, params
                and batches;
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
     prefill  — full-width qwen2.5-3b prefill (T 32,768, batch cut to 1):
                rows for all 151,936 tokens imported, 1 warm-up and 3 timed
                requests with the kernels' launch counts, output checks,
                layer 0's attention against the plain formula on every
                query row, a torch.profiler trace of one request;
  5. a ``{"kernels": [...]}`` line: each kernel on the exact inputs the
     serve, train and prefill paths fed it, against its plain version,
     timed beside the plain version, one PyTorch library call and the
     card's bound.

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
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
VOCAB = 250_000             # per feature; the published 4,000,000 needs 240 GB
N_P99_REQUESTS, N_WARMUP = 20, 3
N_TRAIN_WARMUP, N_TRAIN_STEPS, N_REPEAT = 3, 10, 10
MIXED_TOL = dict(rtol=2e-2, atol=2e-2)  # bf16 logits and loss, card against CPU
# Train state, card against CPU after 3 smoke steps (bf16 dense compute; the
# reasons are in tests/test_torch_train.py): rows and params within
# 2 * lr * steps, the rows' moments within 5e-2 of their largest magnitude.
TRAIN_PARAM_ATOL = 2 * 1e-3 * 3
TRAIN_MOMENT_FRAC = 5e-2
# Flash attention against its plain version: both keep fp32 statistics and
# round O once, so O may differ by one rounding: |got - want| <= rtol * |want|
# + atol * max|want|, rtol 1e-2 in bf16 (a bf16 ulp is at most 2^-7 of the
# value) and 1e-4 in fp32 (summation order), atol 1e-3 in bf16 and 1e-4 in
# fp32. A zero output, or one from the wrong kv head, reads far above it.
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
# bf16 prefill logits and cache, card against CPU: each value may sit a bf16
# ulp or two apart (|x| < 4 here, one ulp <= 2^-6), as in tests/test_torch_lm.py
MIXED_PREFILL_TOL = dict(rtol=3e-2, atol=3e-2)
LSE_TOL = 1e-4
FLASH_CASES = [  # B, T, H, Hk, hd, dtype, causal
    (1, 128, 2, 2, 64, torch.float32, True), (2, 200, 4, 2, 16, torch.float32, True),
    (1, 1024, 8, 1, 128, torch.bfloat16, True), (2, 1024, 16, 2, 128, torch.bfloat16, True),
    (1, 200, 8, 8, 32, torch.bfloat16, True), (2, 128, 4, 4, 128, torch.float32, True),
    (1, 1024, 4, 2, 64, torch.bfloat16, True), (1, 200, 2, 1, 128, torch.float32, True),
    (2, 200, 4, 2, 64, torch.float32, False), (1, 1024, 2, 1, 16, torch.bfloat16, False),
]
PREFILL_T, N_PREFILL = 32_768, 3   # prefill_32k; timed requests after one warm-up
PLAIN_ROWS = 1_024  # query rows per piece of the plain version at T 32,768 (whole, its scores take 68 GB)


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


def flash_excess(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """The largest |got - want| over what FLASH_TOL allows it: at most 1 passes."""
    rtol, atol = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    allow = (rtol * want.abs() + atol * want.abs().max()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / allow).max())


def plain_flash_chunked(ref, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rows: int = PLAIN_ROWS):
    """The plain causal formula (``ref.flash_fwd``) over query rows [s, e),
    each against keys [0, e): the whole result, in pieces that fit."""
    outs, lses = [], []
    for s in range(0, q.shape[1], rows):
        e = min(s + rows, q.shape[1])
        o, lse = ref.flash_fwd(q[:, s:e], k[:, :e], v[:, :e])
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, 2)


def bound_ms(n_bytes: float, n_ops: float = 0.0, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import dlrm_mlperf, qwen2_5_3b
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.feature_engine import FeatureEngine
    from repro_torch.io.ragged import Ragged
    from repro_torch.core import idmap as idmap_lib
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.launch import recsys_cell
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.common import local_view

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
                                   (4_000, 128, 3_000, torch.int64, True), (7, 4, 1, torch.int32, False),
                                   (20_000, 2048, 32_768, torch.int64, False)]:  # prefill's D
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
    for B, T, H, Hk, hd, dt, causal, layout in [(*c, "contiguous") for c in FLASH_CASES] + [
            (2, 300, 8, 2, 64, torch.float32, True, "fused qkv view"),
            (1, 256, 4, 2, 128, torch.bfloat16, True, "q unaligned")]:
        if layout == "fused qkv view":  # q, k, v as head slices of one projection
            fused = torch.from_numpy(rng.normal(size=(B, T, H + 2 * Hk, hd)).astype(np.float32)).to(dev)
            q, k, v = fused[:, :, :H], fused[:, :, H:H + Hk], fused[:, :, H + Hk:]
        else:
            q, k, v = (torch.from_numpy(rng.normal(size=(B, T, n, hd)).astype(np.float32)).to(dt).to(dev)
                       for n in (H, Hk, Hk))
            q = unaligned(q) if layout == "q unaligned" else q
        before = fa_ops.LAUNCHES
        if layout == "q unaligned":  # the kernel's 16-byte loads cannot read it in place
            try:
                fa_ops.flash_fwd(q, k, v, causal)
                refused = False
            except ValueError:
                refused = True
            cases.append({"kernel": "flash_fwd", "B": B, "T": T, "H": H, "Hk": Hk, "hd": hd,
                          "dtype": str(dt), "layout": layout, "refused": refused})
            check(refused and fa_ops.LAUNCHES == before, f"flash_fwd took {cases[-1]}")
            continue
        o, lse = fa_ops.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        want_o, want_lse = fa_ref.flash_fwd(q, k, v, causal)
        err = float((o.float() - want_o.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        excess = flash_excess(o, want_o, dt)
        cases.append({"kernel": "flash_fwd", "B": B, "T": T, "H": H, "Hk": Hk, "hd": hd, "dtype": str(dt),
                      "causal": causal, "layout": layout, "max_abs_err": err, "lse_max_abs_err": lse_err,
                      "max_abs_o": float(want_o.float().abs().max()), "o_err_over_tol": excess,
                      "zero_output_err_over_tol": flash_excess(torch.zeros_like(want_o), want_o, dt)})
        check(fa_ops.LAUNCHES == before + 1, f"flash_fwd did not launch at {cases[-1]}")
        check(o.dtype == dt and excess <= 1.0 and torch.allclose(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL),
              f"flash_fwd disagrees at {cases[-1]}")
    emit({"phase": "kernels_vs_plain", "cases": cases, "tolerance": {
        "gather_rows": "bit-equal", "segment_sum": "rtol=atol=1e-5 (summation order)",
        "segment_sum_csr": "rtol=atol=1e-5 (summation order)",
        "scatter_add_rows": "bit-equal", "scatter_set_rows": "bit-equal",
        "segment_expand_csr": "bit-equal (a copy)",
        "flash_fwd": "O: |got - want| <= rtol |want| + atol max|want| (o_err_over_tol <= 1), (rtol, atol) "
                     f"{FLASH_TOL[torch.float32]} fp32, {FLASH_TOL[torch.bfloat16]} bf16 (one rounding); "
                     f"LSE rtol=atol {LSE_TOL}; an unaligned q is refused"}})

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

    # -------------------------------------------- 3 smoke prefill, card vs CPU
    pshape = ShapeCell("prefill_32k", "prefill", {"seq_len": 256, "global_batch": 2})
    psmoke = {d: build_cell("qwen2.5-3b", "prefill_32k", smoke=True, shape_override=pshape, device=d)
              for d in ("cpu", "cuda")}
    pcfg = psmoke["cpu"].arch.model
    tokens = {"tokens": Ragged(torch.arange(pcfg.vocab_size, dtype=torch.int64),
                               torch.tensor([0, pcfg.vocab_size], dtype=torch.int32))}
    ids = psmoke["cpu"].engine.engine_ids(tokens)[f"dim{pcfg.d_model}"].numpy()
    ids = np.delete(ids, np.arange(0, ids.size, 7))  # some tokens missing: they read as zero rows
    n = ids.size
    rows = {f"dim{pcfg.d_model}": {"ids": ids, "emb": rng.normal(size=(n, pcfg.d_model)).astype(np.float32),
                                   "slots": {k: np.zeros((n, pcfg.d_model), np.float32) for k in ("m", "v")},
                                   "last_use": np.ones(n, np.int32)}}
    states = {}
    for d, cell in psmoke.items():
        states[d] = cell.init_state()
        states[d]["sparse"] = cell.engine.import_rows(rows)
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    diffs = {}
    for s in (0, 1):
        before = fa_ops.LAUNCHES
        outs = {d: cell.step_fn(states[d], cell.make_batch(s)) for d, cell in psmoke.items()}
        check(fa_ops.LAUNCHES == before + pcfg.n_layers, "smoke prefill: one flash launch per layer")
        met = {d: {k: int(v) for k, v in o.items() if "/" in k} for d, o in outs.items()}
        check(met["cuda"] == met["cpu"], f"smoke prefill metrics differ: {met}")
        for k in ("logits", "cache_k", "cache_v"):
            got, want = outs["cuda"][k].float().cpu(), outs["cpu"][k].float()
            check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MIXED_PREFILL_TOL),
                  f"smoke prefill {k} differs by {(got - want).abs().max()}")
            diffs[k] = max(diffs.get(k, 0.0), float((got - want).abs().max()))
    emit({"phase": "smoke_prefill_card_vs_cpu", "arch": "qwen2.5-3b (smoke)", "seq_len": 256, "batch": 2,
          "requests": 2, "metrics": met["cuda"], "max_abs_diff": diffs, "tolerance": MIXED_PREFILL_TOL})
    del psmoke, states, outs

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
            "scatter_set_rows": recorder(fs_ops, "scatter_set_rows", whole=True),
            "flash_attention": recorder(fa_ops, "flash_attention")}

    def counts() -> dict:
        return {"fused_gather.gather_rows": fg_ops.LAUNCHES,
                "segment_reduce.segment_sum": sr_ops.LAUNCHES,
                "segment_reduce.segment_expand_csr": sr_ops.LAUNCHES_BWD,
                "fused_scatter.scatter_add_rows": fs_ops.LAUNCHES_ADD,
                "fused_scatter.scatter_set_rows": fs_ops.LAUNCHES_SET,
                "flash_attention.flash_fwd": fa_ops.LAUNCHES}

    def reset_counts() -> None:
        fg_ops.LAUNCHES = sr_ops.LAUNCHES = sr_ops.LAUNCHES_BWD = 0
        fs_ops.LAUNCHES_ADD = fs_ops.LAUNCHES_SET = fa_ops.LAUNCHES = 0

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
                local_view(state["sparse"]), ids, state["step"], train=False)
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
    check(all(v > 0 for k, v in train_launches.items() if not k.startswith("flash")),
          f"a kernel of the train path never ran: {train_launches}")
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
    del tstate, tbatches, train, step_ids, seen
    torch.cuda.empty_cache()

    # ---------------------------------------------------- 4 full-width prefill
    lm_cfg = qwen2_5_3b.ARCH.model
    V, d_model, L_lm = lm_cfg.vocab_size, lm_cfg.d_model, lm_cfg.n_layers
    pshape = ShapeCell("prefill_32k", "prefill", {"seq_len": PREFILL_T, "global_batch": 1})
    check(qwen2_5_3b.ARCH.shape("prefill_32k")["seq_len"] == PREFILL_T, "prefill_32k seq_len")
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()  # what earlier phases still hold (recorded inputs)
    t0 = time.perf_counter()
    pre = build_cell("qwen2.5-3b", "prefill_32k", shape_override=pshape, device=dev)
    gkey = f"dim{d_model}"
    pstate = pre.init_state()  # weights from a seeded generator
    vocab = {"tokens": Ragged(torch.arange(V, dtype=torch.int64, device=dev),
                              torch.tensor([0, V], dtype=torch.int32, device=dev))}
    all_ids = pre.engine.engine_ids(vocab)[gkey]
    check(torch.unique(all_ids).numel() == V, "engine ids of distinct tokens collide")
    emb = torch.randn((V, d_model), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    zeros = torch.zeros((V, d_model), dtype=torch.float32, device=dev)
    pstate["sparse"] = pre.engine.import_rows({gkey: {
        "ids": all_ids, "emb": emb, "slots": {"m": zeros, "v": zeros},
        "last_use": torch.zeros(V, dtype=torch.int32, device=dev)}})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del emb, zeros, all_ids, vocab
    check(int(pstate["sparse"][gkey]["idmap"].n_live()) == V, "not every token's row is live")
    dense_bytes = sum(p.numel() * p.element_size() for p in pstate["dense"].parameters())
    sparse_bytes = sum(t.numel() * t.element_size() for t in _tensors(pstate["sparse"]))
    pbatches = [pre.make_batch(30_000 + s) for s in range(1 + N_PREFILL)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    prefill_ms = []
    for s, batch in enumerate(pbatches):
        phase["name"] = "prefill" if s == 1 else None  # layer 0's attention inputs, first timed request
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pout = pre.step_fn(pstate, batch)
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= 1:
            prefill_ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in pout.items() if "/" in k}
        check(all(v == 0 for k, v in met.items() if "overflow" in k), f"prefill overflow: {met}")
        check(met[f"{gkey}/dev_rows_live"] == V, f"prefill rows live: {met}")
        check(pout["logits"].shape == (1, V) and pout["logits"].dtype == torch.float32
              and bool(torch.isfinite(pout["logits"]).all()), "prefill logits")
        for k in ("cache_k", "cache_v"):
            c = pout[k]
            check(c.shape == (L_lm, 1, PREFILL_T, lm_cfg.n_kv_heads, lm_cfg.head_dim)
                  and c.dtype == torch.bfloat16 and bool(torch.isfinite(c).all()), f"prefill {k}")
        del pout
    prefill_launches = counts()
    prefill_peak = torch.cuda.max_memory_allocated() - held_before
    n_pre = len(pbatches)
    check(prefill_launches["flash_attention.flash_fwd"] == L_lm * n_pre
          and prefill_launches["fused_gather.gather_rows"] == n_pre,
          f"prefill launches {prefill_launches}")
    for fn_name, fn in real.items():  # the wrappers record no more
        setattr(fg_ops if fn_name == "gather_rows" else fs_ops if fn_name.startswith("scatter")
                else fa_ops if fn_name.startswith("flash") else sr_ops, fn_name, fn)
    found = []  # every token of every request was found (valid_r), after the counted run
    for batch in pbatches:
        with torch.inference_mode():
            _, _, plans, _ = pre.engine.fetch_local(local_view(pstate["sparse"]), pre.ids_fn(batch),
                                                    pstate["step"], train=False)
        got, want = int(plans[gkey].valid_r.sum()), torch.unique(batch).numel()
        check(got == want, f"prefill: {got} of {want} distinct tokens found")
        found.append(got)
        del plans
    # layer 0's attention on every query row against the plain formula (in
    # pieces: its whole (H, T, T) score tensor would take 68 GB), and what a
    # zero output or one from the other kv head would read
    q0, k0, v0 = recorded[("flash_attention", "prefill")][0]
    o0, lse0 = fa_ops.flash_fwd(q0, k0, v0)
    want_o, want_l = plain_flash_chunked(fa_ref, q0, k0, v0)
    wrong_o, _ = plain_flash_chunked(fa_ref, q0, k0.flip(2), v0.flip(2))
    layer0 = {"max_abs_o": float(want_o.float().abs().max()),
              "o_max_abs_err": float((o0.float() - want_o.float()).abs().max()),
              "o_err_over_tol": flash_excess(o0, want_o, q0.dtype),
              "lse_max_abs_err": float((lse0 - want_l).abs().max()),
              "zero_output_err_over_tol": flash_excess(torch.zeros_like(want_o), want_o, q0.dtype),
              "other_kv_head_err_over_tol": flash_excess(wrong_o, want_o, q0.dtype)}
    check(layer0["o_err_over_tol"] <= 1.0 and torch.allclose(lse0, want_l, rtol=LSE_TOL, atol=LSE_TOL),
          f"prefill layer 0 attention {layer0}")
    check(layer0["zero_output_err_over_tol"] > 1.0 and layer0["other_kv_head_err_over_tol"] > 1.0,
          f"the layer 0 check cannot tell a wrong output: {layer0}")
    del o0, lse0, want_o, want_l, wrong_o
    pm = np.array(prefill_ms)
    emit({"phase": "full_prefill", "arch": "qwen2.5-3b", "shape": "prefill_32k", "widths": {
              "n_layers": L_lm, "d_model": d_model, "n_heads": lm_cfg.n_heads, "n_kv_heads": lm_cfg.n_kv_heads,
              "d_ff": lm_cfg.d_ff, "vocab_size": V, "qkv_bias": lm_cfg.qkv_bias, "rope_theta": lm_cfg.rope_theta},
          "seq_len": PREFILL_T, "reduced": {"global_batch": [32, 1]},
          "warmup": 1, "requests": N_PREFILL, "setup_s": setup_s,
          "request_ms_p50": float(np.percentile(pm, 50)), "request_ms_mean": float(pm.mean()),
          "request_ms": prefill_ms, "tokens_per_s": PREFILL_T / (float(pm.mean()) / 1e3),
          "distinct_tokens_found": found, "layer0_attention_vs_plain": layer0,
          "dense_param_bytes": dense_bytes, "engine_state_bytes": sparse_bytes,
          "max_memory_allocated_bytes": prefill_peak, "held_from_earlier_phases_bytes": held_before,
          "launches": prefill_launches,
          "launches_per_request": {k: v / n_pre for k, v in prefill_launches.items()}})
    emit(profile_requests("prefill", lambda b: pre.step_fn(pstate, b), pbatches[1:2]))
    del pstate, pre, pbatches
    torch.cuda.empty_cache()

    # ------------------------------- 5 kernels on the serve and train inputs
    kernels_on_path = [  # (entry, wrapper, source, TPU kernel replaced, plain, paths, library call)
        ("fused_gather.gather_rows", "gather_rows", "fused_gather.cu",
         "src/repro/kernels/fused_gather/fused_gather.py:34", fg_ref.gather_rows,
         ("serve_p99", "serve_bulk", "train", "prefill"), "torch.index_select"),
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
        by_path = {"serve": launches[full], "train": train_launches[full], "prefill": prefill_launches[full]}
        entries.append({
            "name": full, "route": "cuda", "source": f"src/repro_torch/csrc/{src_file}",
            "replaces": replaces, "ok": True, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "main_path": paths[0],
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "max_err": max(a["max_abs_err"] for a in at.values()),
            "ms": main_path["ms"], "kernel_ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
            "library_ms": main_path["library_ms"], "library_call": lib_call, "at": at})
    flash = _measure_flash(real["flash_attention"], fa_ref, *recorded.pop(("flash_attention", "prefill"))[0])
    entries.append({
        "name": "flash_attention.flash_fwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83", "ok": True,
        "launches": prefill_launches["flash_attention.flash_fwd"],
        "launches_by_path": {"serve": launches["flash_attention.flash_fwd"],
                             "train": train_launches["flash_attention.flash_fwd"],
                             "prefill": prefill_launches["flash_attention.flash_fwd"]},
        "main_path": "prefill", "max_abs_err": layer0["o_max_abs_err"],
        "max_err": layer0["o_max_abs_err"], "kernel_ms": flash["ms"], "library_call":
        "F.scaled_dot_product_attention(is_causal=True), kv expanded", **flash})
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


def _measure_flash(real, ref, q, k, v) -> dict:
    """The flash kernel on layer 0's recorded prefill inputs, timed beside
    its plain version (in query-row pieces, ``plain_flash_chunked``) and
    scaled_dot_product_attention on the same q and the expanded k, v."""
    import torch.nn.functional as F

    B, T, H, hd = q.shape
    ke, ve = (ref.expand_kv(x, H // k.shape[2]).transpose(1, 2) for x in (k, v))
    qt = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True), 3)
    del ke, ve, qt
    k_ms = time_ms(lambda: real(q, k, v), 3)
    p_ms = time_ms(lambda: plain_flash_chunked(ref, q, k, v), 2)
    n_ops = 4.0 * hd * H * B * T * (T + 1) / 2  # two products over the causal triangle
    # q, k, v read once; O (q's shape and type) and the fp32 LSE written once
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + B * H * T * 4
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "plain_rows_per_piece": PLAIN_ROWS,
            "at": {"prefill": {"shape": {"B": B, "T": T, "H": H, "Hk": k.shape[2], "hd": hd,
                                         "dtype": str(q.dtype), "causal": True},
                               "flops": n_ops, "bytes": n_bytes, "tflops_per_s": n_ops / k_ms / 1e9}}}


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
