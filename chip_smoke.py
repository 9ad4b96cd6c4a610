#!/usr/bin/env python3
"""The PyTorch port serving and training dlrm-mlperf, training the MSE
ranking model of examples/train_mse.py (its step at full size, its main()
with checkpoints and a resume), and serving the qwen2.5-3b prefill and
training qwen2.5-3b, on one NVIDIA card, through its own CUDA kernels.

    python3 chip_smoke.py [--save-inputs DIR]

Builds the kernels from ``src/repro_torch/csrc`` (into ``build/``), then:

  1. device   — the card, its power limit, the kernel build time, and
                each kernel's registers, spills and static shared memory
                as ptxas reported them in the build, and the HGMMA
                (wgmma) count of each kernel's SASS: the bf16 flash kernels
                must have some, and no spills at hd 128;
  2. kernels  — each CUDA kernel against its plain PyTorch version on random
                inputs (PAD and out-of-range ids, the row gather at D 1-2,048
                with K not a multiple of its 32-row chunks, the slab gather's
                partial-tail and one-PAD traps, unsorted and empty
                segments, invalid scatter slots (90% and all of them, no
                mask, K not a multiple of 32, D 8 to 2,048), D not a
                multiple of 4, unaligned pointers, views of stacked tables;
                the grouped segment sum and its gradient over 1 to 70
                features, one launch a group of up to 64 each way, bit-equal
                to the per-feature kernel and to the plain gradient, with
                empty features, other poolings' rows between, strided and
                missing gradients; flash
                attention forward and backward over head dims 8-128, T not
                a multiple of the tile (64, 127, 129, 4,096 among them),
                grouped kv heads, bf16 and fp32, strided inputs in both, an
                unaligned q refused, every bf16 launch on the tensor-core
                kernels (counted on the C side); fused bucketize on
                every boundary and a float step either side, ±inf, NaN,
                ±0.0, subnormals, widths 0 to 3,000, fp64 input, the
                engine's contiguous columns at the MSE and operator
                shapes, ids in any order, out-of-range ids, tables over the
                staging room and 48 KB, N < 4 and N % 4 != 0, values at an
                unaligned address, each case launched twice (bit-equal) on
                the paths its plan gives (counted on the C side); sequence
                tile and untile over empty rows, rows longer than k and a
                padding tail, D 8-128, k 1-50, int32 and int64 splits; the
                untile also over rows of length k - 1, k and 10k, a first
                split past 0, an unaligned g and no rows at all);
  3. smoke    — the smoke-size serve cell, then three steps of the smoke
                train cell, then two qwen2.5 smoke prefill requests, then
                three qwen2.5 smoke train steps, then three steps of the MSE
                example's cell at its own size, on the card against the
                same cells on the CPU: same rows, params and batches;
  4. serve    — full-width dlrm-mlperf (vocab cut to 250,000 per feature):
                6.5 M rows imported, 20 serve_p99 requests (batch 512) and
                two serve_bulk requests (batch 262,144: the first at that
                size, then a warm one), with the kernels' launch counts
                over that run (one grouped segment sum a request), then
                torch.profiler traces of five serve_p99 requests and one
                serve_bulk request (device busy time, idle share, device
                operations and fp32 add and fill time per request);
     train    — full-width train_batch (batch 65,536) from a fresh state:
                3 warm-up and 10 timed steps with the kernels' launch counts
                over the 13, state checks, a torch.profiler trace of three
                steps, and ten steps on one repeated batch (the loss falls);
     prefill  — full-width qwen2.5-3b prefill (T 32,768, batch cut to 1):
                rows for all 151,936 tokens imported, 1 warm-up and 3 timed
                requests with the kernels' launch counts, output checks,
                layer 0's attention against the plain formula on every
                query row, a torch.profiler trace of one request; then the
                serve, train and prefill kernels are measured (phase 5) and
                everything those paths held is released;
     mse      — the MSE example's widths at batch 65,536 with its budgets
                raised to hold the whole batch, from a fresh state: 3
                warm-up and 10 timed steps with the kernels' launch counts,
                overflow and row checks, a torch.profiler trace of three
                steps, ten steps on one repeated batch; then the step at the
                example's own batch of 128; then the MSE kernels are
                measured (phase 5) and everything is released;
     loop     — the MSE example's main() (the twin's, on the card, at the
                example's settings: batch 128, --rows 4096, one loader
                thread): 60 steps with checkpoints every 20, then 40 steps
                in a second directory and a run resumed there to step 60;
                the resumed losses against the uninterrupted run's, the
                loss falling, the checkpoint's leaf names, the loader's
                overflow, the launch counts, steps/s and the tracer's phase
                shares; then the slab gather is called once through its op
                entry (its launch counted) and measured (phase 5);
     lm train — full-width qwen2.5-3b train_4k (T 4,096, batch cut to 1)
                from a fresh state on an emptied card: 2 warm-up and 5
                timed steps with the kernels' launch counts, state and
                memory checks, layer 0's attention gradients against the
                plain backward on every row, a torch.profiler trace of one
                step, three steps on one repeated batch (the loss falls);
                then the scatter on its D-2,048 inputs and the fp32 flash
                kernels at T 1,024, H 16, Hk 2, hd 128 are measured;
  5. a ``{"kernels": [...]}`` line: each kernel on the exact inputs the
     serve, train, prefill, MSE train and LM train paths fed it (and the
     bucketize kernel at the operator benchmark's shape too, with
     contiguous and with random column ids, each also on its cached path
     and after a 256 MB read flush, with its path counts; the slab
     gather, which no path calls, at the operator benchmark's gather shape
     and at D 128; the per-feature segment-sum pair, which no path calls
     since each dim group pools at once, on feature 0's slice of the
     group's inputs, and driven once at its op entry, counted as path
     ``csr_op``), against its plain version, timed beside the plain
     version, one PyTorch library call and the card's bound, by profiler
     events with a cold L2, and by the host clock around 200 calls with no
     synchronise (``host_us``: the wrapper's cost to its caller); the row
     gather on every path that calls it, the MSE (D 8) and LM train (D
     2,048) steps included; the flash kernels also launched twice on their
     path's inputs (bit-equal).

Every check raises on failure, so the script exits non-zero. It prints one
JSON object per line; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import re
import shutil
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
    # head dims the kernels take zero-padded to the next of 16, 32, 64, 128
    (1, 200, 4, 2, 8, torch.float32, True), (2, 128, 2, 1, 8, torch.bfloat16, True),
    (1, 300, 4, 4, 48, torch.float32, True), (1, 1024, 4, 2, 48, torch.bfloat16, False),
    # the bf16 tensor-core kernels' edges: T below, at and either side of a
    # 64-row box and at the train length, at qwen2.5-3b's heads (G = 8); a
    # full (non-causal) hd-128 case; G = 8 at hd 64
    (1, 64, 16, 2, 128, torch.bfloat16, True), (1, 127, 16, 2, 128, torch.bfloat16, True),
    (1, 129, 16, 2, 128, torch.bfloat16, True), (1, 4096, 16, 2, 128, torch.bfloat16, True),
    (2, 300, 8, 2, 128, torch.bfloat16, False), (2, 256, 8, 1, 64, torch.bfloat16, True),
]
# strided layouts: q, k, v as head slices of one fused projection (and, in
# the backward, a dO with strides of its own), in fp32 and in bf16
STRIDED_CASES = [(2, 300, 8, 2, 64, torch.float32, True, "fused qkv view"),
                 (2, 300, 8, 2, 128, torch.bfloat16, True, "fused qkv view"),
                 (1, 200, 16, 2, 64, torch.bfloat16, False, "fused qkv view")]
# The slab gather against its plain version: (name, R, D, K, ids in [lo, hi),
# rows_blk, slab, id dtype, unaligned table), sorted ids. "reference" is
# tests/test_kernels.py's regime; "straddle" the partial-tail trap (a run
# across the 1,024 window edge, the last run's min the padding's id 0);
# "one_pad" one PAD id in a run of 128 high ids (the other 127 read zero).
SLAB_CASES = [
    ("reference", 2_048, 64, 512, 0, 384, 128, 512, torch.int32, False),
    ("straddle", 2_048, 16, 200, 1_000, 1_300, 128, 512, torch.int32, False),
    ("one_pad", 2_048, 32, 128, 1_536, 2_048, 128, 512, torch.int64, False),
    ("out_of_range", 1_000, 16, 700, -40, 1_040, 128, 512, torch.int64, False),
    ("small_table", 100, 8, 300, 0, 100, 128, 512, torch.int32, False),
    ("d1", 4_096, 1, 1_000, 0, 4_096, 128, 512, torch.int64, False),
    ("d5", 3_000, 5, 777, 0, 3_000, 64, 256, torch.int32, False),
    ("d16", 8_192, 16, 2_048, 0, 8_192, 128, 512, torch.int64, False),
    ("d128", 4_096, 128, 640, 0, 600, 128, 512, torch.int32, False),
    ("unaligned", 4_096, 64, 1_000, 0, 4_096, 128, 512, torch.int64, True),
]
# The row gather against its plain version: (R, D, K, id dtype, table 4
# bytes off a 16-byte boundary), ids in [-2, R + 2) (PAD and out-of-range).
# serve_p99's K and D; D 8 (the MSE step) at K not a multiple of the
# kernel's 32-row chunks; D 5 and 13 (the scalar path); D 2,048 (qwen2.5-3b)
GATHER_CASES = [(100_000, 128, 26_624, torch.int32, False), (5_000, 13, 1_000, torch.int64, False),
                (4_000, 128, 3_000, torch.int64, True), (7, 4, 1, torch.int32, False),
                (20_000, 2048, 32_768, torch.int64, False), (50_000, 8, 65_537, torch.int32, False),
                (3_000, 8, 1_001, torch.int64, False), (4_000, 2048, 1_000, torch.int32, True),
                (5_000, 5, 3_001, torch.int64, True), (8_000, 5, 700, torch.int32, False)]
# The untile's edge cases: (D, k, first split, splits dtype, g 4 bytes off a
# 16-byte boundary); 70 rows with lengths k - 1, k and 10k among them, every
# fifth empty, and a padding tail of 9; k 0 stands for no rows at all (k 4)
UNTILE_CASES = [(D, k, head, sdt, False) for D in (8, 13, 128) for k in (1, 8, 50) for head in (0, 5)
                for sdt in (torch.int32, torch.int64)] + [(128, 8, 5, torch.int64, True), (8, 0, 3, torch.int32, False)]
# The scatter against its plain version: (R, D, K, id dtype, rows and table
# 4 bytes off a 16-byte boundary, with a valid mask, share of valid slots).
# Unique ids, some out of range; D 8 (the MSE step), 13 (the scalar path),
# 128 (dlrm), 2,048 (qwen2.5-3b); 90% and all slots invalid; no mask; K not a
# multiple of the kernel's 32-slot chunks, and below one chunk
SCATTER_CASES = [
    (100_000, 128, 30_000, torch.int32, False, True, 0.7), (5_000, 13, 1_000, torch.int64, False, True, 0.7),
    (4_000, 128, 3_000, torch.int64, True, True, 0.7), (2_000, 64, 500, torch.int32, False, False, 0.7),
    (50, 8, 0, torch.int32, False, True, 0.7), (2_000_000, 8, 1_048_573, torch.int32, False, True, 0.35),
    (400_000, 128, 350_001, torch.int64, False, True, 0.1), (20_000, 2_048, 10_000, torch.int64, False, True, 0.5),
    (3_000, 13, 2_999, torch.int32, True, True, 0.5), (10_000, 128, 8_000, torch.int32, False, True, 0.0),
    (5_000, 16, 4_097, torch.int64, False, False, 1.0), (100, 8, 31, torch.int64, True, True, 0.9),
]
# The grouped segment sum and its gradient against their plain versions and
# the per-feature kernels: (features, D, splits dtype, rows per feature).
# 26 and 61 are the dlrm and MSE groups' sum features; 70 takes two launches.
GROUP_CASES = [(1, 8, torch.int32, 300), (26, 128, torch.int32, 512), (61, 8, torch.int64, 700),
               (3, 13, torch.int64, 200), (70, 16, torch.int32, 100)]
# The slab gather at the operator benchmark's gather shape
# (benchmarks/table1_operators.py:36-38: a 1,048,576 x 16 fp32 table, 200,000
# ids), with its runs of 128 sorted ids inside one 512-row window, and at D 128
SLAB_R, SLAB_K = 1_048_576, 200_000
# The MSE example's main() (examples/train_mse.py: batch 128, --rows 4096)
LOOP_ROWS, LOOP_STEPS, LOOP_RESUME_AT = 4_096, 60, 40
PREFILL_T, N_PREFILL = 32_768, 3   # prefill_32k; timed requests after one warm-up
LM_TRAIN_T = 4_096  # train_4k
N_LM_WARMUP, N_LM_STEPS, N_LM_REPEAT = 2, 5, 3
PLAIN_ROWS = 1_024  # query rows per piece of the plain version at T 32,768 (whole, its scores take 68 GB)
# The MSE model at full size: the example's widths at the recsys train_batch
# batch, every budget raised so the card does the whole batch's work (about
# 5.05 M ids and 0.7 M unique ids a step; 8 M rows after 25 steps)
MSE_BATCH = 65_536
MSE_BUDGET = 2_097_152          # u_budget = per_dest_cap = recv_budget
MSE_ROWS, MSE_MAP = 16_777_216, 33_554_432
MSE_ROW_ATOL = 2 * 1e-2 * 3     # SparseAdam lr 1e-2, 3 steps (reasons in tests/test_torch_mse.py)
MSE_LATER_MOMENT_FRAC = 0.25    # the rows' moments after 3 steps, of their largest magnitude
# the operator benchmark's bucketize (benchmarks/table1_operators.py:34-45):
# 100 columns of 2,000 values, column widths 8-63
OP_COLS, OP_VALS = 100, 2_000
DLRM_TRAIN_KERNELS = ("fused_gather.gather_rows", "segment_reduce.segment_sum_csr_group",
                      "segment_reduce.segment_expand_csr_group", "fused_scatter.scatter_add_rows",
                      "fused_scatter.scatter_set_rows")
OP_WIDTHS = [int(w) for w in np.random.default_rng(SEED + 1).integers(8, 64, OP_COLS)]  # widths 8-63
BUCKET_CASES = [  # column widths, N, value type, column-id layout (bucket_case), values 4 bytes off 16
    ([17] * 20, 2_560, np.float32, "random", False), ([1], 1_000, np.float32, "random", False),
    ([1_000, 17, 1], 4_097, np.float32, "random", False), ([3_000] * 5, 70_001, np.float32, "random", False),
    ([17] * 20, 5_003, np.float64, "random", False), (OP_WIDTHS, OP_COLS * OP_VALS, np.float32, "random", False),
    ([17] * 20, 1_310_720, np.float32, "contiguous", False),   # the MSE step's layout at batch 65,536
    (OP_WIDTHS, OP_COLS * OP_VALS, np.float32, "contiguous", False),  # the operator benchmark's
    ([150] * 100, 100_003, np.float32, "random", False),       # ids in any order over a table past the budget
    ([3_000] * 5, 65_536, np.float32, "contiguous", False),    # a 60 KB table
    ([600, 900, 5, 3_000], 20_000, np.float32, "contiguous", False),  # blocks on both paths
    ([17] * 20, 3, np.float32, "random", False),               # N < 4
    ([17] * 20, 270_341, np.float32, "contiguous", False),     # N % 4 = 1
    ([17] * 20, 5_003, np.float32, "contiguous", True),        # values at an unaligned address
    (OP_WIDTHS, 300_007, np.float32, "random", True),
    ([17] * 20, 20_000, np.float32, "out_of_range", False),    # column ids in [-(C+3), C+3)
    ([3_000] * 5, 20_000, np.float32, "out_of_range", False),
    ([0, 5, 0, 17, 0], 10_000, np.float32, "out_of_range", False),  # width-0 columns
]


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


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call in us: the host clock around ``iters``
    calls with no synchronise between them (what a wrapper costs its
    caller when the card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def flash_excess(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """The largest |got - want| over what FLASH_TOL allows it: at most 1 passes."""
    rtol, atol = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    allow = (rtol * want.abs() + atol * want.abs().max()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() / allow).max())


GRAD_NAMES = ("dq", "dk", "dv")


def flash_bwd_readings(got, want, dtype) -> dict:
    """dQ, dK, dV against the plain backward: each one's largest magnitude,
    largest error and error over FLASH_TOL, what a zero gradient reads, and
    what the dK of the other kv head reads (None with one kv head)."""
    out = {}
    for n, g, w in zip(GRAD_NAMES, got, want):
        out[f"{n}_max_abs"] = float(w.float().abs().max())
        out[f"{n}_max_abs_err"] = float((g.float() - w.float()).abs().max())
        out[f"{n}_err_over_tol"] = flash_excess(g, w, dtype)
        out[f"{n}_zero_err_over_tol"] = flash_excess(torch.zeros_like(w), w, dtype)
    dk = want[1]
    out["dk_other_kv_head_err_over_tol"] = flash_excess(dk.flip(2), dk, dtype) if dk.shape[2] > 1 else None
    return out


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


def _demangle(names: list[str]) -> list[str]:
    """C++ names demangled by c++filt where it is installed, else as they are."""
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            return [n.replace("(anonymous namespace)::", "") for n in out]
    return names


def sass_hgmma(lib_path: Path, nvcc: str) -> dict:
    """The number of HGMMA (wgmma) instructions in each kernel's SASS, from
    ``cuobjdump -sass`` of the built library, by the toolkit that built it."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            cur = m.group(1)
            counts.setdefault(cur, 0)
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def ptxas_report(log_path: Path) -> list[dict]:
    """Registers, spills and static shared memory of each kernel, from the
    ptxas report the build keeps beside the library; names demangled by
    c++filt where it is installed."""
    entries, cur = [], None
    for line in log_path.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            cur = {"function": m.group(1)}
            entries.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    for e, n in zip(entries, _demangle([e["function"] for e in entries])):
        e["function"] = n
    return entries


def bucket_case(rng, widths, n: int, vdt=np.float32, layout: str = "random"):
    """Sorted boundaries per column, column ids, and values: random, on
    every boundary, one float step either side of it, ±inf, NaN, ±0.0 and
    subnormals (the bucketize kernel compares those as zero, as XLA does).
    Column ids random in [0, C) ("random"), each column's values one
    contiguous run as the engine lays them out ("contiguous"), or random in
    [-(C+3), C+3) ("out_of_range")."""
    bnds = np.concatenate([np.sort(rng.normal(size=w)).astype(np.float32) for w in widths])
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    on = bnds[rng.integers(0, bnds.size, n // 4)]
    m = on.size
    vals[:m] = on
    vals[m:2 * m] = np.nextafter(on, np.float32(np.inf))
    vals[2 * m:3 * m] = np.nextafter(on, np.float32(-np.inf))
    special = [np.inf, -np.inf, np.nan, -0.0, 0.0, 1e-45, -1e-45, 1e-39, -3e-39]
    vals[n - min(n, 9):] = special[:min(n, 9)]
    c = len(widths)
    if layout == "contiguous":
        cids = np.repeat(np.arange(c, dtype=np.int32), -(-n // c))[:n]
    elif layout == "out_of_range":
        cids = rng.integers(-(c + 3), c + 3, n).astype(np.int32)
    else:
        cids = rng.integers(0, c, n).astype(np.int32)
    return vals.astype(vdt), cids, bnds, offs


def bound_ms(n_bytes: float, n_ops: float = 0.0, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def save_inputs(where: Path | None, kname: str, path: str, args: list) -> None:
    """The row gather's, the untile's or the bucketize's recorded inputs on
    one path, as ``scripts/gather_untile_ab.py`` and
    ``scripts/bucketize_ab.py`` read them (the ids or splits, the table's or
    g's values being random there; the bucketize's four tensors)."""
    if where is None or kname not in ("gather_rows", "sequence_untile", "fused_bucketize"):
        return
    where.mkdir(parents=True, exist_ok=True)
    if kname == "fused_bucketize":
        obj = [t.cpu() for t in args]
    elif kname == "gather_rows":
        table, ids = args
        obj = {"R": table.shape[0], "D": table.shape[1], "ids": ids.cpu()}
    else:
        g, splits, n = args
        obj = {"S": g.shape[0], "k": g.shape[1], "D": g.shape[2], "N": n, "splits": splits.cpu()}
    torch.save(obj, where / f"{kname}.{path}.pt")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save-inputs", type=Path, default=None, metavar="DIR",
                    help="also save the row gather's, the untile's and the bucketize's path inputs here "
                         "(for scripts/gather_untile_ab.py and scripts/bucketize_ab.py)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import dlrm_mlperf, qwen2_5_3b
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.embedding_engine import EngineConfig
    from repro_torch.core.feature_engine import FeatureEngine
    from repro_torch.io.ragged import Ragged
    from repro_torch.core import idmap as idmap_lib
    from repro_torch.examples import train_mse as mse
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.kernels.fused_transform import fused_transform as ft_launch, ops as ft_ops, ref as ft_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.kernels.sequence_tile import ops as st_ops, ref as st_ref
    from repro_torch.launch import recsys_cell
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.common import local_view

    def counts() -> dict:
        return {"fused_gather.gather_rows": fg_ops.LAUNCHES,
                "fused_gather.gather_rows_slab": fg_ops.SLAB_LAUNCHES,
                "segment_reduce.segment_sum": sr_ops.LAUNCHES,
                "segment_reduce.segment_expand_csr": sr_ops.LAUNCHES_BWD,
                "segment_reduce.segment_sum_csr_group": sr_ops.GROUP_LAUNCHES,
                "segment_reduce.segment_expand_csr_group": sr_ops.GROUP_LAUNCHES_BWD,
                "fused_scatter.scatter_add_rows": fs_ops.LAUNCHES_ADD,
                "fused_scatter.scatter_set_rows": fs_ops.LAUNCHES_SET,
                "flash_attention.flash_fwd": fa_ops.LAUNCHES,
                "flash_attention.flash_bwd": fa_ops.BWD_LAUNCHES,
                "fused_transform.fused_bucketize": ft_ops.LAUNCHES,
                "sequence_tile.sequence_tile": st_ops.LAUNCHES,
                "sequence_tile.sequence_untile": st_ops.BWD_LAUNCHES}

    def reset_counts() -> None:
        fg_ops.LAUNCHES = fg_ops.SLAB_LAUNCHES = sr_ops.LAUNCHES = sr_ops.LAUNCHES_BWD = 0
        sr_ops.GROUP_LAUNCHES = sr_ops.GROUP_LAUNCHES_BWD = 0
        fs_ops.LAUNCHES_ADD = fs_ops.LAUNCHES_SET = fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
        ft_ops.LAUNCHES = st_ops.LAUNCHES = st_ops.BWD_LAUNCHES = 0

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
    ptxas = ptxas_report(lib_path.parent / "ptxas.log")
    check(len(ptxas) > 0 and all("registers" in e for e in ptxas), "no ptxas report beside the library")
    hgmma = sass_hgmma(lib_path, kernels._nvcc())
    # the bf16 flash kernels run on the tensor cores (HGMMA in their SASS)
    # and keep everything in registers at hd 128
    tc_kernels = {"flash_attention.flash_fwd": ("flash_fwd_tc_kernel",),
                  "flash_attention.flash_bwd": ("flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")}
    flash_build = {}
    for entry, parts in tc_kernels.items():
        flash_build[entry] = {
            "hgmma": {f: n for f, n in hgmma.items() if any(x in f for x in parts)},
            "ptxas": [{k: e.get(k) for k in ("function", "registers", "spill_store_bytes", "spill_load_bytes")}
                      for e in ptxas if entry.split(".")[1] in e["function"]]}  # fp32 kernels too
        tc = flash_build[entry]["hgmma"]
        check(len(tc) == 2 * len(parts) and all(n > 0 for n in tc.values()), f"{entry}: HGMMA counts {tc}")
        spills = [e for e in flash_build[entry]["ptxas"] if any(x in e["function"] for x in parts)
                  and ("<128>" in e["function"] or "ILi128E" in e["function"])
                  and (e.get("spill_store_bytes") or e.get("spill_load_bytes"))]
        check(not spills, f"{entry}: the tensor-core kernels spill at hd 128: {spills}")
    emit({"phase": "device", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s, "library": str(lib_path.relative_to(ROOT)), "ptxas": ptxas,
          "hgmma_per_kernel": {f: n for f, n in hgmma.items() if n}})

    # ------------------------------------------------- 2 kernels vs plain, random
    rng = np.random.default_rng(SEED)
    cases = []

    def unaligned(x: torch.Tensor) -> torch.Tensor:
        """The same values at an address 4 bytes past a 16-byte boundary."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    for R, D, K, idt, misalign in GATHER_CASES:
        table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32)).to(dev)
        table = unaligned(table) if misalign else table
        ids = torch.from_numpy(rng.integers(-2, R + 2, size=K)).to(idt).to(dev)
        before = fg_ops.LAUNCHES
        got, want = fg_ops.gather_rows(table, ids), fg_ref.gather_rows(table, ids)
        torch.cuda.synchronize()
        cases.append({"kernel": "gather_rows", "R": R, "D": D, "K": K, "ids": str(idt),
                      "unaligned": misalign, "bit_equal": bool(torch.equal(got, want))})
        check(fg_ops.LAUNCHES == before + 1, f"gather_rows did not launch at {cases[-1]}")
        check(torch.equal(got, want), f"gather_rows disagrees at {cases[-1]}")
    for cname, R, D, K, lo, hi, rows_blk, slab, idt, misalign in SLAB_CASES:
        table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32)).to(dev)
        table = unaligned(table) if misalign else table
        ids = np.sort(rng.integers(lo, hi, size=K))
        if cname == "one_pad":
            ids[0] = -1
        ids = torch.from_numpy(ids).to(idt).to(dev)
        before = fg_ops.SLAB_LAUNCHES
        got = fg_ops.gather_rows(table, ids, mode="slab", rows_blk=rows_blk, slab=slab)
        torch.cuda.synchronize()
        want = fg_ref.gather_rows_slab(table.cpu(), ids.cpu(), rows_blk, slab)
        cases.append({"kernel": "gather_rows_slab", "case": cname, "R": R, "D": D, "K": K, "rows_blk": rows_blk,
                      "slab": slab, "ids": str(idt), "unaligned": misalign,
                      "zero_rows": int((~want.any(dim=1)).sum()), "bit_equal": bool(torch.equal(got.cpu(), want))})
        check(fg_ops.SLAB_LAUNCHES == before + 1, f"gather_rows_slab did not launch at {cases[-1]}")
        check(torch.equal(got.cpu(), want), f"gather_rows_slab disagrees at {cases[-1]}")
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
    for R, D, K, idt, misalign, with_valid, share in SCATTER_CASES:
        for op in ("add", "set"):
            stacked = torch.from_numpy(rng.normal(size=(2, R, D)).astype(np.float32)).to(dev)
            ids = torch.from_numpy(rng.permutation(R + 4)[:K] - 2).to(idt).to(dev)  # unique, some out of range
            valid = torch.from_numpy(rng.random(K) < share).to(dev)
            ids = torch.where(ids == 0, -1, ids)  # no live slot on row 0 ...
            if with_valid:  # ... only invalid ones, which must leave it as it is
                ids[: K // 10] = torch.where(valid[: K // 10], ids[: K // 10], 0)
            rows = torch.from_numpy(rng.normal(size=(K, D)).astype(np.float32)).to(dev)
            if misalign:  # the rows and the table view off a 16-byte boundary: the scalar path
                rows = unaligned(rows)
                stacked = unaligned(stacked)
            v = valid if with_valid else None
            want = stacked[1].clone()
            (fs_ref.scatter_add_rows if op == "add" else fs_ref.scatter_set_rows)(want, ids, rows, v)
            before = (fs_ops.LAUNCHES_ADD, fs_ops.LAUNCHES_SET)
            other = stacked[0].clone()
            (fs_ops.scatter_add_rows if op == "add" else fs_ops.scatter_set_rows)(stacked[1], ids, rows, v)
            torch.cuda.synchronize()
            launched = (fs_ops.LAUNCHES_ADD, fs_ops.LAUNCHES_SET) != before
            cases.append({"kernel": f"scatter_{op}_rows", "R": R, "D": D, "K": K, "ids": str(idt),
                          "valid": with_valid, "valid_share": share, "unaligned": misalign, "launched": launched,
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
    for n_feat, D, sdt, n_rows in GROUP_CASES:
        # a group's rows: each feature's slice (empty rows, a padding tail),
        # the second feature's rows all empty, a feature pooled otherwise
        # before the second and the last, rows past the last slice
        offsets, splits, sizes, ofs = [], [], [], 0
        for f in range(n_feat):
            ofs += 37 if f in (1, n_feat - 1) and n_feat > 1 else 0
            lengths = rng.integers(0, 4, size=n_rows)
            lengths[::5] = 0
            if f == 1:
                lengths[:] = 0
            budget = int(1.5 * n_rows)
            splits.append(torch.from_numpy(np.minimum(np.concatenate([[0], np.cumsum(lengths)]),
                                                      budget - 3)).to(sdt).to(dev))
            offsets.append(ofs)
            sizes.append(budget)
            ofs += budget
        vals = torch.from_numpy(rng.normal(size=(ofs + 11, D)).astype(np.float32)).to(dev)
        n_launch = -(-n_feat // 64)
        before = (sr_ops.GROUP_LAUNCHES, sr_ops.GROUP_LAUNCHES_BWD)
        got = sr_ops.segment_sum_csr_group(vals, splits, offsets, sizes)
        torch.cuda.synchronize()
        fwd_launched = sr_ops.GROUP_LAUNCHES - before[0]
        want = sr_ref.segment_sum_csr_group(vals, splits, offsets, sizes)
        per_feature = [sr_ops.segment_sum_csr(vals[o:o + n], sp) for sp, o, n in zip(splits, offsets, sizes)]
        err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, want))
        close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, per_feature))
        grads = [torch.from_numpy(rng.normal(size=(n_rows, 3, D)).astype(np.float32)).to(dev)[:, 1] if f == 0
                 else None if f == n_feat - 1 and n_feat > 1
                 else torch.from_numpy(rng.normal(size=(n_rows, D)).astype(np.float32)).to(dev)
                 for f in range(n_feat)]
        got_g = sr_ops.segment_expand_csr_group(grads, splits, offsets, sizes, vals.shape[0], D)
        torch.cuda.synchronize()
        bwd_launched = sr_ops.GROUP_LAUNCHES_BWD - before[1]
        want_g = sr_ref.segment_expand_csr_group(grads, splits, offsets, sizes, vals.shape[0], D)
        cases.append({"kernel": "segment_sum_csr_group+segment_expand_csr_group", "features": n_feat, "D": D,
                      "N": vals.shape[0], "rows_per_feature": n_rows, "splits": str(sdt),
                      "launches": [fwd_launched, bwd_launched], "max_abs_err": err,
                      "bit_equal_to_per_feature_kernel": same, "grad_bit_equal": bool(torch.equal(got_g, want_g))})
        check(fwd_launched == n_launch and bwd_launched == n_launch, f"grouped launches at {cases[-1]}")
        check(close and same and torch.equal(got_g, want_g), f"grouped segment sum disagrees at {cases[-1]}")
    tc_before = fa_ops.tensor_core_launches()
    n_bf16 = {"fwd": 0, "bwd": 0}
    for B, T, H, Hk, hd, dt, causal, layout in [(*c, "contiguous") for c in FLASH_CASES] + STRIDED_CASES + [
            (1, 256, 4, 2, 128, torch.bfloat16, True, "q unaligned")]:
        if layout == "fused qkv view":  # q, k, v as head slices of one projection
            fused = torch.from_numpy(rng.normal(size=(B, T, H + 2 * Hk, hd)).astype(np.float32)).to(dt).to(dev)
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
        n_bf16["fwd"] += dt == torch.bfloat16
        check(o.dtype == dt and excess <= 1.0 and torch.allclose(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL),
              f"flash_fwd disagrees at {cases[-1]}")
    for B, T, H, Hk, hd, dt, causal, layout in [(*c, "contiguous") for c in FLASH_CASES] + STRIDED_CASES:
        if layout == "fused qkv view":  # q, k, v as head slices of one projection, dO (B, H, T, hd) transposed
            fused = torch.from_numpy(rng.normal(size=(B, T, H + 2 * Hk, hd)).astype(np.float32)).to(dt).to(dev)
            q, k, v = fused[:, :, :H], fused[:, :, H:H + Hk], fused[:, :, H + Hk:]
            do = torch.from_numpy(rng.normal(size=(B, H, T, hd)).astype(np.float32)).to(dt).to(dev).transpose(1, 2)
        else:
            q, k, v = (torch.from_numpy(rng.normal(size=(B, T, n, hd)).astype(np.float32)).to(dt).to(dev)
                       for n in (H, Hk, Hk))
            do = torch.from_numpy(rng.normal(size=(B, T, H, hd)).astype(np.float32)).to(dt).to(dev)
        o, lse = fa_ops.flash_fwd(q, k, v, causal)
        before = fa_ops.BWD_LAUNCHES
        got = fa_ops.flash_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        want = fa_ref.flash_bwd(q, k, v, o, lse, do, causal)
        case = {"kernel": "flash_bwd", "B": B, "T": T, "H": H, "Hk": Hk, "hd": hd, "dtype": str(dt),
                "causal": causal, "layout": layout}
        case.update(flash_bwd_readings(got, want, dt))
        cases.append(case)
        check(fa_ops.BWD_LAUNCHES == before + 1, f"flash_bwd did not launch at {case}")
        n_bf16["bwd"] += dt == torch.bfloat16
        check(all(g.dtype == dt for g in got) and max(case[f"{n}_err_over_tol"] for n in GRAD_NAMES) <= 1.0,
              f"flash_bwd disagrees at {case}")
        other = case["dk_other_kv_head_err_over_tol"]
        check(min(case[f"{n}_zero_err_over_tol"] for n in GRAD_NAMES) > 1.0 and (other is None or other > 1.0),
              f"the flash_bwd check cannot tell a wrong gradient at {case}")
    # every bf16 case went through the tensor-core kernels, and no fp32 one
    tc_after = fa_ops.tensor_core_launches()
    tc_cases = {"bf16_fwd_launches": n_bf16["fwd"], "bf16_bwd_launches": n_bf16["bwd"],
                "tensor_core_fwd_launches": tc_after[0] - tc_before[0],
                "tensor_core_bwd_launches": tc_after[1] - tc_before[1]}
    check(tc_cases["tensor_core_fwd_launches"] == n_bf16["fwd"] + n_bf16["bwd"]
          and tc_cases["tensor_core_bwd_launches"] == n_bf16["bwd"],
          f"bf16 flash cases and tensor-core launches differ: {tc_cases}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bucket_path_launches = {p: 0 for p in ft_launch.PATHS}  # this phase's, counted on the C side
    for widths, n, vdt, layout, misalign in BUCKET_CASES:
        vals, cids, bnds, offs = bucket_case(rng, widths, n, vdt, layout)
        paths = ft_launch.launch_paths(cids, offs, sms)
        args = [torch.from_numpy(x).to(dev) for x in (vals, cids, bnds, offs)]
        args[0] = unaligned(args[0]) if misalign else args[0]
        before, ran = ft_ops.LAUNCHES, ft_launch.path_launches()
        got, again = ft_ops.fused_bucketize(*args), ft_ops.fused_bucketize(*args)
        torch.cuda.synchronize()
        after = ft_launch.path_launches()
        ran = {p: after[i] - ran[i] for i, p in enumerate(ft_launch.PATHS)}
        for p, k in ran.items():
            bucket_path_launches[p] += k
        launched = ft_ops.LAUNCHES == before + 2
        want = ft_ref.fused_bucketize(*args)
        cases.append({"kernel": "fused_bucketize", "columns": len(widths), "width_min": int(min(widths)),
                      "width_max": int(max(widths)), "boundaries": int(sum(widths)), "N": n, "values": str(vdt.__name__),
                      "column_ids": layout, "unaligned": misalign, "launched": launched, "path_launches": ran,
                      "expected_paths": sorted(paths), "equal": bool(torch.equal(got, want)),
                      "two_launches_bit_equal": bool(torch.equal(got, again))})
        check(launched and got.dtype == torch.int64 and torch.equal(got, want) and torch.equal(got, again)
              and ran == {p: 2 * (p in paths) for p in ft_launch.PATHS}, f"fused_bucketize disagrees at {cases[-1]}")
        del args, got, again, want
    check(all(bucket_path_launches.values()), f"a bucketize path never ran in phase 2: {bucket_path_launches}")
    for D in (8, 13, 50, 128):
        for k in (1, 8, 50):
            for sdt in (torch.int32, torch.int64):
                lengths = rng.integers(0, 12, size=97)
                lengths[::5] = 0   # empty rows
                lengths[1] = 60    # a row longer than any k
                budget = int(lengths.sum()) + 9  # a padding tail
                sp = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])).to(sdt).to(dev)
                vals = torch.from_numpy(rng.normal(size=(budget, D)).astype(np.float32)).to(dev)
                g = torch.from_numpy(rng.normal(size=(97, k, D)).astype(np.float32)).to(dev)
                before = (st_ops.LAUNCHES, st_ops.BWD_LAUNCHES)
                got, got_g = st_ops.sequence_tile(vals, sp, k), st_ops.sequence_untile(g, sp, budget)
                torch.cuda.synchronize()
                launched = (st_ops.LAUNCHES, st_ops.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
                eq = torch.equal(got, st_ref.sequence_tile(vals, sp, k))
                eq_g = torch.equal(got_g, st_ref.sequence_untile(g, sp, budget))
                cases.append({"kernel": "sequence_tile+untile", "n_rows": 97, "N": budget, "D": D, "k": k,
                              "splits": str(sdt), "launched": launched, "tile_equal": eq, "untile_equal": eq_g})
                check(launched and eq and eq_g, f"sequence tile or untile disagrees at {cases[-1]}")
    for D, k, head, sdt, misalign in UNTILE_CASES:
        n_rows = 70 if k else 0
        k = k or 4
        lengths = rng.integers(0, 2 * k + 2, size=n_rows)
        if n_rows:
            lengths[::5] = 0  # empty rows
            lengths[1:4] = k - 1, k, 10 * k
        sp = torch.from_numpy(head + np.concatenate([[0], np.cumsum(lengths)])).to(sdt).to(dev)
        budget = int(sp[-1]) + 9  # a padding tail
        g = torch.from_numpy(rng.normal(size=(n_rows, k, D)).astype(np.float32)).to(dev)
        g = unaligned(g) if misalign else g
        before = st_ops.BWD_LAUNCHES
        got_g = st_ops.sequence_untile(g, sp, budget)
        torch.cuda.synchronize()
        eq_g = torch.equal(got_g, st_ref.sequence_untile(g, sp, budget))
        cases.append({"kernel": "sequence_untile", "n_rows": n_rows, "N": budget, "D": D, "k": k,
                      "first_split": head, "splits": str(sdt), "unaligned": misalign,
                      "launched": st_ops.BWD_LAUNCHES == before + 1, "untile_equal": eq_g})
        check(cases[-1]["launched"] and eq_g, f"sequence_untile disagrees at {cases[-1]}")
    emit({"phase": "kernels_vs_plain", "cases": cases, "flash_tensor_core_path": tc_cases,
          "bucketize_path_launches": bucket_path_launches, "tolerance": {
        "gather_rows": "bit-equal", "gather_rows_slab": "bit-equal", "segment_sum": "rtol=atol=1e-5 (summation order)",
        "segment_sum_csr": "rtol=atol=1e-5 (summation order)",
        "scatter_add_rows": "bit-equal", "scatter_set_rows": "bit-equal",
        "segment_expand_csr": "bit-equal (a copy)",
        "segment_sum_csr_group": "rtol=atol=1e-5 (summation order), bit-equal to the per-feature kernel",
        "segment_expand_csr_group": "bit-equal (a copy)",
        "flash_fwd": "O: |got - want| <= rtol |want| + atol max|want| (o_err_over_tol <= 1), (rtol, atol) "
                     f"{FLASH_TOL[torch.float32]} fp32, {FLASH_TOL[torch.bfloat16]} bf16 (one rounding); "
                     f"LSE rtol=atol {LSE_TOL}; an unaligned q is refused",
        "flash_bwd": "dQ, dK, dV each as O of flash_fwd (err_over_tol <= 1); a zero gradient and the dK "
                     "of the other kv head (Hk > 1) read above 1; every bf16 launch on the tensor-core kernels",
        "fused_bucketize": "equal (torch.equal), two launches bit-equal, each on the paths its plan gives",
        "sequence_tile": "equal (torch.equal)",
        "sequence_untile": "equal (torch.equal)"}})

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

    # ----------------------------------------- 3 smoke LM train, card vs CPU
    lshape = ShapeCell("train_4k", "train", {"seq_len": 256, "global_batch": 2})
    lsmoke = {d: build_cell("qwen2.5-3b", "train_4k", smoke=True, shape_override=lshape, device=d)
              for d in ("cpu", "cuda")}
    lcfg = lsmoke["cpu"].arch.model
    lkey = f"dim{lcfg.d_model}"
    states = {d: cell.init_state() for d, cell in lsmoke.items()}  # fresh engines: every token inserted
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    losses = []
    for s in seeds:
        before = (fa_ops.LAUNCHES, fa_ops.BWD_LAUNCHES)
        outs = {}
        for d, cell in lsmoke.items():
            states[d], outs[d] = cell.step_fn(states[d], cell.make_batch(s))
        check((fa_ops.LAUNCHES - before[0], fa_ops.BWD_LAUNCHES - before[1]) == (2 * lcfg.n_layers, lcfg.n_layers),
              "smoke LM train: two flash forward launches (layer, recompute) and one backward per layer")
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        check(met["cuda"] == met["cpu"], f"smoke LM train metrics differ: {met}")
        lc, lg = float(outs["cpu"]["loss"]), float(outs["cuda"]["loss"])
        check(np.isfinite(lg) and abs(lg - lc) <= MIXED_TOL["atol"] + MIXED_TOL["rtol"] * abs(lc),
              f"smoke LM train loss {lg} on the card, {lc} on the CPU")
        losses.append({"cpu": lc, "cuda": lg})
    for f in idmap_lib.TENSOR_FIELDS:
        got, want = (getattr(states[d]["sparse"][lkey]["idmap"], f).cpu() for d in ("cuda", "cpu"))
        check(torch.equal(got, want), f"smoke LM train IDMap field {f} differs")
    exp = {d: lsmoke[d].engine.export_rows(states[d]["sparse"])[lkey] for d in states}
    for k in ("ids", "last_use"):
        check(np.array_equal(exp["cuda"][k], exp["cpu"][k]), f"smoke LM train export {k} differs")
    diffs = {"emb": float(np.abs(exp["cuda"]["emb"] - exp["cpu"]["emb"]).max())}
    dense = {d: states[d]["dense"].state_dict() for d in states}
    diffs["dense"] = max(float((dense["cuda"][k].cpu() - v).abs().max()) for k, v in dense["cpu"].items())
    check(diffs["emb"] <= TRAIN_PARAM_ATOL and diffs["dense"] <= TRAIN_PARAM_ATOL,
          f"smoke LM train rows or params differ: {diffs}")
    emit({"phase": "smoke_lm_train_card_vs_cpu", "arch": "qwen2.5-3b (smoke)", "seq_len": 256, "batch": 2,
          "steps": len(seeds), "loss": losses, "metrics": met["cuda"], "idmap_equal": True,
          "export_ids_equal": True, "max_abs_diff": diffs,
          "tolerance": {"loss": MIXED_TOL, "emb_and_dense_atol": TRAIN_PARAM_ATOL}})
    del lsmoke, states, outs, exp, dense

    # --------------------------------------------- 3 smoke MSE train, card vs CPU
    mcells = {d: mse.MSECell(d) for d in ("cpu", "cuda")}  # the example's own constants
    states = {d: cell.init_state() for d, cell in mcells.items()}
    states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
    losses, per_step = [], {"fused_transform.fused_bucketize": 1, "sequence_tile.sequence_tile": mse.N_SEQ,
                            "sequence_tile.sequence_untile": mse.N_SEQ,
                            "segment_reduce.segment_sum": 0, "segment_reduce.segment_expand_csr": 0,
                            "segment_reduce.segment_sum_csr_group": 1,  # the dim-8 group's 61 sum features
                            "segment_reduce.segment_expand_csr_group": 1,
                            "fused_gather.gather_rows": 4, "fused_scatter.scatter_add_rows": 3}
    for s in seeds:
        arrays = mse.batch_arrays(mcells["cpu"].specs, mse.BATCH, seed=50_000 + s)
        before = counts()
        outs = {}
        for d, cell in mcells.items():
            states[d], outs[d] = cell.step_fn(states[d], mse.to_batch(arrays, cell.device))
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        check(all(delta[k] == v for k, v in per_step.items()), f"smoke MSE launches per step {delta}")
        met = {d: {k: int(v) for k, v in o.items() if k != "loss"} for d, o in outs.items()}
        check(met["cuda"] == met["cpu"], f"smoke MSE metrics differ: {met}")
        lc, lg = float(outs["cpu"]["loss"]), float(outs["cuda"]["loss"])
        check(np.isfinite(lg) and abs(lg - lc) <= MIXED_TOL["atol"] + MIXED_TOL["rtol"] * abs(lc),
              f"smoke MSE loss {lg} on the card, {lc} on the CPU")
        losses.append({"cpu": lc, "cuda": lg})
    sp = {d: states[d]["sparse"]["dim8"] for d in states}
    for f in idmap_lib.TENSOR_FIELDS:
        check(torch.equal(getattr(sp["cuda"]["idmap"], f).cpu(), getattr(sp["cpu"]["idmap"], f)),
              f"smoke MSE IDMap field {f} differs")
    diffs = {"emb": float((sp["cuda"]["blocks"].emb.cpu() - sp["cpu"]["blocks"].emb).abs().max())}
    check(diffs["emb"] <= MSE_ROW_ATOL, f"smoke MSE rows differ by {diffs['emb']}")
    for k in ("m", "v"):
        got, want = sp["cuda"]["blocks"].slots[k].cpu(), sp["cpu"]["blocks"].slots[k]
        diffs[k] = float((got - want).abs().max())
        check(diffs[k] <= MSE_LATER_MOMENT_FRAC * float(want.abs().max()), f"smoke MSE {k} differs by {diffs[k]}")
    dense = {d: states[d]["dense"].state_dict() for d in states}
    diffs["dense"] = max(float((dense["cuda"][k].cpu() - v).abs().max()) for k, v in dense["cpu"].items())
    check(diffs["dense"] <= TRAIN_PARAM_ATOL, f"smoke MSE dense params differ by {diffs['dense']}")
    emit({"phase": "smoke_mse_train_card_vs_cpu", "model": "examples/train_mse.py", "batch": mse.BATCH,
          "steps": len(seeds), "loss": losses, "metrics": met["cuda"], "idmap_equal": True,
          "launches_per_step": per_step, "max_abs_diff": diffs, "tolerance": {
              "loss": MIXED_TOL, "emb_atol": MSE_ROW_ATOL, "dense_atol": TRAIN_PARAM_ATOL,
              "moments": f"{MSE_LATER_MOMENT_FRAC} of the largest magnitude"}})
    del mcells, states, outs, sp, dense

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
            "segment_sum_csr_group": recorder(sr_ops, "segment_sum_csr_group"),
            "segment_expand_csr_group": recorder(sr_ops, "segment_expand_csr_group"),
            "segment_sum_csr": sr_ops.segment_sum_csr,  # on no path: fed feature 0's slice of the group's
            "segment_expand_csr": sr_ops.segment_expand_csr,  # inputs in phase 5, and driven at its op entry
            "scatter_add_rows": recorder(fs_ops, "scatter_add_rows", whole=True),
            "scatter_set_rows": recorder(fs_ops, "scatter_set_rows", whole=True),
            "flash_attention": recorder(fa_ops, "flash_attention")}

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
    torch.cuda.reset_peak_memory_stats()
    bulk_ms = []  # the first request at this size pays one-time costs; the second is warm
    for i in range(2):
        # the kernels' inputs are recorded on the second request: the grouped
        # segment sum's (the group's 3.5 GB of rows, kept as they are) would
        # otherwise stay allocated through the second and raise its peak
        phase["name"] = "serve_bulk" if i == 1 else None
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
    check(launches["segment_reduce.segment_sum_csr_group"] == n_req  # one dim group: its 26 features at once
          and launches["segment_reduce.segment_sum"] == 0, f"segment_sum launches {launches}")

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
    del ids, eng, batch  # the last request's: device tensors the names would keep
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
    del b, eng
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
    check(all(train_launches[k] > 0 for k in DLRM_TRAIN_KERNELS),
          f"a kernel of the train path never ran: {train_launches}")
    check(train_launches["fused_gather.gather_rows"] == 4 * n_steps
          and train_launches["fused_scatter.scatter_add_rows"] == 3 * n_steps
          and train_launches["segment_reduce.segment_sum_csr_group"] == n_steps  # one dim group
          and train_launches["segment_reduce.segment_expand_csr_group"] == n_steps
          and train_launches["segment_reduce.segment_sum"] == train_launches["segment_reduce.segment_expand_csr"] == 0,
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
    tc0 = fa_ops.tensor_core_launches()
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
        del pout, c
    prefill_launches = counts()
    prefill_tc = fa_ops.tensor_core_launches()[0] - tc0[0]
    prefill_peak = torch.cuda.max_memory_allocated() - held_before
    n_pre = len(pbatches)
    check(prefill_launches["flash_attention.flash_fwd"] == L_lm * n_pre
          and prefill_launches["fused_gather.gather_rows"] == n_pre,
          f"prefill launches {prefill_launches}")
    check(prefill_tc == prefill_launches["flash_attention.flash_fwd"],
          f"prefill: {prefill_tc} tensor-core launches of {prefill_launches['flash_attention.flash_fwd']}")
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
    del o0, lse0, want_o, want_l, wrong_o, q0, k0, v0
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
          "launches": prefill_launches, "flash_fwd_tensor_core_launches": prefill_tc,
          "launches_per_request": {k: v / n_pre for k, v in prefill_launches.items()}})
    emit(profile_requests("prefill", lambda b: pre.step_fn(pstate, b), pbatches[1:2]))
    del pstate, pre, pbatches
    torch.cuda.empty_cache()

    # ------------- 5 kernels on the serve, train and prefill inputs, measured
    # here so that what those paths held is released before the LM train
    # The per-feature segment-sum pair is on no path now (every path pools a
    # dim group at once): it is measured on feature 0's slice of the group's
    # recorded inputs, the shapes it had on the paths, and driven once
    # through its op entry at the train shape, counted (path "csr_op").
    for path in ("serve_p99", "serve_bulk", "train"):
        vals, sps, offs, sizes = recorded[("segment_sum_csr_group", path)][0]
        recorded[("segment_sum_csr", path)] = ([vals[offs[0]:offs[0] + sizes[0]], sps[0]], {})
    grads, sps, offs, sizes, _, _ = recorded[("segment_expand_csr_group", "train")][0]
    recorded[("segment_expand_csr", "train")] = ([grads[0], sps[0], sizes[0]], {})
    leaf = recorded[("segment_sum_csr", "train")][0][0].clone().requires_grad_()
    torch.cuda.synchronize()
    reset_counts()
    torch.autograd.grad(sr_ops.segment_sum_csr(leaf, sps[0]), leaf, grads[0])
    torch.cuda.synchronize()
    csr_launches = counts()
    check(csr_launches["segment_reduce.segment_sum"] == csr_launches["segment_reduce.segment_expand_csr"] == 1
          and sum(csr_launches.values()) == 2, f"segment_sum_csr op launches {csr_launches}")
    del leaf, vals, sps, offs, sizes, grads
    kernels_on_path = [  # (entry, wrapper, source, TPU kernel replaced, plain, paths, library call)
        ("fused_gather.gather_rows", "gather_rows", "fused_gather.cu",
         "src/repro/kernels/fused_gather/fused_gather.py:34", fg_ref.gather_rows,
         ("serve_p99", "serve_bulk", "train", "prefill"), "torch.index_select"),
        ("segment_reduce.segment_sum_csr_group", "segment_sum_csr_group", "segment_reduce.cu",
         "src/repro/kernels/segment_reduce/segment_reduce.py:87", sr_ref.segment_sum_csr_group,
         ("train", "serve_p99", "serve_bulk"), "zeros.index_add_ over the group's rows (segment ids prebuilt)"),
        ("segment_reduce.segment_expand_csr_group", "segment_expand_csr_group", "segment_reduce.cu",
         "src/repro/kernels/segment_reduce/ops.py:77", sr_ref.segment_expand_csr_group,
         ("train",), "torch.index_select of the gradients (concatenated, a zero row appended, prebuilt)"),
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
            save_inputs(opts.save_inputs, kname, path, args)
            at[path] = _measure(kname, real[kname], plain, args, kw, 200 if path == "serve_p99" else 5, dev)
            del args
            torch.cuda.empty_cache()
        main_path = at[paths[0]]
        by_path = {"serve": launches[full], "train": train_launches[full], "prefill": prefill_launches[full],
                   "csr_op": csr_launches[full]}
        entries.append({
            "name": full, "route": "cuda", "source": f"src/repro_torch/csrc/{src_file}",
            "replaces": replaces, "ok": True, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "main_path": "csr_op" if kname in ("segment_sum_csr", "segment_expand_csr")
            else paths[0], "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "max_err": max(a["max_abs_err"] for a in at.values()),
            "ms": main_path["ms"], "kernel_ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"],
            "kernel_device_ms": main_path["kernel_device_ms"], "host_us": main_path["host_us"],
            "library_ms": main_path["library_ms"], "library_call": lib_call, "at": at})
        if kname in ("segment_sum_csr", "segment_expand_csr"):
            entries[-1]["main_path_note"] = ("on no path since the dim group pools at once: driven at its op entry; "
                                             "timed on feature 0's slice of the group's recorded inputs")
    flash_at = {"prefill": _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref,
                                          *recorded.pop(("flash_attention", "prefill"))[0])}
    check(not recorded, f"recorded inputs left unmeasured: {list(recorded)}")
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4 full-size MSE train
    torch.cuda.synchronize()
    mse_held = torch.cuda.memory_allocated()  # what earlier phases still hold
    mcfg_full = EngineConfig(n_devices=1, rows_per_shard=MSE_ROWS, map_capacity_per_shard=MSE_MAP,
                             u_budget=MSE_BUDGET, per_dest_cap=MSE_BUDGET, recv_budget=MSE_BUDGET)
    mcell = mse.MSECell(dev, batch=MSE_BATCH, engine_cfg=mcfg_full)
    n_m = N_TRAIN_WARMUP + N_TRAIN_STEPS
    t0 = time.perf_counter()
    mbatches = [mse.to_batch(mse.batch_arrays(mcell.specs, MSE_BATCH, seed=60_000 + s), dev)
                for s in range(n_m + 3 + 1)]  # then three profiled, one repeated
    torch.cuda.synchronize()
    mbatch_s = time.perf_counter() - t0
    # the distinct engine ids of each batch, and of all batches up to it
    # (the rows the engine must hold after that step)
    m_uniq, m_expect, mseen = [], [], torch.empty(0, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for b in mbatches[:n_m]:
            eng = mcell.engine.engine_ids(mcell.fe.apply(b)[0])["dim8"]
            u = torch.unique(eng[eng != -1])
            mseen = torch.unique(torch.cat([mseen, u]))
            m_uniq.append(u.numel())
            m_expect.append(mseen.numel())
    m_ids_per_step = int(eng.numel())
    del eng, u, mseen
    mstate = mcell.init_state()  # dense from a seeded generator, an empty engine
    mstate_bytes = sum(t.numel() * t.element_size() for t in _tensors(mstate["sparse"]))
    torch.cuda.synchronize()
    mbase = torch.cuda.memory_allocated()
    mse_recorded = (("gather_rows", fg_ops, False),  # the step's first: the forward fetch (D 8)
                    ("fused_bucketize", ft_ops, False), ("sequence_tile", st_ops, False),
                    ("sequence_untile", st_ops, False), ("segment_sum_csr_group", sr_ops, False),
                    ("segment_expand_csr_group", sr_ops, False), ("scatter_add_rows", fs_ops, True),
                    ("scatter_set_rows", fs_ops, True))
    for fn_name, mod, whole in mse_recorded:
        real[fn_name] = recorder(mod, fn_name, whole)
    torch.cuda.reset_peak_memory_stats()
    mse_paths = ft_launch.path_launches()  # synchronises; the C side counts the bucketize's paths
    reset_counts()
    mstep_ms, mlosses, mlive, movf = [], [], [], {}
    for s in range(n_m):
        phase["name"] = "mse_train" if s == N_TRAIN_WARMUP - 1 else None  # the last warm-up step
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        mstate, out = mcell.step_fn(mstate, mbatches[s])
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= N_TRAIN_WARMUP:
            mstep_ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in out.items() if k != "loss"}
        for k, v in met.items():
            movf[k] = max(movf.get(k, 0), v)
        mlosses.append(float(out["loss"]))
        mlive.append(int(mstate["sparse"]["dim8"]["idmap"].n_live()))
        check(all(v == 0 for v in met.values()), f"MSE train overflow at step {s + 1}: {met}")
        check(np.isfinite(mlosses[-1]), f"MSE train loss {mlosses[-1]} at step {s + 1}")
        check(mlive[-1] == m_expect[s], f"MSE step {s + 1}: {mlive[-1]} rows live, {m_expect[s]} ids seen")
        if s == N_TRAIN_WARMUP - 2:  # steps 1-2: before the probe step's recorded copies
            mse_peak = torch.cuda.max_memory_allocated()
    mse_launches = counts()
    mse_paths = {p: n - b for p, n, b in zip(ft_launch.PATHS, ft_launch.path_launches(), mse_paths)}
    # the MSE model's 20 columns of 17 boundaries fit a block: every launch stages the whole table
    check(mse_paths == {"staged": n_m, "cached": 0}, f"MSE bucketize paths {mse_paths}")
    for fn_name, mod, _ in mse_recorded:
        setattr(mod, fn_name, real[fn_name])  # the wrappers record no more
    want_m = {"fused_gather.gather_rows": 4 * n_m, "fused_gather.gather_rows_slab": 0,
              "segment_reduce.segment_sum": 0, "segment_reduce.segment_expand_csr": 0,
              "segment_reduce.segment_sum_csr_group": n_m,  # the dim-8 group's 61 sum features at once
              "segment_reduce.segment_expand_csr_group": n_m, "fused_scatter.scatter_add_rows": 3 * n_m,
              "fused_scatter.scatter_set_rows": 3 * n_m, "flash_attention.flash_fwd": 0,
              "flash_attention.flash_bwd": 0, "fused_transform.fused_bucketize": n_m,
              "sequence_tile.sequence_tile": mse.N_SEQ * n_m, "sequence_tile.sequence_untile": mse.N_SEQ * n_m}
    check(mse_launches == want_m, f"MSE train launches {mse_launches}, expected {want_m}")
    check(all(bool(torch.isfinite(p).all()) for p in mstate["dense"].parameters()), "MSE params not finite")

    def mse_step(b):
        nonlocal mstate
        mstate, _ = mcell.step_fn(mstate, b)

    emit(profile_requests("mse_train", mse_step, mbatches[n_m:n_m + 3]))
    mrepeat = []
    for _ in range(N_REPEAT):  # one batch again and again: the loss must fall
        mstate, out = mcell.step_fn(mstate, mbatches[-1])
        mrepeat.append(float(out["loss"]))
    check(all(np.isfinite(mrepeat)) and mrepeat[-1] < mrepeat[0], f"MSE loss on one repeated batch: {mrepeat}")
    del mstate, mcell, mbatches, out
    torch.cuda.empty_cache()
    # the example's own size (batch 128, its budgets): a step of little device work
    small = mse.MSECell(dev)
    sstate = small.init_state()
    sbatches = [mse.to_batch(mse.batch_arrays(small.specs, mse.BATCH, seed=70_000 + s), dev)
                for s in range(n_m + 3)]
    small_ms = []
    for s in range(n_m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sstate, out = small.step_fn(sstate, sbatches[s])
        torch.cuda.synchronize()
        if s >= N_TRAIN_WARMUP:
            small_ms.append((time.perf_counter() - t0) * 1e3)

    def small_step(b):
        nonlocal sstate
        sstate, _ = small.step_fn(sstate, b)

    small_profile = profile_requests("mse_train_batch_128", small_step, sbatches[n_m:])
    emit(small_profile)
    del small, sstate, sbatches, out
    msm, ssm = np.array(mstep_ms), np.array(small_ms)
    emit({"phase": "full_mse_train", "model": "examples/train_mse.py (its widths)", "batch": MSE_BATCH,
          "widths": {"dim": mse.DIM, "hash": mse.N_HASH, "bucketize": mse.N_BUCKET, "sequences": mse.N_SEQ,
                     "seq_len": mse.SEQ_LEN, "dnn": list(mse.DNN_DIMS)},
          "reduced": {"batch": [mse.BATCH, MSE_BATCH], "budgets": {
              "u_budget": [2048, MSE_BUDGET], "per_dest_cap": [2048, MSE_BUDGET],
              "recv_budget": [2048, MSE_BUDGET], "rows_per_shard": [1 << 14, MSE_ROWS],
              "map_capacity_per_shard": [1 << 15, MSE_MAP]}},
          "ids_per_step": m_ids_per_step, "unique_ids_per_step": m_uniq, "batch_build_s": mbatch_s,
          "warmup": N_TRAIN_WARMUP, "steps": N_TRAIN_STEPS,
          "step_ms_p50": float(np.percentile(msm, 50)), "step_ms_p99": float(np.percentile(msm, 99)),
          "step_ms_mean": float(msm.mean()), "step_ms": mstep_ms,
          "samples_per_s": MSE_BATCH / (float(np.percentile(msm, 50)) / 1e3),
          "loss": mlosses, "overflow_max": movf, "dev_rows_live": mlive, "distinct_ids_seen": m_expect,
          "loss_on_one_repeated_batch": mrepeat, "state_bytes": mstate_bytes,
          "allocated_before_bytes": mbase, "held_from_earlier_phases_bytes": mse_held,
          "max_memory_allocated_bytes_steps_1_2": mse_peak, "step_transient_bytes": mse_peak - mbase,
          "launches": mse_launches, "launches_per_step": {k: v / n_m for k, v in mse_launches.items()},
          "example_size": {"batch": mse.BATCH, "steps": N_TRAIN_STEPS,
                           "step_ms_p50_host_clock": float(np.percentile(ssm, 50)),
                           "step_ms_p99_host_clock": float(np.percentile(ssm, 99)), "step_ms": small_ms}})

    # ------------------------------------------ 5 the MSE kernels, measured
    op_r = np.random.default_rng(SEED + 1)  # the operator benchmark's shape: contiguous columns
    op_w = op_r.integers(8, 64, OP_COLS)
    op_b = np.concatenate([np.sort(op_r.normal(size=w)) for w in op_w]).astype(np.float32)
    op_args = [torch.from_numpy(x).to(dev) for x in (
        op_r.normal(size=OP_COLS * OP_VALS).astype(np.float32),
        np.repeat(np.arange(OP_COLS, dtype=np.int32), OP_VALS), op_b,
        np.concatenate([[0], np.cumsum(op_w)]).astype(np.int32))]
    op_random = [op_args[0], op_args[1][torch.from_numpy(np.random.default_rng(SEED + 2).permutation(
        OP_COLS * OP_VALS)).to(dev)], *op_args[2:]]  # the same values, column ids in any order
    mse_kernels = [  # (entry, wrapper, plain, library call, at)
        ("fused_transform.fused_bucketize", "fused_bucketize", ft_ref.fused_bucketize,
         "torch.searchsorted(bounds padded with +inf to (C, max width)[cids], values[:, None], right=True), "
         "with the gather; library_loop_ms: torch.bucketize per column (contiguous columns)",
         {"mse_train": recorded.pop(("fused_bucketize", "mse_train"))[0], "operator_table1": op_args,
          "operator_random_ids": op_random}),
        ("sequence_tile.sequence_tile", "sequence_tile", st_ref.sequence_tile,
         "torch.index_select at the clamped indices, times the mask",
         {"mse_train": recorded.pop(("sequence_tile", "mse_train"))[0]}),
        ("sequence_tile.sequence_untile", "sequence_untile", st_ref.sequence_untile,
         "torch.index_select of g (a zero row appended) at each value position's slot",
         {"mse_train": recorded.pop(("sequence_untile", "mse_train"))[0]}),
    ]
    by_name = {e["name"]: e for e in entries}
    # the gather, the grouped pair at the MSE group (61 sum features, D 8)
    # and the scatter at D 8 (SparseAdam's adds over K = R = MSE_BUDGET slots)
    for full, kname, plain in (
            ("fused_gather.gather_rows", "gather_rows", fg_ref.gather_rows),
            ("segment_reduce.segment_sum_csr_group", "segment_sum_csr_group", sr_ref.segment_sum_csr_group),
            ("segment_reduce.segment_expand_csr_group", "segment_expand_csr_group", sr_ref.segment_expand_csr_group),
            ("fused_scatter.scatter_add_rows", "scatter_add_rows", fs_ref.scatter_add_rows),
            ("fused_scatter.scatter_set_rows", "scatter_set_rows", fs_ref.scatter_set_rows)):
        args, kw = recorded.pop((kname, "mse_train"))
        save_inputs(opts.save_inputs, kname, "mse_train", args)
        _add_path(by_name[full], "mse_train", _measure(kname, real[kname], plain, args, kw, 20, dev))
        del args
        torch.cuda.empty_cache()
    for e in entries:  # the earlier kernels' launches on the MSE path
        e["launches_by_path"]["mse_train"] = mse_launches[e["name"]]
    for full, kname, plain, lib_call, inputs in mse_kernels:
        for path, args in inputs.items():
            save_inputs(opts.save_inputs, kname, path, args)
        at = {path: _measure_mse_kernel(kname, real[kname], plain, args) for path, args in inputs.items()}
        main_at = at["mse_train"]
        by_path = {"serve": launches[full], "train": train_launches[full], "prefill": prefill_launches[full],
                   "csr_op": csr_launches[full], "mse_train": mse_launches[full]}
        entries.append({
            "name": full, "route": "cuda", "source": f"src/repro_torch/csrc/{full.split('.')[0]}.cu",
            "replaces": ("src/repro/kernels/fused_transform/fused_transform.py:47" if kname == "fused_bucketize"
                         else "src/repro/kernels/sequence_tile/sequence_tile.py:33"), "ok": True,
            "launches": sum(by_path.values()), "launches_by_path": by_path, "main_path": "mse_train",
            "max_abs_err": max(a["max_abs_err"] for a in at.values()),
            "max_err": max(a["max_abs_err"] for a in at.values()), "kernel_ms": main_at["ms"],
            **{k: main_at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_device_ms",
                                       "host_us")},
            "library_call": lib_call, "at": at})
        if kname == "sequence_untile":
            entries[-1]["replaces_note"] = ("the gradient of the sequence tile: the reference differentiates "
                                            "_pool's none branch, src/repro/core/embedding_engine.py:418-423")
        if kname == "fused_bucketize":
            entries[-1]["path_launches"] = {"mse_train": mse_paths, "kernels_vs_plain": bucket_path_launches}
            entries[-1]["kernel_device_ms_clean_l2"] = main_at["kernel_device_ms_clean_l2"]
            check(all(a["kernel_device_ms"] is not None and a["kernel_device_ms_clean_l2"] is not None
                      for a in at.values()), f"fused_bucketize: no device time in the traces: {at}")
        del inputs
    del mse_kernels, op_args, op_random
    check(not recorded, f"recorded inputs left unmeasured: {list(recorded)}")
    torch.cuda.empty_cache()

    # ------------------------------------- 4 the MSE example's main(), resumed
    # The twin's main() at the example's own settings (batch 128, --rows
    # 4096, its budgets): 60 steps with checkpoints every 20; then 40 steps
    # in a second directory and a resumed run from that checkpoint to 60.
    # One loader thread: with two, the readers interleave the row groups in
    # no fixed order, so two runs see different batch orders.
    from repro_torch.checkpoint import saver as saver_lib
    from repro_torch.obs import read_jsonl

    loop_dir = ROOT / "build" / "mse_loop"
    shutil.rmtree(loop_dir, ignore_errors=True)
    loop_args = ["--device", "cuda", "--rows", str(LOOP_ROWS), "--ckpt-every", "20", "--io-threads", "1"]

    def run_main(argv: list) -> tuple[dict, str]:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            out = mse.main(argv + loop_args)
        return out, printed.getvalue()

    def step_losses(path: Path) -> dict:
        return {r["step"]: r["metrics"]["loss"] for r in read_jsonl(path) if r.get("type") == "step"}

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_a, printed_a = run_main(["--steps", str(LOOP_STEPS), "--workdir", str(loop_dir / "a"),
                                 "--telemetry", str(loop_dir / "a.jsonl")])
    loop_a_s = time.perf_counter() - t0
    loop_launches = counts()
    run_b1, _ = run_main(["--steps", str(LOOP_RESUME_AT), "--workdir", str(loop_dir / "b"),
                          "--telemetry", str(loop_dir / "b1.jsonl")])
    run_b2, printed_b2 = run_main(["--steps", str(LOOP_STEPS), "--workdir", str(loop_dir / "b"), "--resume",
                                   "--telemetry", str(loop_dir / "b2.jsonl")])
    la, lb1, lb2 = (step_losses(loop_dir / f) for f in ("a.jsonl", "b1.jsonl", "b2.jsonl"))
    recs = read_jsonl(loop_dir / "a.jsonl")
    steps_rec = [r for r in recs if r.get("type") == "step"]
    total_s = sum(r["dur_s"] for r in steps_rec) + sum(r["dur_s"] for r in recs if r.get("type") == "span")
    shares = {ph: (sum(r["spans"].get(ph, 0.0) for r in steps_rec)
                   + sum(r["dur_s"] for r in recs if r.get("type") == "span" and r["name"] == ph)) / total_s
              for ph in ("data_wait", "device_step", "checkpoint")}
    emit({"phase": "mse_loop_run", "steps": len(steps_rec), "steps_per_s": len(steps_rec) / total_s,
          "train_loop_s": total_s, "main_s": loop_a_s, "phase_shares": shares,
          "step_ms_p50": float(np.percentile([r["dur_s"] * 1e3 for r in steps_rec], 50)),
          "io_threads": 1, "printed_tail": printed_a.strip().splitlines()[-3:]})
    ckpt_a = loop_dir / "a" / "ckpt"
    names = sorted(n[len("state/"):] for n in saver_lib.leaf_names(ckpt_a, LOOP_STEPS) if n.startswith("state/"))
    lin = [f"{m}/{p}" for m in ("attn_k", "attn_q", *(f"dnn/l{i}" for i in range(5))) for p in ("b", "w")]
    want_names = sorted([f"dense/{x}" for x in lin] + [f"opt/{mv}/{x}" for mv in ("m", "v") for x in lin]
                        + [f"sparse/dim8/blocks/{x}" for x in ("0", "1/0", "1/1")]
                        + [f"sparse/dim8/idmap/{i}" for i in range(7)] + ["step"])
    resumed_err = max(abs(lb2[st] - la[st]) / abs(la[st]) for st in range(LOOP_RESUME_AT + 1, LOOP_STEPS + 1))
    first10 = float(np.mean([la[st] for st in range(1, 11)]))
    last10 = float(np.mean([la[st] for st in range(LOOP_STEPS - 9, LOOP_STEPS + 1)]))
    every_step = {"fused_gather.gather_rows": 4, "segment_reduce.segment_sum": 0,
                  "segment_reduce.segment_expand_csr": 0, "segment_reduce.segment_sum_csr_group": 1,
                  "segment_reduce.segment_expand_csr_group": 1, "fused_scatter.scatter_add_rows": 3,
                  "fused_transform.fused_bucketize": 1, "sequence_tile.sequence_tile": mse.N_SEQ,
                  "sequence_tile.sequence_untile": mse.N_SEQ}
    emit({"phase": "mse_loop", "model": "examples/train_mse.py main() (its settings: batch 128, --rows "
          f"{LOOP_ROWS}, its budgets)", "io_threads": 1, "io_threads_note": "one loader thread: with two the "
          "row groups interleave in no fixed order", "steps": LOOP_STEPS, "ckpt_every": 20,
          "resumed_from": run_b2["result"].resumed_from, "losses_uninterrupted": [la[st] for st in sorted(la)],
          "losses_resumed": [lb2[st] for st in sorted(lb2)], "resumed_max_rel_err": resumed_err,
          "loss_first10_mean": first10, "loss_last10_mean": last10,
          "ckpt_state_names": len(names), "io_overflow": run_a["overflow"],
          "launches": loop_launches, "tolerance": "resumed losses within 1e-5 relative of the uninterrupted run"})
    check(sorted(la) == list(range(1, LOOP_STEPS + 1)) and sorted(lb1) == list(range(1, LOOP_RESUME_AT + 1))
          and sorted(lb2) == list(range(LOOP_RESUME_AT + 1, LOOP_STEPS + 1)), "loop: missing step records")
    check(run_b2["result"].resumed_from == LOOP_RESUME_AT and "resumed from step" in printed_b2,
          "loop: the second run did not resume from its checkpoint")
    check(all(lb1[st] == la[st] for st in lb1), "loop: two fresh runs differ over their first steps")
    check(resumed_err <= 1e-5, f"loop: resumed losses differ from the uninterrupted run by {resumed_err}")
    check(all(np.isfinite(list(la.values()))) and last10 < first10, f"loop: the loss did not fall {first10} {last10}")
    check(names == want_names, f"loop: checkpoint names {names}")
    check(run_a["overflow"] >= 0 and "io overflow" in printed_a, "loop: the loader's overflow is not reported")
    check(all(loop_launches[k] == v * LOOP_STEPS for k, v in every_step.items())
          and loop_launches["fused_scatter.scatter_set_rows"] > 0
          and loop_launches["fused_gather.gather_rows_slab"] == 0, f"loop launches {loop_launches}")
    del run_a, run_b1, run_b2
    torch.cuda.empty_cache()

    # ------------------- 5 the slab gather at its op entry, counted and measured
    slab_r = np.random.default_rng(SEED + 2)
    windows = np.sort(slab_r.integers(0, SLAB_R // 512, -(-SLAB_K // 128)))
    slab_ids = (windows[:, None] * 512 + np.sort(slab_r.integers(0, 512, (windows.size, 128)), axis=1))
    slab_ids = torch.from_numpy(slab_ids.reshape(-1)[:SLAB_K]).to(dev)  # runs of 128 inside one window
    slab_at = {}
    for label, D in (("operator_table1", 16), ("d128", 128)):
        table = torch.from_numpy(slab_r.normal(size=(SLAB_R, D)).astype(np.float32)).to(dev)
        if label == "operator_table1":  # the op entry a user calls, counted
            reset_counts()
            fg_ops.gather_rows(table, slab_ids, mode="slab")
            torch.cuda.synchronize()
            slab_launches = counts()
            check(slab_launches["fused_gather.gather_rows_slab"] == 1
                  and sum(slab_launches.values()) == 1, f"slab op launches {slab_launches}")
        slab_at[label] = _measure_slab(fg_ops.gather_rows, fg_ref.gather_rows_slab, table, slab_ids)
        del table
        torch.cuda.empty_cache()
    del slab_ids
    for e in entries:  # the earlier kernels' launches on this slice's paths
        e["launches_by_path"].update(mse_loop=loop_launches[e["name"]], slab_op=slab_launches[e["name"]])
    slab_by_path = {"csr_op": csr_launches["fused_gather.gather_rows_slab"],
                    "serve": launches["fused_gather.gather_rows_slab"],
                    "train": train_launches["fused_gather.gather_rows_slab"],
                    "prefill": prefill_launches["fused_gather.gather_rows_slab"],
                    "mse_train": mse_launches["fused_gather.gather_rows_slab"],
                    "mse_loop": loop_launches["fused_gather.gather_rows_slab"],
                    "slab_op": slab_launches["fused_gather.gather_rows_slab"]}
    main_slab = slab_at["operator_table1"]
    entries.append({
        "name": "fused_gather.gather_rows_slab", "route": "cuda", "source": "src/repro_torch/csrc/fused_gather.cu",
        "replaces": "src/repro/kernels/fused_gather/fused_gather.py:87", "ok": True,
        "launches": sum(slab_by_path.values()), "launches_by_path": slab_by_path, "main_path": "slab_op",
        "main_path_note": "no path of the reference calls it: its entry is the op gather_rows(mode='slab')",
        "max_abs_err": max(a["max_abs_err"] for a in slab_at.values()),
        "max_err": max(a["max_abs_err"] for a in slab_at.values()), "kernel_ms": main_slab["ms"],
        **{k: main_slab[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "kernel_device_ms", "host_us")},
        "library_call": "torch.index_select at the clamped ids", "at": slab_at})
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4 full-width LM train
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()  # what earlier phases still hold: near zero
    check(start_bytes < (1 << 30), f"{start_bytes} bytes still allocated before the LM train phase")
    check(qwen2_5_3b.ARCH.shape("train_4k")["seq_len"] == LM_TRAIN_T, "train_4k seq_len")
    t0 = time.perf_counter()
    ltrain = build_cell("qwen2.5-3b", "train_4k", device=dev, shape_override=ShapeCell(
        "train_4k", "train", {"seq_len": LM_TRAIN_T, "global_batch": 1}))
    lstate = ltrain.init_state()  # weights from a seeded generator, zero moments, an empty engine
    torch.cuda.synchronize()
    lsetup_s = time.perf_counter() - t0
    lstate_bytes = {"dense_params": sum(p.numel() * p.element_size() for p in lstate["dense"].parameters()),
                    "adamw_moments": sum(t.numel() * t.element_size() for t in _tensors(lstate["opt"])),
                    "engine": sum(t.numel() * t.element_size() for t in _tensors(lstate["sparse"]))}
    n_lm = N_LM_WARMUP + N_LM_STEPS
    lbatches = [ltrain.make_batch(40_000 + s) for s in range(n_lm + 2)]  # then one profiled, one repeated
    lexpect_live, seen = [], torch.empty(0, dtype=torch.int32, device=dev)
    for b in lbatches[:n_lm]:  # distinct tokens seen up to each step: the rows it must hold
        seen = torch.unique(torch.cat([seen, b.reshape(-1)]))
        lexpect_live.append(seen.numel())
    recorder(fa_ops, "flash_attention")  # layer 0's forward: the step's first call
    for fn_name in ("scatter_add_rows", "scatter_set_rows"):  # D 2,048; the table (2.5 GB) kept as it is
        real[fn_name] = recorder(fs_ops, fn_name)
    real["gather_rows"] = recorder(fg_ops, "gather_rows")  # the step's first: the token rows' fetch

    def record_last_bwd(*args, **kw):  # layer 0's backward: the step's last call
        if phase["name"]:
            recorded[("flash_bwd", phase["name"])] = ([keep(a, False) for a in args], kw)
        return real["flash_bwd"](*args, **kw)

    real["flash_bwd"] = fa_ops.flash_bwd
    fa_ops.flash_bwd = record_last_bwd
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tc0 = fa_ops.tensor_core_launches()
    lstep_ms, llosses, linserted = [], [], []
    for s in range(n_lm):
        phase["name"] = "lm_train" if s == N_LM_WARMUP - 1 else None  # the last warm-up step
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lstate, out = ltrain.step_fn(lstate, lbatches[s])
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= N_LM_WARMUP:
            lstep_ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in out.items() if k != "loss"}
        llosses.append(float(out["loss"]))
        linserted.append(met[f"{gkey}/idmap_inserted"])
        check(all(v == 0 for k, v in met.items() if "overflow" in k), f"LM train overflow at step {s + 1}: {met}")
        check(np.isfinite(llosses[-1]), f"LM train loss {llosses[-1]} at step {s + 1}")
        check(met[f"{gkey}/dev_rows_live"] == lexpect_live[s],
              f"LM step {s + 1}: {met[f'{gkey}/dev_rows_live']} rows live, {lexpect_live[s]} tokens seen")
    lm_peak = torch.cuda.max_memory_allocated()
    lm_launches = counts()
    lm_tc = [a - b for a, b in zip(fa_ops.tensor_core_launches(), tc0)]
    fa_ops.flash_attention, fa_ops.flash_bwd = real["flash_attention"], real["flash_bwd"]
    fs_ops.scatter_add_rows, fs_ops.scatter_set_rows = real["scatter_add_rows"], real["scatter_set_rows"]
    fg_ops.gather_rows = real["gather_rows"]
    n_new = sum(1 for x in linserted if x > 0)
    want_launches = {"fused_gather.gather_rows": 4 * n_lm, "fused_gather.gather_rows_slab": 0,
                     "segment_reduce.segment_sum": 0, "segment_reduce.segment_expand_csr": 0,
                     "segment_reduce.segment_sum_csr_group": 0, "segment_reduce.segment_expand_csr_group": 0,
                     "fused_scatter.scatter_add_rows": 3 * n_lm,
                     "fused_scatter.scatter_set_rows": 3 * n_new,
                     "flash_attention.flash_fwd": 2 * L_lm * n_lm, "flash_attention.flash_bwd": L_lm * n_lm,
                     "fused_transform.fused_bucketize": 0, "sequence_tile.sequence_tile": 0,
                     "sequence_tile.sequence_untile": 0}
    check(lm_launches == want_launches, f"LM train launches {lm_launches}, expected {want_launches}")
    check(lm_tc == [lm_launches["flash_attention.flash_fwd"], lm_launches["flash_attention.flash_bwd"]],
          f"LM train: tensor-core launches {lm_tc} of {lm_launches}")
    check(linserted[0] > 0, "LM step 1 inserted nothing")
    check(all(bool(torch.isfinite(p).all()) for p in lstate["dense"].parameters()), "LM params not finite")

    def lm_step(b):
        nonlocal lstate
        lstate, _ = ltrain.step_fn(lstate, b)

    emit(profile_requests("lm_train", lm_step, [lbatches[n_lm]]))
    lrepeat = []
    for _ in range(N_LM_REPEAT):  # one batch again and again: the loss must fall
        lstate, out = ltrain.step_fn(lstate, lbatches[-1])
        lrepeat.append(float(out["loss"]))
    check(all(np.isfinite(lrepeat)) and lrepeat[-1] < lrepeat[0], f"LM loss on one repeated batch: {lrepeat}")
    del lstate, ltrain, lbatches, seen, out
    torch.cuda.empty_cache()
    # layer 0's attention gradients on all 4,096 rows against the plain
    # backward (its (H, T, T) fp32 scores are 1.07 GB), and what a zero
    # gradient or the dK of the other kv head would read
    bargs = recorded.pop(("flash_bwd", "lm_train"))[0]
    got = real["flash_bwd"](*bargs)
    want = fa_ref.flash_bwd(*bargs)
    lm_layer0 = flash_bwd_readings(got, want, bargs[0].dtype)
    check(all(bool(torch.isfinite(g).all()) for g in got), "layer 0 gradients not finite")
    check(max(lm_layer0[f"{n}_err_over_tol"] for n in GRAD_NAMES) <= 1.0,
          f"LM train layer 0 attention gradients {lm_layer0}")
    check(min(lm_layer0[f"{n}_zero_err_over_tol"] for n in GRAD_NAMES) > 1.0
          and lm_layer0["dk_other_kv_head_err_over_tol"] > 1.0,
          f"the layer 0 gradient check cannot tell a wrong gradient: {lm_layer0}")
    del got, want
    lsm = np.array(lstep_ms)
    emit({"phase": "full_lm_train", "arch": "qwen2.5-3b", "shape": "train_4k", "widths": {
              "n_layers": L_lm, "d_model": d_model, "n_heads": lm_cfg.n_heads, "n_kv_heads": lm_cfg.n_kv_heads,
              "d_ff": lm_cfg.d_ff, "vocab_size": V, "qkv_bias": lm_cfg.qkv_bias, "rope_theta": lm_cfg.rope_theta},
          "seq_len": LM_TRAIN_T, "reduced": {"global_batch": [256, 1]}, "remat": lm_cfg.remat,
          "warmup": N_LM_WARMUP, "steps": N_LM_STEPS, "setup_s": lsetup_s,
          "step_ms_p50": float(np.percentile(lsm, 50)), "step_ms_p99": float(np.percentile(lsm, 99)),
          "step_ms_mean": float(lsm.mean()), "step_ms": lstep_ms,
          "tokens_per_s": LM_TRAIN_T / (float(np.percentile(lsm, 50)) / 1e3),
          "loss": llosses, "idmap_inserted": linserted, "rows_live": lexpect_live,
          "loss_on_one_repeated_batch": lrepeat, "layer0_attention_grads_vs_plain": lm_layer0,
          "allocated_at_phase_start_bytes": start_bytes, "state_bytes": lstate_bytes,
          "max_memory_allocated_bytes": lm_peak, "launches": lm_launches,
          "flash_tensor_core_launches": {"fwd": lm_tc[0], "bwd": lm_tc[1]},
          "launches_per_step": {k: v / n_lm for k, v in lm_launches.items()}})

    # ------------------------------------ 5 the flash kernels on the LM inputs
    flash_at["lm_train"] = _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref,
                                          *recorded.pop(("flash_attention", "lm_train"))[0], path="lm_train")
    bwd = _measure_flash_bwd(real["flash_bwd"], fa_ref, *bargs)
    del bargs
    by_name = {e["name"]: e for e in entries}
    for full, kname, plain in (("fused_gather.gather_rows", "gather_rows", fg_ref.gather_rows),
                               ("fused_scatter.scatter_add_rows", "scatter_add_rows", fs_ref.scatter_add_rows),
                               ("fused_scatter.scatter_set_rows", "scatter_set_rows", fs_ref.scatter_set_rows)):
        if (kname, "lm_train") in recorded:  # the set runs on a step that inserts rows
            args, kw = recorded.pop((kname, "lm_train"))
            save_inputs(opts.save_inputs, kname, "lm_train", args)
            _add_path(by_name[full], "lm_train", _measure(kname, real[kname], plain, args, kw, 20, dev))
            del args
            torch.cuda.empty_cache()
    # row 7b: the fp32 flash kernels (FMA) at one of phase 2's shapes,
    # against the plain formulas, timed beside fp32 SDPA
    g32 = torch.Generator(device=dev).manual_seed(SEED)
    q32, k32, v32, do32 = (torch.randn((1, 1_024, n, 128), generator=g32, device=dev) for n in (16, 2, 2, 16))
    flash_at["fp32"] = _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref, q32, k32, v32, path="fp32")
    o32, lse32 = fa_ops.flash_fwd(q32, k32, v32)
    fp32_bargs = (q32, k32, v32, o32, lse32, do32)
    fp32_bwd = flash_bwd_readings(real["flash_bwd"](*fp32_bargs), fa_ref.flash_bwd(*fp32_bargs), torch.float32)
    check(max(fp32_bwd[f"{n}_err_over_tol"] for n in GRAD_NAMES) <= 1.0, f"fp32 flash_bwd {fp32_bwd}")
    bwd_fp32 = _measure_flash_bwd(real["flash_bwd"], fa_ref, *fp32_bargs, path="fp32")
    bwd_fp32["at"]["fp32"].update(readings=fp32_bwd, **{k: bwd_fp32[k] for k in (
        "ms", "kernel_device_ms", "kernel_device_ms_by_kernel", "plain_ms", "bound_ms", "bound_by", "bound_share",
        "host_us",
        "library_ms", "two_launches_bit_equal")})
    del q32, k32, v32, do32, o32, lse32, fp32_bargs
    for e in entries:
        e["launches_by_path"]["lm_train"] = lm_launches[e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    fwd_by_path = {"csr_op": csr_launches["flash_attention.flash_fwd"],
                   "mse_loop": loop_launches["flash_attention.flash_fwd"],
                   "slab_op": slab_launches["flash_attention.flash_fwd"],
                   "serve": launches["flash_attention.flash_fwd"],
                   "train": train_launches["flash_attention.flash_fwd"],
                   "prefill": prefill_launches["flash_attention.flash_fwd"],
                   "mse_train": mse_launches["flash_attention.flash_fwd"],
                   "lm_train": lm_launches["flash_attention.flash_fwd"]}
    entries.append({
        "name": "flash_attention.flash_fwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83", "ok": True,
        "launches": sum(fwd_by_path.values()), "launches_by_path": fwd_by_path, "main_path": "prefill",
        "max_abs_err": max(layer0["o_max_abs_err"], *(a["max_abs_err"] for a in flash_at.values())),
        "max_err": layer0["o_max_abs_err"], "kernel_ms": flash_at["prefill"]["ms"],
        **{k: flash_at["prefill"][k] for k in ("ms", "kernel_device_ms", "plain_ms", "bound_ms", "bound_by",
                                              "bound_share", "library_ms", "host_us")},
        "library_call": "F.scaled_dot_product_attention(is_causal=True), kv expanded", "at": flash_at,
        "bf16_route": "tensor cores (wgmma, TMA)", **flash_build["flash_attention.flash_fwd"]})
    bwd_by_path = {"csr_op": csr_launches["flash_attention.flash_bwd"],
                   "mse_loop": loop_launches["flash_attention.flash_bwd"],
                   "slab_op": slab_launches["flash_attention.flash_bwd"],
                   "serve": launches["flash_attention.flash_bwd"],
                   "train": train_launches["flash_attention.flash_bwd"],
                   "prefill": prefill_launches["flash_attention.flash_bwd"],
                   "mse_train": mse_launches["flash_attention.flash_bwd"],
                   "lm_train": lm_launches["flash_attention.flash_bwd"]}
    entries.append({
        "name": "flash_attention.flash_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:210", "ok": True,
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path, "main_path": "lm_train",
        "max_abs_err": max(lm_layer0[f"{n}_max_abs_err"] for n in GRAD_NAMES),
        "max_err": max(lm_layer0[f"{n}_max_abs_err"] for n in GRAD_NAMES), "kernel_ms": bwd["ms"],
        "library_call": "torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True), kv expanded",
        **bwd, "bf16_route": "tensor cores (wgmma, TMA)", **flash_build["flash_attention.flash_bwd"]})
    entries[-1]["at"]["fp32"] = bwd_fp32["at"]["fp32"]
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


# the CUDA kernel each wrapper launches, by the name the profiler gives it
KERNEL_NAMES = {"gather_rows": "gather_rows_kernel", "segment_sum_csr": "segment_sum_sorted_kernel",
                "segment_expand_csr": "segment_expand_csr_kernel", "scatter_add_rows": "scatter_rows_kernel",
                "scatter_set_rows": "scatter_rows_kernel", "segment_sum_csr_group": "segment_sum_group_kernel",
                "segment_expand_csr_group": "segment_expand_group_kernel"}


def _measure(kname: str, real, plain, args: list, kw: dict, iters: int, dev) -> dict:
    """One kernel on one recorded input: checked against its plain version
    (bit-equal, or rtol = atol = 1e-5 for the sums, the grouped sum also
    bit-equal to the per-feature kernel), then timed beside the plain
    version and one PyTorch library call, with the card's bound and the
    kernel's device time with a cold L2."""
    n_ops = 0.0
    if kname.endswith("_group"):
        return _measure_group(kname, real, plain, args, iters, dev)
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
        where = torch.nonzero(live).squeeze(1)  # where the live slots lie (scripts/scatter_ab.py lays them out so)
        shape = {"R": table.shape[0], "D": D, "K": K, "live_slots": n_live, "ids": str(ids.dtype),
                 "first_live": int(where[0]) if n_live else 0, "last_live": int(where[-1]) if n_live else -1}
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
            n_distinct = torch.unique(idx).numel()
            n_bytes = (n_distinct + K) * D * 4 + K * ids.element_size()
            shape = {"R": tab.shape[0], "D": D, "K": K, "ids": str(ids.dtype), "distinct_rows": n_distinct}
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
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "host_us": host_us(run_kernel),
            "kernel_device_ms": kernel_device_ms(run_kernel, KERNEL_NAMES[kname])}


def _measure_group(kname: str, real, plain, args: list, iters: int, dev) -> dict:
    """The grouped segment sum or its gradient on one recorded input (a dim
    group's rows and its features' splits, slices and gradients): held to
    its plain version (the forward within rtol = atol = 1e-5 and bit-equal
    to the per-feature kernel on each slice, the gradient bit-equal), then
    timed beside the plain version and one library call on segment ids
    prebuilt for the group's rows (feature f's segment s is row base_f + s
    of one output; rows no segment covers go to a spare row), with the
    card's bound and the kernel's device time with a cold L2."""
    from repro_torch.kernels.segment_reduce import ops as sr_ops

    fwd = kname == "segment_sum_csr_group"
    if fwd:
        vals, sps, offs, sizes = args
        (N, D), grads = vals.shape, None
    else:
        grads, sps, offs, sizes, N, D = args
    got, want = real(*args), plain(*args)
    torch.cuda.synchronize()
    if fwd:
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, want))
        err = max((float((a - b).abs().max()) for a, b in zip(got, want) if a.numel()), default=0.0)
        ok = ok and all(torch.equal(a, sr_ops.segment_sum_csr(vals[o:o + n], sp))
                        for a, sp, o, n in zip(got, sps, offs, sizes))
    else:
        ok = torch.equal(got, want)
        err = 0.0 if ok else float("inf")
    del got, want
    n_seg = [sp.numel() - 1 for sp in sps]
    base = [0, *np.cumsum(n_seg).tolist()]
    spare = base[-1]
    idx = torch.full((N,), spare, dtype=torch.int64, device=dev)
    live = 0
    for f, (sp, o, n) in enumerate(zip(sps, offs, sizes)):
        if grads is not None and grads[f] is None:
            continue
        pos = torch.arange(n, dtype=sp.dtype, device=dev)
        inside = (pos >= sp[0]) & (pos < sp[-1])
        seg = torch.searchsorted(sp, pos, right=True).long() - 1 + base[f]
        idx[o:o + n] = torch.where(inside, seg, spare)
        live += int(inside.sum())
    splits_bytes = sum(sp.numel() * sp.element_size() for sp in sps)
    shape = {"features": len(sps), "N": N, "D": D, "segments": spare}
    if fwd:
        n_bytes, n_ops = (live + spare) * D * 4 + splits_bytes, float(live * D)
        shape["live_rows"] = live
        lib = lambda: torch.zeros((spare + 1, D), device=dev).index_add_(0, idx, vals)  # noqa: E731
    else:
        n_given = sum(s for s, g in zip(n_seg, grads) if g is not None)
        n_bytes, n_ops = (n_given + N) * D * 4 + splits_bytes, 0.0
        shape.update(covered_rows=live, missing_gradients=sum(g is None for g in grads),
                     g_row_strides=sorted({g.stride(0) for g in grads if g is not None}))
        g_all = torch.cat([g if g is not None else torch.zeros((s, D), device=dev)
                           for g, s in zip(grads, n_seg)] + [torch.zeros((1, D), device=dev)])
        lib = lambda: torch.index_select(g_all, 0, idx)  # noqa: E731
    check(ok, f"{kname} disagrees with its plain version on the recorded inputs {shape}")
    run = lambda: real(*args)  # noqa: E731
    lib_ms = time_ms(lib, iters)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: plain(*args), max(3, iters // 10))
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "host_us": host_us(run),
            "kernel_device_ms": kernel_device_ms(run, KERNEL_NAMES[kname])}


def _add_path(entry: dict, path: str, at: dict) -> None:
    """A kernel entry's measurement on one more path's recorded inputs."""
    entry["at"][path] = at
    entry["max_abs_err"] = entry["max_err"] = max(entry["max_abs_err"], at["max_abs_err"])


def _measure_mse_kernel(kname: str, real, plain, args: list, iters: int = 100) -> dict:
    """A kernel of the MSE path on one input: held to its plain version
    (equal), then timed beside the plain version and the library call, with
    the card's bound (each input read once, each output written once)."""
    got, want = real(*args), plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"{kname} disagrees with its plain version")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    del got, want
    n_ops, extra = 0.0, {}
    if kname == "fused_bucketize":
        from repro_torch.kernels.fused_transform import fused_transform as ft_launch

        vals, cids, bnds, offs = args
        N, B, C = vals.numel(), bnds.numel(), offs.numel() - 1
        widths = (offs[1:] - offs[:-1]).long()
        max_w = int(widths.max())
        n_bytes = N * (vals.element_size() + 4 + 8) + (B + C + 1) * 4
        n_ops = float(N * max(1, int(np.ceil(np.log2(max_w + 1)))))  # compares
        pos = torch.arange(B, device=bnds.device)
        col = torch.searchsorted(offs, pos.to(offs.dtype), right=True).long() - 1
        table = torch.full((C, max_w), float("inf"), device=bnds.device)
        table[col, pos - offs[col].long()] = bnds
        vf, cl = vals.float(), cids.long()
        lib = lambda: torch.searchsorted(table[cl], vf[:, None], right=True)
        contiguous = bool((cids[1:] >= cids[:-1]).all())
        if contiguous:  # per-column calls, the unfused shape: each column's values one contiguous block
            starts = torch.searchsorted(cids, torch.arange(C + 1, dtype=cids.dtype, device=cids.device)).tolist()
            o = offs.tolist()
            cols = [(vf[starts[c]:starts[c + 1]], bnds[o[c]:o[c + 1]]) for c in range(C)]
            extra["library_loop_ms"] = time_ms(lambda: [torch.bucketize(v, b, right=True) for v, b in cols], 20)
        # the path its blocks took, and the other path's time: every tile read through the read-only cache
        ran = ft_launch.path_launches()
        real(*args)
        extra["paths"] = [p for p, a, b in zip(ft_launch.PATHS, ft_launch.path_launches(), ran) if a > b]
        out = torch.empty((N,), dtype=torch.int64, device=vals.device)
        cached = lambda: ft_launch.fused_bucketize(vals, cids, bnds, offs, out, stage=False)
        cached()
        torch.cuda.synchronize()
        check(torch.equal(out, plain(*args)), "fused_bucketize's cached path disagrees")
        extra["cached_path_kernel_device_ms"] = kernel_device_ms(cached, f"{kname}_kernel")
        extra["kernel_device_ms_clean_l2"] = kernel_device_ms(lambda: real(*args), f"{kname}_kernel", dirty=False)
        shape = {"N": N, "columns": C, "boundaries": B, "width_max": max_w, "contiguous_columns": contiguous,
                 "plan": ft_launch.launch_plan(N, B, C, torch.cuda.get_device_properties(vals.device)
                                               .multi_processor_count)._asdict()}
    elif kname == "sequence_tile":
        vals, splits, k = args
        (N, D), S = vals.shape, splits.numel() - 1
        lens = (splits[1:] - splits[:-1]).long()
        live = int(lens.clamp(0, k).sum())
        n_bytes = (live * D + S * k * D) * 4 + (S + 1) * splits.element_size()
        j = torch.arange(k, device=vals.device)
        idx = (splits[:-1, None].long() + j).clamp(0, N - 1).reshape(-1)
        mask = (j[None, :] < lens[:, None]).float()[..., None]
        lib = lambda: torch.index_select(vals, 0, idx).view(S, k, D) * mask
        shape = {"N": N, "D": D, "S": S, "k": k, "live_slots": live}
    else:  # sequence_untile: g (S, k, D) → (N, D)
        g, splits, N = args
        S, k, D = g.shape
        pos = torch.arange(N, dtype=splits.dtype, device=g.device)
        row = (torch.searchsorted(splits, pos, right=True) - 1).clamp(0, S - 1).long()
        off = pos.long() - splits[row].long()
        ok = (pos >= splits[0]) & (pos < splits[-1]) & (off < k)
        live = int(ok.sum())
        n_bytes = (live * D + N * D) * 4 + (S + 1) * splits.element_size()
        idx = torch.where(ok, row * k + off, S * k)
        g_ext = torch.cat([g.reshape(S * k, D), g.new_zeros((1, D))])
        lib = lambda: torch.index_select(g_ext, 0, idx)
        shape = {"N": N, "D": D, "S": S, "k": k, "live_slots": live}
    lib_ms = time_ms(lib, iters)
    k_ms = time_ms(lambda: real(*args), iters)
    p_ms = time_ms(lambda: plain(*args), max(3, iters // 10))
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    return {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "host_us": host_us(lambda: real(*args)),
            "kernel_device_ms": kernel_device_ms(lambda: real(*args), f"{kname}_kernel"), **extra}


def _measure_slab(op, plain, table: torch.Tensor, ids: torch.Tensor, iters: int = 100) -> dict:
    """The slab gather through its op on one input: equal to its plain
    version, then timed beside it and ``index_select`` at the clamped ids,
    with the bound of the rows it must read (the distinct rows inside their
    run's window) and write, and the kernel's device time with a cold L2."""
    run = lambda: op(table, ids, mode="slab")
    got, want = run(), plain(table, ids)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "gather_rows_slab disagrees with its plain version at the measured shape")
    read = want.any(dim=1)
    K, D = ids.numel(), table.shape[1]
    n_read = int(torch.unique(ids[read]).numel())
    n_bytes = (n_read + K) * D * 4 + K * ids.element_size()
    del got, want
    idx = torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)
    b_ms, b_by = bound_ms(n_bytes)
    return {"shape": {"R": table.shape[0], "D": D, "K": K, "rows_blk": 128, "slab": 512,
                      "rows_read": int(read.sum()), "distinct_rows_read": n_read, "zero_rows": K - int(read.sum())},
            "max_abs_err": 0.0, "ms": time_ms(run, iters), "plain_ms": time_ms(lambda: plain(table, ids), 10),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, idx), iters),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "host_us": host_us(run),
            "kernel_device_ms": kernel_device_ms(run, "gather_rows_slab_kernel")}


def kernel_device_ms(fn, name_part: str, iters: int = 20, dirty: bool = True, tries: int = 3) -> float | None:
    """The device time of one call's launches of the kernels whose name
    holds ``name_part`` (for each such kernel its mean over the events the
    trace holds, summed), from a torch.profiler trace of ``iters`` calls of
    ``fn``:
    the kernel alone, without the host cost of its wrapper, which CUDA
    events around a small kernel's calls measure instead. A 256 MB write
    before each call leaves the 50 MB L2 cold, as the HBM bound assumes
    (``dirty``: full of written lines the kernel's misses write back);
    ``dirty=False`` reads the 256 MB instead (cold and clean). A trace that
    holds no such event is taken again, up to ``tries`` times in all; None
    when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(1 << 26, dtype=torch.float32, device=torch.device("cuda"))
    fn()
    torch.cuda.synchronize()
    by_name: dict = {}  # a call may launch several kernels; a trace may miss some of a long run's events
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_() if dirty else flush.amax()
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and name_part in e.name:
                by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
        if by_name:
            break
    del flush
    return sum(sum(d) / len(d) for d in by_name.values()) / 1e3 if by_name else None


def _measure_flash(real, fwd, ref, q, k, v, path: str = "prefill") -> dict:
    """The flash kernel on layer 0's recorded inputs of one path: O held to
    its plain version (in query-row pieces, ``plain_flash_chunked``) within
    one rounding, two launches bit-equal (O and LSE), then timed beside the
    plain version and scaled_dot_product_attention on the same q and the
    expanded k, v; its device time from a profiler trace."""
    import torch.nn.functional as F

    B, T, H, hd = q.shape
    o, want = real(q, k, v), plain_flash_chunked(ref, q, k, v)[0]
    err, excess = float((o.float() - want.float()).abs().max()), flash_excess(o, want, q.dtype)
    check(excess <= 1.0, f"flash_fwd on the {path} inputs: {excess} of the tolerance")
    del o, want
    (o1, l1), (o2, l2) = fwd(q, k, v), fwd(q, k, v)
    bit_equal = bool(torch.equal(o1, o2) and torch.equal(l1, l2))
    check(bit_equal, f"flash_fwd on the {path} inputs: two launches differ")
    del o1, l1, o2, l2
    ke, ve = (ref.expand_kv(x, H // k.shape[2]).transpose(1, 2) for x in (k, v))
    qt = q.transpose(1, 2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True), 3)
    del ke, ve, qt
    k_ms = time_ms(lambda: real(q, k, v), 3)
    dev_ms = kernel_device_ms(lambda: real(q, k, v), "flash_fwd", iters=3 if T > 8192 else 20)
    p_ms = time_ms(lambda: plain_flash_chunked(ref, q, k, v), 2)
    n_ops = 4.0 * hd * H * B * T * (T + 1) / 2  # two products over the causal triangle
    # q, k, v read once; O (q's shape and type) and the fp32 LSE written once
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + B * H * T * 4
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S)
    return {"ms": k_ms, "kernel_device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / (dev_ms or k_ms), "library_ms": lib_ms, "host_us": host_us(lambda: real(q, k, v)),
            "max_abs_err": err, "o_err_over_tol": excess, "two_launches_bit_equal": bit_equal,
            "plain_rows_per_piece": PLAIN_ROWS,
            "shape": {"B": B, "T": T, "H": H, "Hk": k.shape[2], "hd": hd, "dtype": str(q.dtype), "causal": True},
            "flops": n_ops, "bytes": n_bytes, "tflops_per_s": n_ops / (dev_ms or k_ms) / 1e9}


def _measure_flash_bwd(real, ref, q, k, v, o, lse, do, causal: bool = True, path: str = "lm_train") -> dict:
    """The backward kernel on layer 0's recorded train inputs (checked by the
    caller): two launches bit-equal, timed beside its plain version and the
    backward of scaled_dot_product_attention on the same q, expanded k, v and
    dO (the graph built once, then ``torch.autograd.grad`` over it); its
    device time, and that of each of its three kernels, from profiler traces."""
    import torch.nn.functional as F

    B, T, H, hd = q.shape
    g1, g2 = real(q, k, v, o, lse, do, causal), real(q, k, v, o, lse, do, causal)
    bit_equal = all(bool(torch.equal(a, b)) for a, b in zip(g1, g2))
    check(bit_equal, f"flash_bwd on the {path} inputs: two launches differ")
    del g1, g2
    qt, ke, ve = (x.transpose(1, 2).detach().requires_grad_() for x in
                  (q, ref.expand_kv(k, H // k.shape[2]), ref.expand_kv(v, H // k.shape[2])))
    out = F.scaled_dot_product_attention(qt, ke, ve, is_causal=causal)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, ke, ve), dot, retain_graph=True), 5)
    del out, qt, ke, ve
    run = lambda: real(q, k, v, o, lse, do, causal)  # noqa: E731
    k_ms = time_ms(run, 5)
    dev_ms = kernel_device_ms(run, "flash_bwd")
    parts = {n: kernel_device_ms(run, f"flash_bwd_{n}") for n in ("dq", "dkv", "group_sum")}
    p_ms = time_ms(lambda: ref.flash_bwd(q, k, v, o, lse, do, causal), 3)
    n_ops = 5.0 * hd * H * B * T * (T + 1)  # five products over the causal triangle
    # q, k, v, O, dO and the fp32 LSE read once; dQ, dK, dV written once
    n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + B * H * T * 4
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S)
    return {"ms": k_ms, "kernel_device_ms": dev_ms, "kernel_device_ms_by_kernel": parts, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / (dev_ms or k_ms), "library_ms": lib_ms,
            "host_us": host_us(run),
            "two_launches_bit_equal": bit_equal,
            "at": {path: {"shape": {"B": B, "T": T, "H": H, "Hk": k.shape[2], "hd": hd,
                                          "dtype": str(q.dtype), "causal": causal},
                                "flops": n_ops, "bytes": n_bytes,
                                "tflops_per_s": n_ops / (dev_ms or k_ms) / 1e9}}}


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
    # the fp32 adds and fills (autograd's accumulation of slice gradients among them)
    totals = {k: sum(e.time_range.end - e.time_range.start for e in kern if part in e.name) / 1e3 / n
              for k, part in (("fp32_add", "CUDAFunctor_add<float>"), ("fp32_fill", "FillFunctor<float>"))}
    return {"phase": f"{cell_name}_profile", "requests": n, "wall_ms_per_request": wall_ms / n,
            "device_busy_ms_per_request": busy_us / 1e3 / n if measured else None,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms if measured else None,
            "device_events_per_request": len(kern) / n if measured else None,
            "fp32_add_ms_per_request": totals["fp32_add"] if measured else None,
            "fp32_fill_ms_per_request": totals["fp32_fill"] if measured else None,
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
