#!/usr/bin/env python3
"""The PyTorch port serving and training dlrm-mlperf (all on the device, over
a tiered store, and over two ranks that share the card), training the MSE
ranking model of examples/train_mse.py (its step at full size, its main() with checkpoints
and a resume), running the online-window example, serving and training
Wide & Deep, SASRec and MIND, scoring 1,000,000 retrieval candidates for
the four recsys archs, training GIN (gin-tu) in its four shape cells (one
of them edge-parallel over two ranks), serving the qwen2.5-3b prefill and
its decode (decode_32k, and long_500k also sequence-sharded over two
ranks), training qwen2.5-3b, serving and training the MoE archs
(qwen2-moe-a2.7b and moonshot-v1-16b-a3b: prefill, decode and train_4k),
and serving and training the 20B dense archs (granite-20b and
internlm2-20b: prefill, decode, long-context decode and train_4k), on one
NVIDIA card, through its own CUDA kernels.

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
                example's cell at its own size, then the Wide & Deep (one
                and two dim groups), SASRec and MIND smoke serve cells and
                three train steps of each, then each recsys arch's smoke
                retrieval cell (1,000 candidates), on the card against the
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
                3 warm-up and 5 timed steps with the kernels' launch counts
                over the 8, state checks, a torch.profiler trace of three
                steps, and five steps on one repeated batch (the loss falls);
     prefill  — full-width qwen2.5-3b prefill (T 32,768, batch cut to 1,
                weights drawn on the card): rows for all 151,936 tokens
                imported, 1 warm-up and 3 timed
                requests with the kernels' launch counts, output checks,
                layer 0's attention against the plain formula on every
                query row, a torch.profiler trace of one request; then the
                serve, train and prefill kernels are measured (phase 5) and
                everything those paths held is released;
     mse      — the MSE example's widths at batch 65,536 with its budgets
                raised to hold the whole batch, from a fresh state: 3
                warm-up and 5 timed steps with the kernels' launch counts,
                overflow and row checks, a torch.profiler trace of three
                steps, five steps on one repeated batch; then the step at the
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
     train_driver — the twin of launch/train.py: its run() at published
                widths (vocab cut to 20,000 a feature, 0.78 M rows) and batch
                8,192, 40 steps over a 65,536-row ColumnIO table from one
                reader under the autoscaler, with telemetry snapshots, the
                aggregator and the Prometheus endpoint (zero overflow, a
                finite loss, valid exposition text, the launches a step: 4
                gathers, one grouped sum each way, 3 scatter adds); a
                SIGTERM at step 15 of 30 (a final checkpoint) and a resume,
                within 1e-5 of an uninterrupted run; its CLI, saving every
                step, crashed at step 6 in a fresh process (exit 42) and
                resumed from step 4 or 5, each run's steps within 1e-5 of an
                uninterrupted CLI run (the first two processes run beside
                the SIGTERM part); the LM CLI (qwen2.5-3b at smoke
                widths, every step saved) crashed at step 4 (exit 42) and
                resumed from step 2 or 3, its losses bit-equal to an
                uninterrupted run's (its first two processes beside the
                SIGTERM part too); then the benchmark twins
                (the autoscaler on a calibrated SimPipeline, the telemetry
                overhead at the MSE cell's batch of 128);
     tiered   — full-width train_batch with a tiered engine (a device tier
                of 524,288 rows over the host-DRAM tier, LRU), 8 steps
                through the Trainer and the cell's storage hooks against the
                all-device cell on the same batches: losses and the union
                export (ids, emb, m, v, last use) bit-equal, zero overflow
                and unplaceable ids, the launches held to what the store's
                demote and promote calls and the steps imply; evict_to_host
                at steps 6 and 8, each spilling exactly the device rows the
                export counts; a 9th step that promotes the spilled rows it
                touches, bit-equal again; evict_local on the all-device
                state; the row gather and scatter set measured at step 4's
                demote and promote shapes (phase 5);
     window   — the online-window twin's main() (2 of its 5 windows of 120
                steps):
                pre-train evals, post-train losses, live rows after each
                eviction, its launches; its first window on the card
                against the CPU in FP32 (within 1e-5) and in MIXED;
     delta    — delta checkpoints and crash recovery (published widths,
                vocab 10,000, batch 1,024): a row for each of the 0.26 M
                ids imported, the
                Trainer with ft_mode="delta" and FTTrainerHooks from step
                1,000 for 12 steps, a save every 2 (a base, 4 deltas, a
                compaction base, the final save), one evict_to_host discard
                of about 5% of the rows, half of them negative ids, a digest
                of the sorted export at every save; every delta at <= 10%
                dirty under 25% of the base's bytes, exact launches (4
                gathers a step and 3 a delta save's row read); a crash at
                each persistence site (a mid-shard crash, a torn frame, a
                crash before the manifest and before HEAD), each recovery
                bit-equal to the writer at the save before, the run ending
                bit-equal; the chain recovered into a tiered engine (131,072
                device rows) that trains 4 steps bit-equal to the
                all-device run with delta saves, that chain recovered
                bit-equal onto an all-device and a tiered engine, no
                discarded id back anywhere; the CLI with --ckpt-mode delta
                crashed at step 6 in a fresh process (exit 42) and resumed
                from step 5 within 1e-5 (its first two processes run beside
                the crash matrix and the tiered part); the row gather
                measured at the
                delta read (phase 5, path delta_read);
     recsys   — Wide & Deep, SASRec and MIND at published widths (their
                vocabs too): serve_p99 (batch 512, 3 warm-up and 20 timed
                requests over rows imported for the ids they touch) and
                train_batch (batch 65,536 from a fresh state: 3 warm-up and
                3 timed steps, the launches of every step held to what the
                engine's groups and inserts imply, zero overflow, a
                torch.profiler trace of one step, three steps on one
                repeated batch); then retrieval_cand (batch 1, 1,000,000
                candidates, 2 warm-up and 5 timed requests, finite scores,
                over 100 distinct) for all four recsys archs (dlrm-mlperf's
                vocab cut as above); then the serve_retrieval twin's main();
                the D-50 gather, tile, untile and scatter, the grouped sum
                at D 32 and 8 and at D 64 and the candidates' row gathers
                measured on their recorded inputs (phase 5);
     multi_rank — dlrm-mlperf train_batch (batch 65,536) at published
                widths (vocab cut as above) over two gloo ranks that share
                the card (spawned processes, each holding half of every
                table; the all_to_alls staged through pinned host memory;
                spawned at the phase's start, they wait for their turn):
                the one-rank cell first, in this process, on the same
                global batches, then 1 warm-up and 2 timed steps on the
                ranks, all in FP32: losses, the summed counters, the
                launches of every step on every rank, the ranks' exports
                against the one-rank export (ids bit-equal, each on its
                owner; the rows' updates and moments and the dense update
                within 1e-2 of the one-rank run's, relative), every kernel
                of the path on each rank's inputs against its plain
                version, two serve_p99 requests over
                both ranks against the one-rank logits, compressed_psum and
                the ZeRO-1 update on CUDA tensors against the CPU; step
                p50, the bytes of each all_to_all, peak memory a rank; over
                NCCL (3 steps, one card a rank) only where there are two
                cards;
     gnn      — gin-tu: (a) the smoke model in the four shape cells
                (minibatch_lg and ogb_products at cut scale) and molecule
                with compress_grads, three steps on the card against the
                CPU, FP32 and MIXED; (b) ogb_products (2,449,029 nodes,
                61,859,140 edges), minibatch_lg, molecule and full_graph_sm
                at published widths, 3 warm-up and 5 timed steps on one
                repeated batch: p50, p99, peak memory, exactly 5 segment
                sums and 5 gathers a step (10 and 10 in the graph task), the
                loss falling; a torch.profiler trace of an ogb_products
                step; (c) the segment sum and its gradient (the row gather)
                on ogb_products' recorded inputs against their plain
                versions, timed (path gnn_ogb); (d) ogb_products
                edge-parallel over two gloo ranks sharing the card (spawned
                at the phase's start, waiting for their turn), FP32, after
                step 1 against the one-rank run, a timed step with its
                all-reduce bytes and ms, and molecule with compress_grads
                over the ranks
                against one rank on the same global batch; (e) the train
                driver with --arch gin-tu, checkpointed and resumed;
     lm train — full-width qwen2.5-3b train_4k (T 4,096, batch cut to 1)
                from a fresh state (weights drawn on the card) on an
                emptied card: 2 warm-up and 5
                timed steps with the kernels' launch counts, state and
                memory checks, layer 0's attention gradients against the
                plain backward on every row, a torch.profiler trace of one
                step, three steps on one repeated batch (the loss falls);
                then the scatter on its D-2,048 inputs and the fp32 flash
                kernels at T 1,024, H 16, Hk 2, hd 128 are measured;
     moe      — (after the LM train, on an emptied card) the MoE family:
                the smoke prefill (T 64, B 2) and decode (S 64, B 4) cells
                of both archs on the card against the CPU (integers equal,
                logits and caches within MIXED_PREFILL_TOL at the tokens
                off a near-tie of the router, exact launches);
                qwen2-moe-a2.7b prefill_32k at published widths and its 24
                layers (batch cut to 1, rows for all 151,936 tokens, the
                56.0 GB of weights drawn on the card): 1 warm-up and 3
                timed requests, a flash launch a layer and a gather a
                request, one wait for the expert group sizes a layer, peak
                memory, a torch.profiler trace, layer 0's attention against
                the plain formula on every row and layer 0's MoE against the
                dense plain version (every expert on every token, in
                1,024-token pieces), a zero output and one with two
                experts' weights swapped shown to fail; its decode_32k at
                batch 1 (cut from 128: 825 GB of cache): the decode of token
                2,048 after a 2,048-token prefill held to the 2,049-token
                prefill's last logits, then 3 warm-up and 10 timed steps
                from a cache filled at S - 16, no wait for the device in a
                step; moonshot-v1-16b-a3b prefill_32k at published widths
                and 12 of its 48 layers (110.9 GB of fp32 weights at 48),
                as qwen2-moe's; the row gather and the flash kernel on the
                paths' recorded inputs (paths moe_prefill, moe_decode);
     moe train — (after the MoE serving, on an emptied card) qwen2-moe-a2.7b
                train_4k at published widths and 4 of its 24 layers (T
                4,096, batch cut to 1, weights drawn on the card, a fresh
                engine and zero moments): 2 warm-up and 5 timed steps, each
                checked (no overflow, a finite loss and params, the rows
                live equal to the distinct tokens seen, exact launches, two
                waits for the expert group sizes a MoE layer: the forward
                and its recompute), peak memory, a torch.profiler trace of
                one step, three steps on one repeated batch (the loss
                falls); layer 0's attention gradients on every row against
                the plain backward and its MoE output and gradients against
                the dense plain version under autograd (a zero gradient and
                two experts swapped shown to fail); the flash kernels, the
                row gather and the scatters on the path's recorded inputs
                (path moe_train); the same weights with fused_ce and
                remat_policy="dots" for one step (its loss within MIXED_TOL
                of the default's, its peak); moonshot-v1-16b-a3b train_4k at
                4 of its 48 layers, 1 warm-up and 2 timed steps;
     lm20b    — (after the MoE train, on an emptied card) granite-20b
                (MQA: 48 query heads over one kv head) and internlm2-20b
                (GQA, 48 over 8) at published widths, each in turn: one
                model drawn on the card (20 of granite's 52 layers, 12 of
                internlm2's 48) and one engine with rows for every token
                serve prefill_32k (batch 1: 1 warm-up and 3 timed
                requests, layer 0's attention on every query row against
                the plain formula), decode_32k (batch cut to 32 and 16: 3
                warm-up and 10 timed steps from a filled cache) and
                long_500k (the same, batch 1); then train_4k at 4 layers
                (batch 1, a fresh state, learning rate 1e-4: 2 warm-up and
                3 timed steps, 3 on one repeated batch: the loss falls; layer 0's attention
                gradients on every row against the plain backward); each
                line with its cuts, p50, bound and share, peak beside the
                peak reckoned from the config, exact launches; one cell
                traced (granite train_4k); the flash forward and the gather
                on the prefill's recorded inputs, the flash backward, the
                gather and the scatters on the train step's (paths
                granite_prefill, granite_train, internlm2_prefill,
                internlm2_train);
     decode   — (before the LM train) qwen2.5-3b decode: the smoke
                decode_32k (S 128, B 4) and long_500k (S 256, B 1) cells,
                three steps each on the card against the CPU; at published
                widths decode_32k (S 32,768, batch cut to 32) three steps
                from the cell's fresh state (weights drawn on the card), then
                rows for every token
                imported, a prefill of 2,048 tokens whose cache a decode
                cell takes, its decode of token 2,048 held to the last
                logits of a 2,049-token prefill; decode_32k timed from a
                cache filled with seeded bf16 values (3 warm-up and 10
                timed steps from position S - 16, a torch.profiler trace,
                the cache unchanged where no step wrote); long_500k (S
                524,288, batch 1) the same; long_500k over two gloo ranks
                sharing the card (spawned at the phase's start, 262,144
                positions each, reading the parent's weights on the card
                through CUDA IPC), three steps held to the one-rank run's
                (logits, the written rows, each slice unchanged elsewhere),
                five more timed with their 109 all-reduces; the row gather
                on each path's first call against its plain version, timed
                (paths decode_32k, long_500k, decode_r0, decode_r1);
  5. a ``{"kernels": [...]}`` line: each kernel on the exact inputs the
     serve, train, prefill, MSE train and LM train paths fed it (and the
     bucketize kernel at the operator benchmark's shape too, with
     contiguous and with random column ids, each also on its cached path
     and after a 256 MB read flush, with its path counts; the slab
     gather, which no path calls, at the operator benchmark's gather shape
     and at D 128; the per-feature segment-sum pair, which no path calls
     since each dim group pools at once, on feature 0's slice of the
     group's inputs, and driven once at its op entry, counted as path
     ``csr_op``; and its id form on the GIN aggregation's inputs, path
     ``gnn_ogb``), against its plain version, timed beside the plain
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
import atexit
import contextlib
import dataclasses
import gc
import io
import json
import queue
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()  # each phase line's "t_s": seconds since the script started
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
VOCAB = 250_000             # per feature; the published 4,000,000 needs 240 GB
N_P99_REQUESTS, N_WARMUP = 20, 3
N_TRAIN_WARMUP, N_TRAIN_STEPS, N_REPEAT = 3, 5, 5
N_RM_STEPS, N_RM_REPEAT = 3, 3   # W&D, SASRec and MIND train_batch: 3 warm-up, 3 timed, 3 repeated
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
    # the same edges at the MoE archs' heads (H = Hk = 16: G = 1)
    (1, 64, 16, 16, 128, torch.bfloat16, True), (1, 127, 16, 16, 128, torch.bfloat16, True),
    (1, 129, 16, 16, 128, torch.bfloat16, True), (1, 4096, 16, 16, 128, torch.bfloat16, True),
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
# The train driver (repro_torch.launch.train) at published widths, its vocab
# cut so that the engine (0.78 M rows: emb, m and v, about 1.2 GB)
# checkpoints in seconds; the ColumnIO table holds 8 batches (loop mode)
DRIVER_VOCAB, DRIVER_BATCH, DRIVER_ROWS = 20_000, 8_192, 65_536
DRIVER_STEPS, DRIVER_PREEMPT_STEPS, DRIVER_SIGTERM_AT = 40, 30, 15
DRIVER_CRASH_STEPS, DRIVER_CRASH_AT = 12, 6
# The LM CLI's crash and resume (qwen2.5-3b at smoke widths, batch 2 x 32
# tokens, every step saved): the resumed losses bit-equal to an
# uninterrupted run's
LM_CLI = ["--arch", "qwen2.5-3b", "--batch", "2", "--seq-len", "32"]
LM_CLI_STEPS, LM_CLI_CRASH_AT = 6, 4
# The tiered train (full_tiered_train): dlrm-mlperf train_batch at published
# widths over a device tier of 524,288 rows (the 2.4 M rows live after 12
# steps would fill it 4.6 times), 8 steps, the kernels measured at step 4's
# demote and promote, the stale spill at step 6; the online window's first
# window, card against CPU: within 1e-5 in FP32, and in the example's MIXED
# (bf16 sums in another order) within 8e-4, set between the largest of four sound dense seeds
# (3.51e-4) and the same run in the other compute type (1.74e-3, the fault
# of a card path that ignores MIXED), which each run also holds above it
# (scripts/window_precision_spread.py)
TIER_ROWS, TIER_STEPS, TIER_MID_STEP, TIER_EVICT_AT = 524_288, 8, 4, 6
# The delta checkpoints (delta_ckpt) at published widths, vocab 10,000 and
# batch 1,024 (two steps dirty about 7.4% of the rows, under the 10% the
# check asks): a row for each of the 26 x 10,000 ids the vocab gives (0.26 M
# rows: emb, m and v, 0.4 GB), the Trainer from step 1,000 with a save every 2 steps over 12
# steps (a base, 4 deltas, a compaction base past depth 4, the run's final
# save), imported last uses in [0, 1,000) and one discard of the rows idle
# since before step 64 after step 1,010; a crash at each persistence site
# (4 frames a save: the 3rd frame of the 2nd save, a torn 3rd frame of the
# 3rd, the 4th manifest, the 5th HEAD), each recovery landing on the save
# before; a tiered engine of 131,072 device rows (half the rows) for 4 more
# steps
DELTA_START, DELTA_STEPS, DELTA_EVERY, DELTA_EVICT_AT, DELTA_CUTOFF, DELTA_MAX_DEPTH = 1_000, 12, 2, 10, 64, 4
DELTA_CHAOS = "crash@frame:7,torn@frame:14,crash@manifest:4,crash@head:5"
DELTA_RECOVERED = [1_002, 1_004, 1_006, 1_008]
DELTA_VOCAB, DELTA_BATCH, DELTA_TIER_ROWS, DELTA_TIER_STEPS = 10_000, 1_024, 131_072, 4
DELTA_CLI_STEPS, DELTA_CLI_CRASH_AT = 12, 6
WINDOW_LOSS_TOL, MIXED_WINDOW_LOSS_TOL = 1e-5, 8e-4
WINDOWS = 2  # the online window example's main() over 2 of its 5 windows
# The multi-rank phase: dlrm-mlperf train_batch (batch 65,536) at published
# widths over two gloo ranks sharing the one card (host-staged all_to_alls),
# each holding half the table, against the one-rank cell on the same global
# batches, with two serve_p99 requests (batch 512) over both ranks after
# the first step. Both runs in FP32 (the cells' MIXED set to FP32, TF32
# off). What a fault would move is held after the first step, where the
# runs differ only by summation order: each rank's rows' update from their
# initial values, their Adam moments and the dense params' update, each as
# the norm of its difference from the one-rank run's over the norm of the
# one-rank run's (a rank that skipped its sparse update, or summed its row
# gradients at another scale, is off by 1 or more), and the dense params
# bit-equal across the ranks (a rank that stepped with its unsummed local
# gradient would differ); losses and logits as the FP32 cell tests hold
# them. After the last step only the ids, owners and last uses are held:
# Adam on these noise-dominated gradients (random labels) grows any
# rounding step by step, so the values' drift is reported beside that of
# the one-rank run with its dense params perturbed by MR_PERTURB (about an
# FP32 rounding) after its first step
MR_RANKS, MR_WARMUP, MR_STEPS, MR_SERVE, MR_NCCL_STEPS = 2, 1, 2, 2, 3
MR_SEED = 40_000
MR_REL_TOL = 1e-4
MR_PERTURB = 1e-7
MR_FP32_TOL = dict(rtol=0.0, atol=1e-5)
MR_TIMEOUT_S = 900.0
MR_PER_STEP = {"fused_gather.gather_rows": 4, "segment_reduce.segment_sum_csr_group": 1,
               "segment_reduce.segment_expand_csr_group": 1, "fused_scatter.scatter_add_rows": 3}
DRIVER_PER_STEP = {  # launches a step on the dlrm-mlperf train path
    "fused_gather.gather_rows": 4, "segment_reduce.segment_sum_csr_group": 1,
    "segment_reduce.segment_expand_csr_group": 1, "fused_scatter.scatter_add_rows": 3,
    "segment_reduce.segment_sum": 0, "segment_reduce.segment_expand_csr": 0,
    "fused_gather.gather_rows_slab": 0, "flash_attention.flash_fwd": 0, "flash_attention.flash_bwd": 0,
    "fused_transform.fused_bucketize": 0, "sequence_tile.sequence_tile": 0, "sequence_tile.sequence_untile": 0}
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


_CHILDREN: list = []  # the CLI processes started (``cli_process``)


def cli_process(cmd: list, env: dict) -> subprocess.Popen:
    """A fresh process of the train driver's CLI, its output piped; one
    still running when this script exits (a phase failed beside it) is
    killed then."""
    p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(p)
    return p


@atexit.register
def _kill_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def kernel_counts() -> dict:
    """Each kernel wrapper's launch count in this process."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_gather import ops as fg_ops
    from repro_torch.kernels.fused_scatter import ops as fs_ops
    from repro_torch.kernels.fused_transform import ops as ft_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    from repro_torch.kernels.sequence_tile import ops as st_ops

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


def reset_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_gather import ops as fg_ops
    from repro_torch.kernels.fused_scatter import ops as fs_ops
    from repro_torch.kernels.fused_transform import ops as ft_ops
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    from repro_torch.kernels.sequence_tile import ops as st_ops

    fg_ops.LAUNCHES = fg_ops.SLAB_LAUNCHES = sr_ops.LAUNCHES = sr_ops.LAUNCHES_BWD = 0
    sr_ops.GROUP_LAUNCHES = sr_ops.GROUP_LAUNCHES_BWD = 0
    fs_ops.LAUNCHES_ADD = fs_ops.LAUNCHES_SET = fa_ops.LAUNCHES = fa_ops.BWD_LAUNCHES = 0
    ft_ops.LAUNCHES = st_ops.LAUNCHES = st_ops.BWD_LAUNCHES = 0


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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


def _attention_layer0(fa_ops, fa_ref, q0, k0, v0, what: str, rows: int = PLAIN_ROWS) -> dict:
    """Layer 0's attention of a long prefill on every query row against the
    plain formula (in pieces of ``rows`` query rows: its whole (H, T, T)
    score tensor would take 68 GB at T 32,768 and 16 heads), and what a
    zero output or one from another kv head (the heads reversed; None with
    one kv head) would read; checked."""
    o0, lse0 = fa_ops.flash_fwd(q0, k0, v0)
    want_o, want_l = plain_flash_chunked(fa_ref, q0, k0, v0, rows)
    layer0 = {"max_abs_o": float(want_o.float().abs().max()),
              "o_max_abs_err": float((o0.float() - want_o.float()).abs().max()),
              "o_err_over_tol": flash_excess(o0, want_o, q0.dtype),
              "lse_max_abs_err": float((lse0 - want_l).abs().max()),
              "zero_output_err_over_tol": flash_excess(torch.zeros_like(want_o), want_o, q0.dtype),
              "other_kv_head_err_over_tol": None}
    del o0
    if k0.shape[2] > 1:
        wrong_o, _ = plain_flash_chunked(fa_ref, q0, k0.flip(2), v0.flip(2), rows)
        layer0["other_kv_head_err_over_tol"] = flash_excess(wrong_o, want_o, q0.dtype)
    check(layer0["o_err_over_tol"] <= 1.0 and torch.allclose(lse0, want_l, rtol=LSE_TOL, atol=LSE_TOL),
          f"{what} layer 0 attention {layer0}")
    check(layer0["zero_output_err_over_tol"] > 1.0
          and (layer0["other_kv_head_err_over_tol"] is None or layer0["other_kv_head_err_over_tol"] > 1.0),
          f"the {what} layer 0 check cannot tell a wrong output: {layer0}")
    return layer0


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


def card_model(cfg, dev):
    """A transformer at ``cfg``'s widths, built and drawn on the card from
    a CUDA generator seeded SEED with the package's law
    (``transformer.init``'s ``gen``): well under a second where the
    package's CPU draw of a full-width model takes 20-45 s."""
    from repro_torch.models import transformer as tfm

    return tfm.init(cfg, device=dev, gen=torch.Generator(device=dev).manual_seed(SEED))


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
    from repro_torch.launch.common import CellOptions, local_view
    from repro_torch.optim import adamw

    counts, reset_counts = kernel_counts, reset_kernel_counts

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

    # ------------------- 3 smoke Wide & Deep, SASRec, MIND and retrieval, card vs CPU
    smoke_models_phase(rng)

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
    emb = torch.randn((n_rows, mcfg.embed_dim), generator=torch.Generator(device=dev).manual_seed(SEED),
                      device=dev).mul_(0.05)  # drawn on the card: the host draw took 8-10 s
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

    def recorder(mod, fn_name, whole: bool = False, every: bool = False):
        """Wraps ``mod.fn_name`` so that, while ``phase["name"]`` is set, it
        keeps copies of its first call's inputs under (fn_name, phase), or
        with ``every`` of each call's under (fn_name, phase, call index).
        Returns the function it wrapped."""
        fn, calls = getattr(mod, fn_name), {}

        def wrapper(*args, **kw):
            name = phase["name"]
            if name and every:
                calls[name] = i = calls.get(name, -1) + 1
                recorded[(fn_name, name, i)] = ([_keep(a, whole) for a in args], kw)
            elif name and (fn_name, name) not in recorded:
                recorded[(fn_name, name)] = ([_keep(a, whole) for a in args], kw)
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
    # the cell's init_state, its weights drawn on the card (``card_model``)
    pstate = {"step": torch.zeros((), dtype=torch.int32, device=dev), "dense": card_model(lm_cfg, dev),
              "sparse": pre.engine.init_state()}
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
    layer0 = _attention_layer0(fa_ops, fa_ref, *recorded[("flash_attention", "prefill")][0], "prefill")
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

    # --------------------------- 4 the train driver (repro_torch.launch.train)
    driver_launches = train_driver_phase(counts, reset_counts)
    for e in entries:
        e["launches_by_path"]["train_driver"] = driver_launches[e["name"]]
    torch.cuda.empty_cache()

    # ----------------- 4 the tiered train at full width, and the online window
    device_info = {"device": name, "nvidia_smi": smi}
    tiered_launches = tiered_train_phase(counts, reset_counts, phase, recorded, recorder,
                                         {e["name"]: e for e in entries}, dev, arch, arch.shape("train_batch")["batch"],
                                         device_info)
    window_launches = online_window_phase(counts, reset_counts, dev, device_info, n_windows=WINDOWS)
    for e in entries:
        e["launches_by_path"].update(tiered_train=tiered_launches[e["name"]],
                                     online_window=window_launches[e["name"]])
    torch.cuda.empty_cache()

    # ------------------------------------- 4 delta checkpoints and crash recovery
    delta_arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, vocab_per_feature=DELTA_VOCAB))
    delta_launches = delta_ckpt_phase(counts, reset_counts, phase, recorded, recorder,
                                      {e["name"]: e for e in entries}, dev, delta_arch, DELTA_BATCH, device_info)
    for e in entries:
        e["launches_by_path"]["delta_ckpt"] = delta_launches[e["name"]]
    torch.cuda.empty_cache()

    # ------- 4 Wide & Deep, SASRec and MIND at published widths, and retrieval
    recsys_launches = recsys_models_phase(counts, reset_counts, phase, recorded, recorder,
                                          {e["name"]: e for e in entries}, dev, device_info)
    for e in entries:
        e["launches_by_path"]["recsys_models"] = recsys_launches[e["name"]]
    torch.cuda.empty_cache()

    # --------- 4 the multi-rank exchange: two gloo ranks sharing the card
    mr_launches = multi_rank_phase(arch, dev, device_info, {e["name"]: e for e in entries})
    for e in entries:
        e["launches_by_path"]["multi_rank"] = mr_launches[e["name"]]
    torch.cuda.empty_cache()

    # ------------ 4 the GNN family (gin-tu): smoke, published widths, two ranks
    gnn_launches = gnn_phase(counts, reset_counts, phase, recorded, recorder, {e["name"]: e for e in entries}, dev,
                             device_info)
    for e in entries:
        e["launches_by_path"]["gnn"] = gnn_launches[e["name"]]
    torch.cuda.empty_cache()

    # ------------- 4 LM decode (qwen2.5-3b decode_32k and long_500k), two ranks
    dec_launches = decode_phase(counts, reset_counts, phase, recorded, recorder, {e["name"]: e for e in entries},
                                dev, device_info)
    for e in entries:
        e["launches_by_path"]["decode"] = dec_launches[e["name"]]
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4 full-width LM train
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()  # what earlier phases still hold: near zero
    check(start_bytes < (1 << 30), f"{start_bytes} bytes still allocated before the LM train phase")
    recorder(fa_ops, "flash_attention")  # layer 0's forward: the step's first call
    for fn_name in ("scatter_add_rows", "scatter_set_rows"):  # D 2,048; the table (2.5 GB) kept as it is
        real[fn_name] = recorder(fs_ops, fn_name)
    real["gather_rows"] = recorder(fg_ops, "gather_rows")  # the step's first: the token rows' fetch

    def record_last_bwd(*args, **kw):  # layer 0's backward: the step's last call
        if phase["name"]:
            recorded[("flash_bwd", phase["name"])] = ([_keep(a, False) for a in args], kw)
        return real["flash_bwd"](*args, **kw)

    real["flash_bwd"] = fa_ops.flash_bwd
    fa_ops.flash_bwd = record_last_bwd
    try:
        lline, lm_launches, lstate = _lm_train(qwen2_5_3b.ARCH, None, CellOptions(), dev, counts, reset_counts,
                                               phase, "lm_train", N_LM_WARMUP, N_LM_STEPS, 40_000,
                                               repeat=N_LM_REPEAT)
    finally:
        fa_ops.flash_attention, fa_ops.flash_bwd = real["flash_attention"], real["flash_bwd"]
        fs_ops.scatter_add_rows, fs_ops.scatter_set_rows = real["scatter_add_rows"], real["scatter_set_rows"]
        fg_ops.gather_rows = real["gather_rows"]
    del lstate
    torch.cuda.empty_cache()
    bargs = recorded.pop(("flash_bwd", "lm_train"))[0]
    lm_layer0 = _layer0_attention(real["flash_bwd"], fa_ref, bargs, "lm_train")
    emit({**lline, "allocated_at_phase_start_bytes": start_bytes, "layer0_attention_grads_vs_plain": lm_layer0,
          **device_info})

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
    torch.cuda.empty_cache()

    # ------- 4 the MoE family (qwen2-moe-a2.7b, moonshot-v1-16b-a3b) serving
    moe_launches = moe_phase(counts, reset_counts, phase, recorded, recorder, by_name, flash_at, dev, device_info)

    # ---------- 4 the MoE family trains (train_4k of qwen2-moe and moonshot)
    mt_launches, mt_bwd = moe_train_phase(counts, reset_counts, phase, recorded, recorder, by_name, flash_at, dev,
                                          device_info)

    # ---------- 4 the 20B dense archs (granite-20b, internlm2-20b) serve and train
    l20_launches, l20_bwd = lm20b_phase(counts, reset_counts, phase, recorded, recorder, by_name, flash_at, dev,
                                        device_info)
    check(not recorded, f"recorded inputs left unmeasured: {list(recorded)}")
    for e in entries:
        e["launches_by_path"]["lm_train"] = lm_launches[e["name"]]
        e["launches_by_path"]["moe"] = moe_launches[e["name"]]
        e["launches_by_path"]["moe_train"] = mt_launches[e["name"]]
        e["launches_by_path"]["lm20b"] = l20_launches[e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    fwd_by_path = {"csr_op": csr_launches["flash_attention.flash_fwd"],
                   "gnn": gnn_launches["flash_attention.flash_fwd"],
                   "decode": dec_launches["flash_attention.flash_fwd"],
                   "delta_ckpt": delta_launches["flash_attention.flash_fwd"],
                   "recsys_models": recsys_launches["flash_attention.flash_fwd"],
                   "multi_rank": mr_launches["flash_attention.flash_fwd"],
                   "tiered_train": tiered_launches["flash_attention.flash_fwd"],
                   "online_window": window_launches["flash_attention.flash_fwd"],
                   "mse_loop": loop_launches["flash_attention.flash_fwd"],
                   "train_driver": driver_launches["flash_attention.flash_fwd"],
                   "slab_op": slab_launches["flash_attention.flash_fwd"],
                   "serve": launches["flash_attention.flash_fwd"],
                   "train": train_launches["flash_attention.flash_fwd"],
                   "prefill": prefill_launches["flash_attention.flash_fwd"],
                   "mse_train": mse_launches["flash_attention.flash_fwd"],
                   "lm_train": lm_launches["flash_attention.flash_fwd"],
                   "moe": moe_launches["flash_attention.flash_fwd"],
                   "moe_train": mt_launches["flash_attention.flash_fwd"],
                   "lm20b": l20_launches["flash_attention.flash_fwd"]}
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
                   "gnn": gnn_launches["flash_attention.flash_bwd"],
                   "decode": dec_launches["flash_attention.flash_bwd"],
                   "delta_ckpt": delta_launches["flash_attention.flash_bwd"],
                   "recsys_models": recsys_launches["flash_attention.flash_bwd"],
                   "multi_rank": mr_launches["flash_attention.flash_bwd"],
                   "tiered_train": tiered_launches["flash_attention.flash_bwd"],
                   "online_window": window_launches["flash_attention.flash_bwd"],
                   "mse_loop": loop_launches["flash_attention.flash_bwd"],
                   "train_driver": driver_launches["flash_attention.flash_bwd"],
                   "slab_op": slab_launches["flash_attention.flash_bwd"],
                   "serve": launches["flash_attention.flash_bwd"],
                   "train": train_launches["flash_attention.flash_bwd"],
                   "prefill": prefill_launches["flash_attention.flash_bwd"],
                   "mse_train": mse_launches["flash_attention.flash_bwd"],
                   "lm_train": lm_launches["flash_attention.flash_bwd"],
                   "moe": moe_launches["flash_attention.flash_bwd"],
                   "moe_train": mt_launches["flash_attention.flash_bwd"],
                   "lm20b": l20_launches["flash_attention.flash_bwd"]}
    entries.append({
        "name": "flash_attention.flash_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:210", "ok": True,
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path, "main_path": "lm_train",
        "max_abs_err": max(lm_layer0[f"{n}_max_abs_err"] for n in GRAD_NAMES),
        "max_err": max(lm_layer0[f"{n}_max_abs_err"] for n in GRAD_NAMES), "kernel_ms": bwd["ms"],
        "library_call": "torch.autograd.grad of F.scaled_dot_product_attention(is_causal=True), kv expanded",
        **bwd, "bf16_route": "tensor cores (wgmma, TMA)", **flash_build["flash_attention.flash_bwd"]})
    entries[-1]["at"]["fp32"] = bwd_fp32["at"]["fp32"]
    entries[-1]["at"]["moe_train"] = mt_bwd
    entries[-1]["at"].update(l20_bwd)
    entries[-1]["max_abs_err"] = max(entries[-1]["max_abs_err"], mt_bwd["max_abs_err"],
                                     *(a["max_abs_err"] for a in l20_bwd.values()))
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})


def _step_records(path: Path) -> dict:
    from repro_torch.obs import read_jsonl

    return {r["step"]: r for r in read_jsonl(path) if r.get("type") == "step" and "metrics" in r}


def _shares(recs: list) -> dict:
    total = sum(r["dur_s"] for r in recs)
    return {ph: sum(r["spans"].get(ph, 0.0) for r in recs) / total for ph in ("data_wait", "device_step")}


def train_driver_phase(counts, reset_counts) -> dict:
    """The twin of launch/train.py on the card: (a) its run() at published
    widths over a ColumnIO table under the autoscaler, with telemetry, the
    aggregator and the Prometheus endpoint; (b) a SIGTERM preemption and a
    resume against an uninterrupted run; (c) an injected crash of its CLI in
    a fresh process, exit 42, and a resume; (d) the two benchmark twins.
    Returns the launch counts of (a)."""
    import os
    import signal

    from repro_torch import obs as t_obs
    from repro_torch.benchmarks import table2_autoscale, table4_obs
    from repro_torch.checkpoint import saver as saver_lib
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.base import ShapeCell
    from repro_torch.io.ragged import Ragged
    from repro_torch.launch import recsys_cell, train as drv

    phase_t0 = time.perf_counter()
    base = ROOT / "build" / "train_driver"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    arch = dataclasses.replace(dlrm_mlperf.ARCH, model=dataclasses.replace(
        dlrm_mlperf.ARCH.model, vocab_per_feature=DRIVER_VOCAB))
    mcfg = arch.model
    flags = ["--arch", "dlrm-mlperf", "--device", "cuda", "--batch", str(DRIVER_BATCH), "--log-every", "1"]

    def run(extra: list):
        args = drv.build_parser().parse_args(flags + extra)
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res, ctl = drv.run(args, arch)
        return res, ctl, printed.getvalue()

    # (a) the ColumnIO table under the autoscaler, with the observability
    tel = base / "a.jsonl"
    tel.touch()  # the aggregator tails the files that exist when it starts
    t_obs.reset_default_registry()  # the run's own registry (the Trainer's and the loader's)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res, ctl, printed = run(["--steps", str(DRIVER_STEPS), "--data-dir", str(base / "table"),
                             "--data-rows", str(DRIVER_ROWS), "--io-threads", "1", "--autoscale",
                             "--autoscale-max", "8", "--telemetry", str(tel), "--snapshot-every", "5",
                             "--worker-id", "w0", "--aggregate", str(tel), "--prometheus-port", "0"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    recs = _step_records(tel)
    steps = [recs[k] for k in sorted(recs)]
    losses = [r["metrics"]["loss"] for r in steps]
    overflow = {k: sum(r["metrics"][k] for r in steps) for k in steps[0]["metrics"] if "overflow" in k}
    text = t_obs.render(res.registry)
    problems = t_obs.validate_exposition(text)
    agg = ctl.aggregator.refresh()
    per_step = {k: v / DRIVER_STEPS for k, v in launches.items()}
    train_s = sum(r["dur_s"] for r in steps)
    emit({"phase": "train_driver_run", "entry": "repro_torch.launch.train.run", "arch": arch.arch_id,
          "widths": {"n_dense": mcfg.n_dense, "n_sparse": mcfg.n_sparse, "embed_dim": mcfg.embed_dim,
                     "bot_mlp": mcfg.bot_mlp, "top_mlp": mcfg.top_mlp},
          "reduced": {"vocab_per_feature": [4_000_000, DRIVER_VOCAB], "batch": [65_536, DRIVER_BATCH],
                      "devices": [256, 1]},
          "batch": DRIVER_BATCH, "table_rows": DRIVER_ROWS, "steps": len(steps), "io_threads_start": 1,
          "autoscale_actions": [[st, str(a)] for st, a in ctl.actions_log],
          "readers_final": ctl.loader.n_readers, "loader_overflow": ctl.loader.overflow,
          "engine_overflow": overflow, "loss_first": losses[0], "loss_last": losses[-1],
          "shares_first10": _shares(steps[:10]), "shares_last10": _shares(steps[-10:]),
          "steps_per_s": len(steps) / train_s, "run_s": run_s,
          "step_ms_p50": float(np.percentile([r["dur_s"] * 1e3 for r in steps], 50)),
          "launches": launches, "launches_per_step": per_step, "launches_per_step_want": DRIVER_PER_STEP,
          "exposition_lines": len(text.splitlines()), "exposition_problems": problems,
          "autoscale_readers_gauge": res.registry.get("autoscale/readers").value,
          "agg_workers": agg.gauge("agg/workers").value,
          "agg_skew": {k: v for k, v in agg.snapshot().items() if k.startswith("agg/skew/")},
          "printed_tail": printed.strip().splitlines()[-4:], "part_s": time.perf_counter() - phase_t0})
    check(len(steps) == DRIVER_STEPS and res.steps_run == DRIVER_STEPS, f"driver ran {len(steps)} steps")
    check(all(np.isfinite(losses)), f"driver losses {losses}")
    check(all(v == 0 for v in overflow.values()) and ctl.loader.overflow == 0,
          f"driver overflow {overflow} {ctl.loader.overflow}")
    check(not problems and "recis_autoscale_readers " in text, f"exposition problems {problems[:5]}")
    check(agg.gauge("agg/workers").value == 1, "the aggregator saw no worker snapshot")
    check(all(launches[k] == v * DRIVER_STEPS for k, v in DRIVER_PER_STEP.items())
          and launches["fused_scatter.scatter_set_rows"] > 0, f"driver launches {launches}")
    del res, ctl
    torch.cuda.empty_cache()
    # where the train step's time goes: the cell's step on host batches
    # (the loader's), the copy to the card inside the step, in a trace
    cell = recsys_cell.build(arch, ShapeCell("train_batch", "train", {"batch": DRIVER_BATCH}), device="cuda")
    held = {"state": cell.init_state()}

    def step(b):
        held["state"], _ = cell.step_fn(held["state"], b)

    host_batches = [{k: Ragged(v.values.cpu(), v.row_splits.cpu()) for k, v in cell.make_batch(s).items()}
                    for s in range(6)]
    step(host_batches[0])
    emit({**profile_requests("train_driver_step", step, host_batches[1:]), "batch": DRIVER_BATCH,
          "batches_on": "host"})
    del cell, held, host_batches
    torch.cuda.empty_cache()

    # (c)'s first two processes start now and run beside (b): an injected
    # crash of the CLI in a fresh process (exit 42), then a resume, against
    # an uninterrupted run of the CLI, at smoke width. Every step is saved
    # and a save waits for the one before it, so the crash at step 6 leaves
    # step 4 committed for certain, and step 5 perhaps.
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-mlperf", "--device", "cuda",
           "--steps", str(DRIVER_CRASH_STEPS), "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ck_c = base / "ckpt_c"

    def cli(extra: list) -> subprocess.Popen:
        return cli_process(cmd + extra, env)

    t_cli = time.perf_counter()
    procs = [cli(["--telemetry", str(base / "c_u.jsonl")]),
             cli(["--chaos-schedule", f"crash@step:{DRIVER_CRASH_AT}", "--ckpt-dir", str(ck_c),
                  "--ckpt-every", "1", "--telemetry", str(base / "c_a.jsonl")])]
    # (e)'s first two: the LM CLI's crash and its uninterrupted run
    lm_cmd = [sys.executable, "-m", "repro_torch.launch.train", *LM_CLI, "--device", "cuda",
              "--steps", str(LM_CLI_STEPS), "--log-every", "1"]
    ck_l = base / "ckpt_lm"
    lm_procs = [cli_process(lm_cmd + ["--telemetry", str(base / "l_u.jsonl")], env),
                cli_process(lm_cmd + ["--chaos-schedule", f"crash@step:{LM_CLI_CRASH_AT}", "--ckpt-dir", str(ck_l),
                                      "--ckpt-every", "1", "--telemetry", str(base / "l_a.jsonl")], env)]

    # (b) preemption: SIGTERM at step 15 (final checkpoint), then a resume
    # to 30, against an uninterrupted run on the same synthetic batches
    ck = base / "ckpt_b"
    sigterm_before = signal.getsignal(signal.SIGTERM)
    res_u, _, _ = run(["--steps", str(DRIVER_PREEMPT_STEPS), "--telemetry", str(base / "b_u.jsonl")])
    del res_u
    torch.cuda.empty_cache()
    res_p, _, printed_p = run(["--steps", str(DRIVER_PREEMPT_STEPS), "--ckpt-dir", str(ck), "--ckpt-every", "10",
                               "--chaos-schedule", f"sigterm@step:{DRIVER_SIGTERM_AT}",
                               "--telemetry", str(base / "b_p.jsonl")])
    preempted, ran_p = res_p.preempted, res_p.steps_run
    del res_p
    torch.cuda.empty_cache()
    check(signal.getsignal(signal.SIGTERM) == sigterm_before, "the SIGTERM handler was not restored")
    saved = saver_lib.latest_step(ck)
    t0 = time.perf_counter()
    # no in-run save: only the final one (each save of the 3 GB state takes seconds)
    res_r, _, printed_r = run(["--steps", str(DRIVER_PREEMPT_STEPS), "--ckpt-dir", str(ck), "--ckpt-every", "0",
                               "--resume", "--telemetry", str(base / "b_r.jsonl")])
    resumed_from = res_r.resumed_from
    del res_r
    torch.cuda.empty_cache()
    lu, lp, lr = ({k: r["metrics"]["loss"] for k, r in _step_records(base / f).items()}
                  for f in ("b_u.jsonl", "b_p.jsonl", "b_r.jsonl"))
    recs_p = t_obs.read_jsonl(base / "b_p.jsonl")  # in-step saves, then the final one
    ckpt_s = ([r["spans"]["checkpoint"] for r in recs_p if r.get("type") == "step" and "checkpoint" in r["spans"]]
              + [r["dur_s"] for r in recs_p if r.get("type") == "span" and r.get("name") == "checkpoint"])
    steps_u = _step_records(base / "b_u.jsonl").values()
    later = range(DRIVER_SIGTERM_AT + 1, DRIVER_PREEMPT_STEPS + 1)
    b_err = max(abs(lr[k] - lu[k]) / abs(lu[k]) for k in later) if sorted(lr) == list(later) else None
    emit({"phase": "train_driver_preempt", "widths": "as train_driver_run", "batch": DRIVER_BATCH,
          "steps": DRIVER_PREEMPT_STEPS, "sigterm_at": DRIVER_SIGTERM_AT, "preempted": preempted,
          "steps_run_preempted": ran_p, "checkpoint_step": saved, "resumed_from": resumed_from,
          "losses_uninterrupted": [lu[k] for k in sorted(lu)], "losses_resumed": [lr[k] for k in sorted(lr)],
          "resumed_max_rel_err": b_err, "resumed_bit_equal": all(lr.get(k) == lu[k] for k in later),
          "tolerance": "resumed losses within 1e-5 relative of the uninterrupted run",
          "step_ms_p50_synthetic_batches": float(np.percentile([r["dur_s"] * 1e3 for r in steps_u], 50)),
          "checkpoint_span_s": ckpt_s,
          "printed_preempted": [ln for ln in printed_p.splitlines() if ln.startswith("ran ")],
          "resume_run_s": time.perf_counter() - t0, "part_s": time.perf_counter() - phase_t0})
    check(preempted and ran_p == DRIVER_SIGTERM_AT and "PREEMPTED" in printed_p, f"not preempted: {ran_p}")
    check(saved == DRIVER_SIGTERM_AT, f"the preemption checkpoint is at step {saved}")
    check(sorted(lp) == list(range(1, DRIVER_SIGTERM_AT + 1))
          and max(abs(lp[k] - lu[k]) / abs(lu[k]) for k in lp) <= 1e-5,
          "the preempted run differs from the uninterrupted one before the signal")
    check(resumed_from == DRIVER_SIGTERM_AT and "resumed from step" in printed_r, f"resumed from {resumed_from}")
    check(b_err is not None and b_err <= 1e-5, f"resumed losses differ by {b_err}")
    shutil.rmtree(ck, ignore_errors=True)

    # (c) the CLI's crash and its uninterrupted run (started before (b)),
    # then the resume
    (out_u, err_u), (out_a, err_a) = (p.communicate(timeout=300) for p in procs)
    resume = cli(["--resume", "--ckpt-dir", str(ck_c), "--ckpt-every", "1", "--telemetry", str(base / "c_r.jsonl")])
    (lo_u, le_u), (lo_a, le_a) = (p.communicate(timeout=300) for p in lm_procs)
    lm_resume = cli_process(lm_cmd + ["--resume", "--ckpt-dir", str(ck_l), "--telemetry", str(base / "l_r.jsonl")],
                            env)
    out_r, err_r = resume.communicate(timeout=300)
    cli_s = time.perf_counter() - t_cli
    rcs = [procs[0].returncode, procs[1].returncode, resume.returncode]
    cu, ca, cr = ({k: r["metrics"]["loss"] for k, r in _step_records(base / f).items()}
                  for f in ("c_u.jsonl", "c_a.jsonl", "c_r.jsonl"))
    c_start = min(cr) - 1 if cr else None

    def c_err(got: dict, want_steps: range):
        return (max(abs(got[k] - cu[k]) / abs(cu[k]) for k in want_steps)
                if sorted(got) == list(want_steps) and set(want_steps) <= set(cu) else None)

    err_crashed = c_err(ca, range(1, DRIVER_CRASH_AT))
    err_resumed = c_err(cr, range(c_start + 1, DRIVER_CRASH_STEPS + 1)) if c_start is not None else None
    emit({"phase": "train_driver_crash", "cli": " ".join(cmd[1:]), "width": "smoke (batch 64)",
          "crash_at": DRIVER_CRASH_AT, "ckpt_every": 1, "returncodes": rcs,
          "crash_printed": out_a.strip().splitlines()[-1:], "resumed_from": c_start,
          "losses_uninterrupted": [cu[k] for k in sorted(cu)], "losses_crashed": [ca[k] for k in sorted(ca)],
          "losses_resumed": [cr[k] for k in sorted(cr)], "crashed_steps_max_rel_err": err_crashed,
          "resumed_steps_max_rel_err": err_resumed,
          "bit_equal": all(d.get(k) == cu.get(k) for d in (ca, cr) for k in d),
          "three_processes_s": cli_s, "three_processes_s_note": "the first two beside (b)",
          "part_s": time.perf_counter() - phase_t0,
          "stderr_tail": [e.strip().splitlines()[-3:] for e in (err_u, err_a, err_r) if e.strip()]})
    check(rcs == [0, drv.CHAOS_EXIT, 0], f"CLI return codes {rcs}: {err_a[-2000:]}")
    check(f"CHAOS: chaos: crash@step:{DRIVER_CRASH_AT}" in out_a, "the crash was not the injected one")
    check(c_start in (DRIVER_CRASH_AT - 2, DRIVER_CRASH_AT - 1) and f"resumed from step {c_start}" in out_r,
          f"the CLI resumed from {c_start}")
    check(err_crashed is not None and err_crashed <= 1e-5, f"the crashed CLI's steps differ by {err_crashed}")
    check(err_resumed is not None and err_resumed <= 1e-5, f"the resumed CLI's steps differ by {err_resumed}")

    # (e) the LM CLI: its checkpoints hold the LM train state (the
    # reference's stacked-layer tree); the crashed run's and the resumed
    # run's losses bit-equal to the uninterrupted run's
    lo_r, le_r = lm_resume.communicate(timeout=300)
    lm_rcs = [lm_procs[0].returncode, lm_procs[1].returncode, lm_resume.returncode]
    lu_, la_, lr_ = ({k: r["metrics"]["loss"] for k, r in _step_records(base / f).items()}
                     for f in ("l_u.jsonl", "l_a.jsonl", "l_r.jsonl"))
    l_start = min(lr_) - 1 if lr_ else None
    emit({"phase": "train_driver_lm_crash", "cli": " ".join(lm_cmd[1:]), "width": "smoke",
          "crash_at": LM_CLI_CRASH_AT, "ckpt_every": 1, "returncodes": lm_rcs,
          "crash_printed": lo_a.strip().splitlines()[-1:], "resumed_from": l_start,
          "losses_uninterrupted": [lu_[k] for k in sorted(lu_)], "losses_crashed": [la_[k] for k in sorted(la_)],
          "losses_resumed": [lr_[k] for k in sorted(lr_)],
          "bit_equal": bool(lr_) and all(d.get(k) == lu_.get(k) for d in (la_, lr_) for k in d),
          "part_s": time.perf_counter() - phase_t0,
          "stderr_tail": [e.strip().splitlines()[-3:] for e in (le_u, le_a, le_r) if e.strip()]})
    check(lm_rcs == [0, drv.CHAOS_EXIT, 0], f"LM CLI return codes {lm_rcs}: {le_a[-2000:]}")
    check(f"CHAOS: chaos: crash@step:{LM_CLI_CRASH_AT}" in lo_a, "the LM crash was not the injected one")
    check(l_start in (LM_CLI_CRASH_AT - 2, LM_CLI_CRASH_AT - 1) and f"resumed from step {l_start}" in lo_r,
          f"the LM CLI resumed from {l_start}")
    check(sorted(lu_) == list(range(1, LM_CLI_STEPS + 1)) and sorted(la_) == list(range(1, LM_CLI_CRASH_AT))
          and sorted(lr_) == list(range(l_start + 1, LM_CLI_STEPS + 1)), "the LM CLI's steps")
    check(all(d[k] == lu_[k] for d in (la_, lr_) for k in d), "the LM CLI's crashed or resumed losses differ")

    # (d) the benchmark twins: the autoscaler on a calibrated SimPipeline,
    # and the telemetry overhead on the MSE cell at batch 128
    t2 = table2_autoscale.run(steps=400, device="cuda", out=base / "table2_autoscale.json")
    t4 = table4_obs.run(steps=20, repeats=4, device="cuda", out=base / "table4_obs.json")
    emit({"phase": "train_driver_benchmarks", "table2_autoscale": t2, "table4_obs": t4,
          "telemetry_overhead_fraction": t4["overhead_fraction"],
          "telemetry_budget_note": "budget 0.05, reported, not gated: the MSE step at batch 128 moves by up to 30% "
                                   "between runs of the same code", "phase_s": time.perf_counter() - phase_t0})
    check(t2["fixed"]["n_actions"] == 0 and t4["base_steps_per_s"] > 0 and t4["telemetry_steps_per_s"] > 0,
          "benchmark twins")
    shutil.rmtree(base / "table", ignore_errors=True)
    return launches


# the CUDA kernel each wrapper launches, by the name the profiler gives it
def tiered_train_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, dev, arch,
                       batch: int, device_info: dict, tier_rows: int = TIER_ROWS, n_steps: int = TIER_STEPS) -> dict:
    """dlrm-mlperf ``train_batch`` with a tiered engine (a device tier of
    ``tier_rows`` rows over the host-DRAM tier) through the Trainer and the
    cell's storage hooks, against the all-device cell on the same batches:
    losses and the union export bit-equal, zero overflow and unplaceable
    ids, then ``evict_to_host`` and a last step that promotes the spilled
    rows it touches, bit-equal again, and ``evict_local`` on the all-device
    state. Each kernel's launches over the tiered run are held to what the
    store's demote and promote calls and the steps imply; the row gather
    and the scatter set are measured at a middle step's demote and promote
    shapes. Returns the tiered run's launch counts."""
    from repro_torch import obs as t_obs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.launch import recsys_cell
    from repro_torch.launch.common import CellOptions, local_view
    from repro_torch.pipelines import TrainConfig, Trainer
    from repro_torch.storage import StorageConfig

    phase_t0 = time.perf_counter()
    base = ROOT / "build" / "tiered"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    shape = ShapeCell("train_batch", "train", {"batch": batch})
    tcell = recsys_cell.build(arch, shape, CellOptions(storage=StorageConfig(policy="lru"),
                                                       storage_device_rows=tier_rows), device=dev)
    ccell = recsys_cell.build(arch, shape, device=dev)
    store = tcell.engine.storage
    gkey = f"dim{arch.model.embed_dim}"
    batches = [tcell.make_batch(30_000 + s, vocab=arch.model.vocab_per_feature) for s in range(n_steps + 1)]

    # count the store's tier moves, and record the kernels' inputs at a
    # middle step's demote and promote
    calls, at_step = {"demote": 0, "promote": 0}, {"s": 0}
    prefetch = store.prefetch

    def prefetch_at(state, eng, step):
        at_step["s"] = step
        return prefetch(state, eng, step)

    def counted(kind: str):
        fn = getattr(store, f"_{kind}")

        def wrapper(*args, **kw):
            calls[kind] += 1
            phase["name"] = f"tiered_{kind}" if at_step["s"] == TIER_MID_STEP else None
            try:
                return fn(*args, **kw)
            finally:
                phase["name"] = None
        return wrapper

    store.prefetch = prefetch_at
    store._demote, store._promote = counted("demote"), counted("promote")
    real = {"gather_rows": recorder(fg_ops, "gather_rows"),  # a demote's first: the emb read
            "scatter_set_rows": recorder(fs_ops, "scatter_set_rows", True)}  # its clear, a promote's write

    def trainer(cell, hooks, steps, tel=None):
        return Trainer(cell, TrainConfig(total_steps=steps, log_every=1, watchdog=False, anomaly=False,
                                         telemetry_path=tel), hooks=hooks, registry=t_obs.MetricsRegistry())

    tel = base / "tiered.jsonl"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr = trainer(tcell, tcell.storage_hooks, n_steps, str(tel))
    res_t = tr.run(tcell.init_state(), iter(batches[:n_steps]))
    torch.cuda.synchronize()
    tiered_s = time.perf_counter() - t0
    launches = counts()
    hist = res_t.metrics_history
    for m in hist:
        check(m[f"{gkey}/idmap_row_overflow"] == 0 and m["storage/unplaceable"] == 0
              and all(v == 0 for k, v in m.items() if "overflow" in k), f"tiered step {m['step']}: {m}")
        check(m["storage/device_rows"] <= tier_rows, f"tiered step {m['step']}: {m['storage/device_rows']} device rows")
    inserting = sum(m[f"{gkey}/idmap_inserted"] > 0 for m in hist)
    want = {k: 0 for k in launches}
    want.update({"fused_gather.gather_rows": 4 * n_steps + 3 * calls["demote"],
                 "segment_reduce.segment_sum_csr_group": n_steps,
                 "segment_reduce.segment_expand_csr_group": n_steps,
                 "fused_scatter.scatter_add_rows": 3 * n_steps,
                 "fused_scatter.scatter_set_rows": 3 * (calls["demote"] + calls["promote"] + inserting)})
    check(launches == want, f"tiered launches {launches}, expected {want} from {calls} and {inserting} inserting steps")
    check(calls["demote"] > 0 and calls["promote"] > 0, f"the tier never churned: {calls}")
    spans = _step_records(tel)

    res_c = trainer(ccell, None, n_steps).run(ccell.init_state(), iter(batches[:n_steps]))
    torch.cuda.synchronize()
    hist_c = res_c.metrics_history
    losses, losses_c = [m["loss"] for m in hist], [m["loss"] for m in hist_c]
    check(losses == losses_c, f"tiered losses {losses} differ from the all-device run's {losses_c}")

    def union(cell, state) -> dict:
        """The engine's union export, sorted by id."""
        r = cell.engine.export_rows(state["sparse"])[gkey]
        o = np.argsort(r["ids"], kind="stable")
        return {"ids": r["ids"][o], "last_use": r["last_use"][o], "emb": r["emb"][o],
                **{k: r["slots"][k][o] for k in ("m", "v")}, "n_device": r["ids"].size - store.host_rows()
                if cell is tcell else r["ids"].size, "raw_last_use": r["last_use"]}

    def same(a: dict, b: dict, what: str) -> list:
        check(a["ids"].size == b["ids"].size and np.array_equal(a["ids"], b["ids"]),
              f"{what}: {a['ids'].size} ids against {b['ids'].size}")
        differ = [k for k in ("emb", "m", "v", "last_use") if not np.array_equal(a[k], b[k])]
        check(not differ, f"{what}: {differ} differ from the all-device run's")
        return ["ids", "emb", "m", "v", "last_use"]

    ut, uc = union(tcell, res_t.state), union(ccell, res_c.state)
    compared12 = same(ut, uc, f"union export after {n_steps} steps")
    rows_live = int(ut["ids"].size)
    host = store.host[gkey]
    host_rows, host_bytes = host.n_rows, host.nbytes
    # the device rows idle since before TIER_EVICT_AT, counted in the export;
    # under LRU at this ratio the device tier holds only the last two steps'
    # rows, so a second pass spills those idle since before the last step
    dev_lu = ut["raw_last_use"][: ut["n_device"]]
    spills, before = [], 0
    for older in (TIER_EVICT_AT, n_steps):
        n_stale = int((dev_lu < older).sum())
        spills.append({"older_than": older, "counted_in_export": n_stale - before})
        before = n_stale
    del ut, uc
    state_t = res_t.state
    for x in spills:
        state_t["sparse"], emet = tcell.engine.evict_to_host(state_t["sparse"], x["older_than"])
        x["spilled"] = emet["spilled_stale"]
        check(x["spilled"] == x["counted_in_export"],
              f"evict_to_host({x['older_than']}) spilled {x['spilled']}, the export counts {x['counted_in_export']}")
    check(spills[-1]["spilled"] > 0, f"nothing idle on the device before step {n_steps}: {spills}")
    spilled_dev_after = store.device_resident()

    # the last step promotes the spilled rows it touches
    last = batches[n_steps]
    with torch.no_grad():
        eng = tcell.engine.engine_ids(tcell.ids_fn(last))[gkey]
    touched = np.unique(eng[eng != -1].cpu().numpy())
    on_host_touched = int(host.contains(touched).sum())
    tr.cfg.total_steps = n_steps + 1
    res_t2 = tr.run(state_t, iter([last]), start_step=n_steps)
    tr_c = trainer(ccell, None, n_steps + 1)
    res_c2 = tr_c.run(res_c.state, iter([last]), start_step=n_steps)
    torch.cuda.synchronize()
    m13, c13 = res_t2.metrics_history[-1], res_c2.metrics_history[-1]
    check(m13["storage/promoted"] == on_host_touched and on_host_touched > 0
          and m13["storage/unplaceable"] == 0,
          f"step {n_steps + 1} promoted {m13['storage/promoted']} of {on_host_touched} host rows it touches")
    check(m13["loss"] == c13["loss"], f"step {n_steps + 1}: loss {m13['loss']} against {c13['loss']}")
    ut, uc = union(tcell, res_t2.state), union(ccell, res_c2.state)
    compared13 = same(ut, uc, f"union export after step {n_steps + 1}")
    want_discard = int((uc["last_use"] < TIER_EVICT_AT).sum())
    check(int((ut["last_use"] < TIER_EVICT_AT).sum()) == want_discard, "stale counts of the two unions")
    del ut, uc
    fg_ops.gather_rows, fs_ops.scatter_set_rows = real["gather_rows"], real["scatter_set_rows"]  # no more records
    _, dmet = ccell.engine.evict_local(local_view(res_c2.state["sparse"]), TIER_EVICT_AT)
    check(int(dmet[f"{gkey}/evicted"]) == want_discard,
          f"evict_local discarded {int(dmet[gkey + '/evicted'])}, the export counts {want_discard}")

    # the kernels at the middle step's demote and promote shapes
    measured = {}
    for path, kname, plain, entry in (
            ("tiered_demote", "gather_rows", fg_ref.gather_rows, "fused_gather.gather_rows"),
            ("tiered_demote", "scatter_set_rows", fs_ref.scatter_set_rows, "fused_scatter.scatter_set_rows"),
            ("tiered_promote", "scatter_set_rows", fs_ref.scatter_set_rows, "fused_scatter.scatter_set_rows")):
        check((kname, path) in recorded, f"step {TIER_MID_STEP} made no {path} call")
        args, kw = recorded.pop((kname, path))
        label = f"{path}_{'read' if kname == 'gather_rows' else 'clear' if path == 'tiered_demote' else 'write'}"
        measured[label] = _measure(kname, real[kname], plain, args, kw, 20, dev)
        _add_path(by_name[entry], label, measured[label])
        del args
        torch.cuda.empty_cache()

    def pct(xs, q):
        return float(np.percentile(xs, q))

    wall_t = [m["wall_s"] * 1e3 for m in hist[1:]]
    wall_c = [m["wall_s"] * 1e3 for m in hist_c[1:]]
    pre = [spans[s]["spans"].get("pre_step", 0.0) * 1e3 for s in sorted(spans)]
    post = [spans[s]["spans"].get("post_step", 0.0) * 1e3 for s in sorted(spans)]
    dev_ms = [spans[s]["spans"].get("device_step", 0.0) * 1e3 for s in sorted(spans)]
    mcfg = arch.model
    emit({"phase": "full_tiered_train", **device_info, "arch": arch.arch_id, "batch": batch,
          "widths": {"n_dense": mcfg.n_dense, "n_sparse": mcfg.n_sparse, "embed_dim": mcfg.embed_dim,
                     "bot_mlp": mcfg.bot_mlp, "top_mlp": mcfg.top_mlp},
          "reduced": {"vocab_per_feature": [4_000_000, mcfg.vocab_per_feature], "devices": [256, 1]},
          "storage": {"policy": "lru", "device_rows": tier_rows}, "steps": n_steps,
          "loss": losses, "losses_equal_all_device": True,
          "union_export_bit_equal": {f"after_{n_steps}": compared12, f"after_{n_steps + 1}": compared13},
          "rows_live": rows_live, "host_rows": host_rows, "host_tier_bytes": host_bytes,
          "device_rows": [m["storage/device_rows"] for m in hist],
          "promoted": [m["storage/promoted"] for m in hist], "demoted": [m["storage/demoted"] for m in hist],
          "fresh": [m["storage/fresh"] for m in hist], "hit_rate": [m["storage/hit_rate"] for m in hist],
          "store_calls": calls, "inserting_steps": inserting,
          "step_ms_p50": pct(wall_t, 50), "step_ms_p99": pct(wall_t, 99), "step_ms": wall_t,
          "all_device_step_ms_p50": pct(wall_c, 50), "all_device_step_ms_p99": pct(wall_c, 99),
          "all_device_step_ms": wall_c, "step_ms_note": "Trainer wall_s of steps 2 on (step 1 warms up)",
          "pre_step_ms": pre, "post_step_ms": post, "device_step_ms": dev_ms,
          "pre_step_ms_p50": pct(pre[1:], 50), "post_step_ms_p50": pct(post[1:], 50),
          "evict_to_host": spills, "device_rows_after_evict": spilled_dev_after,
          f"step_{n_steps + 1}": {"promoted": m13["storage/promoted"], "host_rows_touched": on_host_touched,
                                  "loss": m13["loss"], "hit_rate": m13["storage/hit_rate"]},
          "evict_local_all_device": {"older_than": TIER_EVICT_AT, "evicted": int(dmet[f"{gkey}/evicted"]),
                                     "counted_in_export": want_discard},
          "kernels_at_tier_moves": {k: {x: v[x] for x in ("shape", "ms", "kernel_device_ms", "plain_ms",
                                                         "library_ms", "bound_ms", "bound_by", "host_us")}
                                    for k, v in measured.items()},
          "launches": launches, "tiered_run_s": tiered_s, "phase_s": time.perf_counter() - phase_t0})
    del res_t, res_t2, res_c, res_c2, state_t, tcell, ccell, store, batches, tr, tr_c
    gc.collect()  # the store's wrapped methods hold it in a cycle
    torch.cuda.empty_cache()
    return launches


def online_window_phase(counts, reset_counts, dev, device_info: dict, **main_kw) -> dict:
    """The twin of examples/online_window.py: its ``main()`` on the card at
    the example's settings (windows of 120 steps, eviction age 150, rows
    per shard 4,096; ``main_kw`` may cut the 5 windows), with each window's
    pre-train eval and last loss and
    each eviction's live rows checked and the launches counted (the sets 3
    for each train step whose insert placed rows); then its first window on
    the card and on the CPU, in FP32 and in the example's MIXED, each held
    to its tolerance. Returns the launch counts of the ``main()`` run."""
    from repro_torch.examples import online_window as ow
    from repro_torch.models.layers import FP32

    phase_t0 = time.perf_counter()
    cell = ow.Cell(dev)
    fetch, inserts = cell.engine.fetch_local, []

    def recorded_fetch(state, ids, step, train=True):
        out = fetch(state, ids, step, train=train)
        if train:  # kept on the card, read after the run
            inserts.append({k: v for k, v in out[3].items() if k.endswith(("/idmap_inserted", "/idmap_row_overflow"))})
        return out

    cell.engine.fetch_local = recorded_fetch
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = ow.main(["--device", str(dev)], cell=cell, quiet=True, **main_kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    wins = out["windows"]
    n_train = len(wins) * main_kw.get("steps_per_window", 120)
    n_eval = len(wins)
    inserting = sum(int(v) > 0 for rec in inserts for k, v in rec.items() if k.endswith("/idmap_inserted"))
    row_overflow = sum(int(v) for rec in inserts for k, v in rec.items() if k.endswith("/idmap_row_overflow"))
    check(len(inserts) == n_train and row_overflow == 0,
          f"online window: {len(inserts)} train fetches for {n_train} steps, {row_overflow} rows overflowed")
    want = {k: 0 for k in launches}
    want.update({"fused_gather.gather_rows": 4 * n_train + n_eval,
                 "segment_reduce.segment_sum_csr_group": n_train + n_eval,
                 "segment_reduce.segment_expand_csr_group": n_train,
                 "fused_scatter.scatter_add_rows": 3 * n_train,
                 "fused_scatter.scatter_set_rows": 3 * inserting})
    check(inserting > 0 and launches == want,
          f"online window launches {launches}, expected {want} from {inserting} inserting steps")
    pre = [w["pre_eval_loss"] for w in wins]
    post = [w["train_metrics"][-1]["loss"] for w in wins]
    evictions = out["evictions"]
    live = [e["live"] for e in evictions]
    check(all(p >= 0.6 for p in pre), f"pre-train eval {pre}")
    check(all(a < b for a, b in zip(post, pre)), f"post-train loss {post} against pre-train {pre}")
    check(all(n <= out["rows_per_shard"] for n in live), f"live rows after eviction {live}")
    del out

    def first_window(device, prec) -> list:
        o = ow.main(n_windows=1, log_every=1, cell=ow.Cell(device, prec=prec), quiet=True,
                    **{k: v for k, v in main_kw.items() if k not in ("log_every", "n_windows")})
        w = o["windows"][0]
        return [w["pre_eval_loss"]] + [m["loss"] for m in w["train_metrics"]]

    fp32 = {d: first_window(d, FP32) for d in (str(dev), "cpu")}
    fp32_diff = max(abs(a - b) for a, b in zip(fp32[str(dev)], fp32["cpu"]))
    check(fp32_diff <= WINDOW_LOSS_TOL, f"first window, FP32, card against CPU: {fp32_diff}")
    mixed = {d: first_window(d, None) for d in (str(dev), "cpu")}
    mixed_diff = max(abs(a - b) for a, b in zip(mixed[str(dev)], mixed["cpu"]))
    control_diff = max(abs(a - b) for a, b in zip(fp32[str(dev)], mixed["cpu"]))  # MIXED ignored on the card
    check(mixed_diff <= MIXED_WINDOW_LOSS_TOL < control_diff,
          f"first window, MIXED, card against CPU: {mixed_diff} (limit {MIXED_WINDOW_LOSS_TOL}, "
          f"the card's FP32 run against it {control_diff})")
    emit({"phase": "online_window", **device_info, "entry": "repro_torch.examples.online_window.main",
          "settings": {"windows": len(wins), "steps_per_window": main_kw.get("steps_per_window", 120),
                       "reduced": {"windows": [5, len(wins)]},
                       "batch": ow.BATCH, "rows_per_shard": ow.ROWS_PER_SHARD,
                       "evict_age": main_kw.get("evict_age", 150)},
          "pre_eval_loss": pre, "post_train_loss": post, "evictions": evictions,
          "launches": launches, "run_s": run_s,
          "steps_per_s": n_train / run_s,
          "inserting_steps": inserting,
          "first_window_card_vs_cpu": {"fp32_max_abs_diff": fp32_diff, "tolerance": WINDOW_LOSS_TOL,
                                       "mixed_max_abs_diff": mixed_diff, "mixed_tolerance": MIXED_WINDOW_LOSS_TOL,
                                       "card_fp32_vs_cpu_mixed": control_diff, "losses": len(fp32["cpu"])},
          "phase_s": time.perf_counter() - phase_t0})
    return launches


def _sha256s(arrays: dict) -> dict:
    """The sha256 of each array's bytes, each hashed on its own thread."""
    import concurrent.futures
    import hashlib

    with concurrent.futures.ThreadPoolExecutor(len(arrays)) as ex:
        futs = {k: ex.submit(lambda a: hashlib.sha256(np.ascontiguousarray(a)).hexdigest(), v)
                for k, v in arrays.items()}
    return {k: f.result() for k, f in futs.items()}


def _device_export(sparse: dict, gkey: str) -> dict:
    """An all-device engine's export (one shard) sorted by id on the card:
    ids, emb, m, v and last_use, copied to the host."""
    m, b = sparse[gkey]["idmap"], sparse[gkey]["blocks"]
    live = m.occupied[0] & (m.offsets[0] != 0)
    keys = m.keys[0][live]
    order = torch.argsort(keys)
    offs = m.offsets[0][live][order].long()
    return {"ids": keys[order].cpu().numpy(), "emb": b.emb[0][offs].cpu().numpy(),
            "m": b.slots["m"][0][offs].cpu().numpy(), "v": b.slots["v"][0][offs].cpu().numpy(),
            "last_use": m.last_use[0][live][order].cpu().numpy()}


def _union_export(engine, sparse: dict, gkey: str) -> dict:
    """``engine.export_rows`` (both tiers of a tiered engine, with the
    access counts) sorted by id on the host."""
    r = engine.export_rows(sparse)[gkey]
    o = np.argsort(r["ids"], kind="stable")
    out = {"ids": r["ids"][o], "emb": r["emb"][o], "m": r["slots"]["m"][o], "v": r["slots"]["v"][o],
           "last_use": r["last_use"][o]}
    if "counts" in r:
        out["counts"] = r["counts"][o]
    return out


DIGEST_KEYS = ("ids", "emb", "m", "v", "last_use")


def delta_ckpt_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, dev, arch,
                     batch: int, device_info: dict, tier_rows: int = DELTA_TIER_ROWS) -> dict:
    """Incremental checkpoints and crash recovery on the card (dlrm-mlperf
    at published widths, ``arch``'s vocab DELTA_VOCAB, ``batch``
    DELTA_BATCH):
    (a) the Trainer with ``ft_mode="delta"`` and ``FTTrainerHooks`` over
    DELTA_STEPS steps from a state that holds a row for every id the vocab
    gives, a save every 2 steps, a chain at most DELTA_MAX_DEPTH deltas
    deep, a staleness discard through ``evict_to_host`` between steps 10
    and 11, a digest of the sorted export at every save;
    (a') the same state 4 steps further on the device with no checkpoint;
    (b) the writer under one ``ChaosIO`` schedule that fires once at each
    persistence site, restarted from the chain after each crash; (c) (a)'s
    chain recovered into a tiered engine that trains 4 steps with delta
    saves, and that chain recovered onto an all-device and a tiered
    engine; (d) the CLI with ``--ckpt-mode delta`` crashed in a fresh
    process and resumed. Every recovered export is bit-equal to the
    writer's at its step; the row gather is measured at the delta read's
    shape. Returns (a)'s launch counts."""
    import os

    from repro_torch import ft as t_ft, obs as t_obs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import write_log
    from repro_torch.ft import delta as delta_mod, manifest as man_lib
    from repro_torch.io.ragged import Ragged
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.launch import recsys_cell, train as drv
    from repro_torch.launch.common import CellOptions
    from repro_torch.pipelines import TrainConfig, Trainer
    from repro_torch.storage import StorageConfig

    phase_t0 = time.perf_counter()
    base = ROOT / "build" / "delta_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    mcfg = arch.model
    vocab, D = mcfg.vocab_per_feature, mcfg.embed_dim
    gkey = f"dim{D}"
    shape = ShapeCell("train_batch", "train", {"batch": batch})
    start, end = DELTA_START, DELTA_START + DELTA_STEPS
    evict_at = start + DELTA_EVICT_AT
    tiered_opts = dict(storage=StorageConfig(policy="lru"), storage_device_rows=tier_rows)

    def new_cell(**opts):
        return recsys_cell.build(arch, shape, CellOptions(**opts), device=dev)

    cell = new_cell()
    # every id the vocab gives: each sparse column holds 0 .. vocab - 1
    full = {}
    for s in recsys_cell._model_mod(arch.arch_id).feature_specs(mcfg):
        k = s.max_len or 1
        vals = (torch.zeros((vocab * k,), dtype=torch.float32, device=dev) if s.transform == "raw"
                else torch.arange(vocab, dtype=torch.int64, device=dev))
        full[s.name] = Ragged(vals, torch.arange(vocab + 1, dtype=torch.int32, device=dev) * (vals.numel() // vocab))
    with torch.no_grad():
        all_ids = torch.unique(cell.engine.engine_ids(cell.ids_fn(full))[gkey])
    del full
    n_rows = all_ids.numel()
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    rows0 = {gkey: {"ids": all_ids, "emb": torch.randn((n_rows, D), generator=g, device=dev) * 0.01,
                    "slots": {"m": torch.randn((n_rows, D), generator=g, device=dev) * 1e-4,
                              "v": torch.rand((n_rows, D), generator=g, device=dev) * 1e-6},
                    "last_use": torch.randint(0, start, (n_rows,), generator=g, device=dev, dtype=torch.int32)}}
    batches = [cell.make_batch(60_000 + s, vocab=vocab) for s in range(DELTA_STEPS + DELTA_TIER_STEPS)]

    def initial_state(c):
        st = c.init_state()
        st["sparse"] = c.engine.import_rows(rows0)
        st["step"] = torch.tensor(start, dtype=torch.int32, device=dev)
        return st

    evictions: list = []

    def evict_fn(c):
        def evict(state, older_than):
            m = state["sparse"][gkey]["idmap"]
            ids = m.keys[0][m.occupied[0] & (m.last_use[0] < older_than)].cpu().numpy()
            state = dict(state)
            state["sparse"], met = c.engine.evict_to_host(state["sparse"], older_than)
            evictions.append({"older_than": int(older_than), "ids": ids, "evicted": int(met[f"{gkey}/evicted"])})
            return state
        return evict

    def trainer_for(c, directory, hooks, total, io=None):
        cfg = TrainConfig(total_steps=total, ckpt_dir=str(directory), ckpt_every=DELTA_EVERY, ft_mode="delta",
                          ft_max_chain_depth=DELTA_MAX_DEPTH, log_every=1, watchdog=False, anomaly=False,
                          evict_every=evict_at, evict_age_steps=evict_at - DELTA_CUTOFF, ft_io=io)
        return Trainer(c, cfg, hooks=hooks, evict_fn=evict_fn(c), registry=t_obs.MetricsRegistry())

    # a save's parts: the row read and the GC (which re-hashes the chain's frames)
    parts = {"read_s": 0.0, "gc_s": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                parts[key] += time.perf_counter() - t0
        return wrapper

    real_gc, real_subset = man_lib.gc, delta_mod.export_rows_subset
    man_lib.gc = timed(real_gc, "gc_s")
    delta_mod.export_rows_subset = timed(real_subset, "read_s")

    def instrument(tr, saves: list, digest_fn=None, digests=None, record: bool = False):
        """Each save timed and logged, and (with ``digest_fn``) a digest of
        the export at its step, outside the timing."""
        real_save = tr.ft.save
        eng = tr.ft.engine
        eng.export_rows = timed(eng.export_rows, "read_s")

        def save(state, step, cursor=None):
            parts.update(read_s=0.0, gc_s=0.0)
            phase["name"] = "delta_read" if record else None
            t0 = time.perf_counter()
            try:
                man = real_save(state, step, cursor)
            finally:
                phase["name"] = None
            save_s = time.perf_counter() - t0
            saves.append({"step": int(step), "kind": man.kind, "depth": man.chain_depth,
                          "n_dirty": man.extra["n_dirty"], "n_dead": man.extra["n_dead"],
                          "dirty_fraction": tr.registry.get("ckpt/dirty_fraction").value,
                          "frame_bytes": sum(f["nbytes"] for f in man.frames), "save_s": save_s, **parts})
            if digest_fn is not None and int(step) not in digests:
                digests[int(step)] = digest_fn(state)
            return man
        tr.ft.save = save

    def dig_dev(state):
        return _sha256s(_device_export(state["sparse"], gkey))

    def release():
        write_log.set_observer(None)
        gc.collect()
        torch.cuda.empty_cache()

    # ------------------------------------------------ (a) uninterrupted writer
    dir_a = base / "a"
    state = initial_state(cell)
    tr = trainer_for(cell, dir_a, t_ft.FTTrainerHooks(cell.engine, cell.ids_fn), end)
    saves_a, dig_a = [], {start: dig_dev(state)}
    instrument(tr, saves_a, dig_dev, dig_a, record=True)
    real_gather = recorder(fg_ops, "gather_rows")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res_a = tr.run(state, iter(batches[:DELTA_STEPS]), start_step=start)
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    launches = counts()
    fg_ops.gather_rows = real_gather
    del state
    hist_a = res_a.metrics_history
    losses_a = [m["loss"] for m in hist_a]
    for s in saves_a:
        emit({"phase": "delta_ckpt_save", "run": "a", **s})
    kinds = [(s["kind"], s["depth"]) for s in saves_a]
    want_kinds = [("base", 0)] + [("delta", i) for i in range(1, DELTA_MAX_DEPTH + 1)] + [("base", 0), ("delta", 1)]
    check(kinds == want_kinds, f"(a) saves {kinds}, expected {want_kinds}")
    check(len(hist_a) == DELTA_STEPS and all(np.isfinite(losses_a)), f"(a) losses {losses_a}")
    check(all(v == 0 for m in hist_a for k, v in m.items() if "overflow" in k), "(a) overflow")
    inserting = sum(m[f"{gkey}/idmap_inserted"] > 0 for m in hist_a)
    deltas_read = sum(s["kind"] == "delta" and s["n_dirty"] > 0 for s in saves_a)
    want = {k: 0 for k in launches}
    want.update({"fused_gather.gather_rows": 4 * DELTA_STEPS + 3 * deltas_read,
                 "segment_reduce.segment_sum_csr_group": DELTA_STEPS,
                 "segment_reduce.segment_expand_csr_group": DELTA_STEPS,
                 "fused_scatter.scatter_add_rows": 3 * DELTA_STEPS,
                 "fused_scatter.scatter_set_rows": 3 * inserting})
    check(launches == want, f"(a) launches {launches}, expected {want} ({deltas_read} delta reads, "
                            f"{inserting} inserting steps)")
    base_bytes = saves_a[0]["frame_bytes"]
    deltas = [s for s in saves_a if s["kind"] == "delta" and s["n_dirty"]]
    small = [s for s in deltas if s["dirty_fraction"] <= 0.10]
    check(small and all(s["frame_bytes"] < 0.25 * base_bytes for s in small),
          f"deltas at <= 10% dirty against 25% of the base's {base_bytes} bytes: "
          f"{[(s['step'], s['dirty_fraction'], s['frame_bytes']) for s in deltas]}")
    # the discard: a share of the rows, about half of them negative ids, and
    # a tombstone for each that stays dead (C4 on the card)
    check(len(evictions) == 1 and evictions[0]["evicted"] == evictions[0]["ids"].size > 0,
          f"(a) evictions {[(e['older_than'], e['evicted'], e['ids'].size) for e in evictions]}")
    ev = evictions[0]
    ev_ids = np.sort(ev["ids"])
    m_a = res_a.state["sparse"][gkey]["idmap"]
    gone = ev_ids[~np.isin(ev_ids, m_a.keys[0][m_a.occupied[0]].cpu().numpy())]  # never touched again
    del m_a
    neg_share = float((ev_ids < 0).mean())
    tomb = next(s for s in saves_a if s["step"] >= evict_at)
    check(0.35 < neg_share < 0.65 and (gone < 0).any() and tomb["n_dead"] >= gone.size,
          f"evicted {ev_ids.size} ids, {neg_share:.3f} negative, {gone.size} never back, "
          f"{tomb['n_dead']} tombstones at step {tomb['step']}")

    # (a') the same state 4 more steps on the device, no checkpoint
    cont_losses, dig_cont, st = [], {}, res_a.state
    for i in range(DELTA_TIER_STEPS):
        st, met = cell.step_fn(st, batches[DELTA_STEPS + i])
        cont_losses.append(float(met["loss"]))
        if (i + 1) % DELTA_EVERY == 0:
            dig_cont[end + i + 1] = dig_dev(st)
    del st, met, res_a, tr, cell
    release()

    # (d)'s first two processes start now and run beside (b) and (c): the
    # CLI with --ckpt-mode delta, uninterrupted and crashed
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-mlperf", "--device", "cuda",
           "--steps", str(DELTA_CLI_STEPS), "--log-every", "1", "--batch", "64", "--ckpt-mode", "delta",
           "--ckpt-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def cli(extra: list) -> subprocess.Popen:
        return cli_process(cmd + extra, env)

    t_cli = time.perf_counter()
    procs = [cli(["--ckpt-dir", str(base / "d_u"), "--telemetry", str(base / "d_u.jsonl")]),
             cli(["--ckpt-dir", str(base / "d_c"), "--chaos-schedule", f"crash@step:{DELTA_CLI_CRASH_AT}",
                  "--telemetry", str(base / "d_a.jsonl")])]

    # ----------------------------------------------------- (b) crash matrix
    io_b = t_ft.ChaosIO(t_ft.ChaosSchedule.parse(DELTA_CHAOS))  # no fsync, as the chaos tests run it
    dir_b = base / "b"
    recovered, crashes, saves_b, final_b = [], [], [], None
    t0 = time.perf_counter()
    for session in range(1, 9):
        c = new_cell()
        trb = trainer_for(c, dir_b, t_ft.FTTrainerHooks(c.engine, c.ids_fn), end, io=io_b)
        instrument(trb, saves_b)
        if trb.ft.has_chain():
            tr0 = time.perf_counter()
            st, s0, _ = trb.try_resume(c.init_state())
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - tr0
            d = dig_dev(st)
            bad = [k for k in DIGEST_KEYS if d[k] != dig_a.get(s0, {}).get(k)]
            recovered.append({"step": s0, "recovery_s": rec_s, "differs": bad})
            check(not bad, f"(b) the recovery at step {s0} differs from (a)'s export in {bad}")
        else:
            st, s0 = initial_state(c), start
        try:
            res = trb.run(st, iter(batches[s0 - start:DELTA_STEPS]), start_step=s0)
        except t_ft.InjectedCrash as e:
            crashes.append({"session": session, "error": str(e)})
        else:
            x = _device_export(res.state["sparse"], gkey)
            final_b = (_sha256s(x), x["ids"])
            del res, x
        del st, trb, c
        release()
        if final_b is not None:
            break
    b_s = time.perf_counter() - t0
    check([str(e) for e in io_b.fired] == DELTA_CHAOS.split(","), f"(b) fired {[str(e) for e in io_b.fired]}")
    check([r["step"] for r in recovered] == DELTA_RECOVERED,
          f"(b) recovered at {[r['step'] for r in recovered]}, expected {DELTA_RECOVERED}")
    check(final_b is not None and final_b[0] == dig_a[end], "(b) the finished run's export differs from (a)'s")
    check(not np.isin(gone, final_b[1]).any(), "(b) an evicted id came back")

    # --------------------------------------------- (c) tier independence
    t0 = time.perf_counter()
    tcell = new_cell(**tiered_opts)
    trc = trainer_for(tcell, dir_a, tcell.storage_hooks, end + DELTA_TIER_STEPS)
    saves_c, dig_c = [], {}

    def dig_union(state):
        return _sha256s(_union_export(tcell.engine, state["sparse"], gkey))

    instrument(trc, saves_c, dig_union, dig_c)
    tr0 = time.perf_counter()
    st, s0, _ = trc.try_resume(tcell.init_state())
    c_rec_s = time.perf_counter() - tr0
    store = tcell.engine.storage
    split_after_recovery = {"device": store.device_resident(), "host": store.host_rows()}
    d = dig_union(st)
    check(s0 == end and {k: d[k] for k in DIGEST_KEYS} == dig_a[end],
          f"(c) the tiered recovery at step {s0} differs from (a)'s export")
    res_c = trc.run(st, iter(batches[DELTA_STEPS:]), start_step=end)
    del st
    hist_c = res_c.metrics_history
    losses_c = [m["loss"] for m in hist_c]
    loss_err = max(abs(a - b) for a, b in zip(losses_c, cont_losses))
    check(len(losses_c) == DELTA_TIER_STEPS and loss_err <= 1e-5,
          f"(c) tiered losses {losses_c} against the all-device run's {cont_losses}")
    check(all(m["storage/unplaceable"] == 0 and all(v == 0 for k, v in m.items() if "overflow" in k)
              for m in hist_c), "(c) overflow or unplaceable ids")
    for s, dc in dig_cont.items():
        check({k: dig_c[s][k] for k in DIGEST_KEYS} == dc,
              f"(c) the tiered union export at step {s} differs from the all-device run's")
    c_kinds = [(s["kind"], s["depth"]) for s in saves_c]
    check(all(k == "delta" for k, _ in c_kinds), f"(c) saves {c_kinds}")
    tip = end + DELTA_TIER_STEPS
    with torch.no_grad():  # the discarded ids that (c)'s 4 steps did not bring back
        touched = torch.cat([tcell.engine.engine_ids(tcell.ids_fn(b))[gkey] for b in batches[DELTA_STEPS:]])
    gone_c = gone[~np.isin(gone, touched.cpu().numpy())]
    del res_c, trc, tcell, store
    release()
    recovered_c = {}
    for name, opts in (("all_device", {}), ("tiered", tiered_opts)):
        c = new_cell(**opts)
        ck = t_ft.DeltaCheckpointer(dir_a, c.engine, t_ft.DirtyTracker(registry=t_obs.MetricsRegistry()),
                                    registry=t_obs.MetricsRegistry(), state_tree=c.state_tree,
                                    load_state_tree=c.load_state_tree)
        tr0 = time.perf_counter()
        res = ck.recover(like_state=c.init_state())
        torch.cuda.synchronize()
        rs = time.perf_counter() - tr0
        x = _union_export(c.engine, res.state["sparse"], gkey) if opts else _device_export(res.state["sparse"], gkey)
        dx = _sha256s(x)
        want_d = dig_c[tip] if opts else {k: dig_c[tip][k] for k in DIGEST_KEYS}
        bad = [k for k in want_d if dx.get(k) != want_d[k]]
        check(res.step == tip and not bad, f"(c) the recovery onto the {name} engine at step {res.step} "
                                           f"differs in {bad}")
        check(not np.isin(gone_c, x["ids"]).any(), f"(c) an evicted id came back on the {name} engine")
        recovered_c[name] = {"step": res.step, "recovery_s": rs, "frames_read": res.frames_read,
                             "rows": int(x["ids"].size), "compared": sorted(want_d)}
        del c, ck, res, x
        release()
    c_s = time.perf_counter() - t0

    # ------------------------------------------- (d) the CLI, fresh processes
    (out_u, err_u), (out_a, err_a) = (p.communicate(timeout=300) for p in procs)
    resume = cli(["--ckpt-dir", str(base / "d_c"), "--resume", "--telemetry", str(base / "d_r.jsonl")])
    out_r, err_r = resume.communicate(timeout=300)
    d_s = time.perf_counter() - t_cli
    rcs = [procs[0].returncode, procs[1].returncode, resume.returncode]
    cu, ca, cr = ({k: r["metrics"]["loss"] for k, r in _step_records(base / f).items()}
                  for f in ("d_u.jsonl", "d_a.jsonl", "d_r.jsonl"))
    d_start = min(cr) - 1 if cr else None
    d_err = (max(abs(got[k] - cu[k]) / abs(cu[k]) for got in (ca, cr) for k in got)
             if cr and sorted(cr) == list(range(d_start + 1, DELTA_CLI_STEPS + 1)) and set(ca) <= set(cu) else None)
    check(rcs == [0, drv.CHAOS_EXIT, 0], f"delta CLI return codes {rcs}: {err_a[-2000:]} {err_r[-2000:]}")
    check(f"CHAOS: chaos: crash@step:{DELTA_CLI_CRASH_AT}" in out_a, "the delta CLI's crash was not the injected one")
    check(d_start == DELTA_CLI_CRASH_AT - 1 and f"resumed from step {d_start}" in out_r,
          f"the delta CLI resumed from {d_start}")
    check(d_err is not None and d_err <= 1e-5, f"the delta CLI's steps differ by {d_err}")
    cli_chain = [(m.step, m.kind) for m in man_lib.load_chain(base / "d_c")]

    # ------------------------------------- the row gather at the delta read
    man_lib.gc, delta_mod.export_rows_subset = real_gc, real_subset
    check(("gather_rows", "delta_read") in recorded, "no delta save read its rows through the gather")
    args, kw = recorded.pop(("gather_rows", "delta_read"))
    read_at = _measure("gather_rows", real_gather, fg_ref.gather_rows, args, kw, 20, dev)
    _add_path(by_name["fused_gather.gather_rows"], "delta_read", read_at)
    del args, rows0, all_ids, batches
    torch.cuda.empty_cache()

    def med(key, xs):
        return float(np.median([s[key] for s in xs]))

    emit({"phase": "delta_ckpt", **device_info, "arch": arch.arch_id, "batch": batch,
          "widths": {"n_dense": mcfg.n_dense, "n_sparse": mcfg.n_sparse, "embed_dim": D,
                     "bot_mlp": mcfg.bot_mlp, "top_mlp": mcfg.top_mlp},
          "reduced": {"vocab_per_feature": [4_000_000, vocab], "batch": [65_536, batch], "devices": [256, 1]},
          "rows_imported": n_rows, "start_step": start, "steps": DELTA_STEPS, "ckpt_every": DELTA_EVERY,
          "saves": [{k: s[k] for k in ("step", "kind", "depth", "n_dirty", "n_dead", "dirty_fraction",
                                       "frame_bytes", "save_s", "read_s", "gc_s")} for s in saves_a],
          "base_bytes": base_bytes, "delta_over_base": [s["frame_bytes"] / base_bytes for s in deltas],
          "delta_save_s_p50": med("save_s", deltas), "delta_read_s_p50": med("read_s", deltas),
          "delta_gc_s_p50": med("gc_s", deltas), "dirty_fraction_p50": med("dirty_fraction", deltas),
          "base_save_s": [s["save_s"] for s in saves_a if s["kind"] == "base"],
          "eviction": {"older_than": ev["older_than"], "discarded": int(ev_ids.size),
                       "discarded_share": ev_ids.size / n_rows, "negative_share": neg_share,
                       "never_back": int(gone.size), "never_back_negative": int((gone < 0).sum()),
                       "never_back_after_c": int(gone_c.size),
                       "tombstones": {"step": tomb["step"], "n_dead": tomb["n_dead"]}},
          "losses": losses_a, "step_ms_p50": float(np.median([m["wall_s"] * 1e3 for m in hist_a])),
          "launches": launches, "launches_want": want, "run_a_s": a_s,
          "crash_matrix": {"schedule": DELTA_CHAOS, "fired": [str(e) for e in io_b.fired], "crashes": crashes,
                           "recovered": recovered, "final_bit_equal": True, "run_s": b_s,
                           "saves": [(s["step"], s["kind"], s["save_s"]) for s in saves_b]},
          "tiered": {"device_rows": tier_rows, "recovery_s": c_rec_s, "split_after_recovery": split_after_recovery,
                     "losses": losses_c, "all_device_losses": cont_losses, "loss_max_abs_err": loss_err,
                     "saves": c_kinds, "union_bit_equal_at": sorted(dig_cont), "recovered": recovered_c,
                     "run_s": c_s},
          "cli": {"cmd": " ".join(cmd[1:]), "crash_at": DELTA_CLI_CRASH_AT, "returncodes": rcs,
                  "resumed_from": d_start, "max_rel_err": d_err, "chain": cli_chain,
                  "losses_uninterrupted": [cu[k] for k in sorted(cu)], "losses_resumed": [cr[k] for k in sorted(cr)],
                  "three_processes_s": d_s, "three_processes_s_note": "the first two beside (b) and (c)"},
          "delta_read_gather": {k: read_at[k] for k in ("shape", "ms", "kernel_device_ms", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_by", "host_us")},
          "phase_s": time.perf_counter() - phase_t0})
    shutil.rmtree(base, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The other recsys models: Wide & Deep, SASRec, MIND, and the retrieval cell

RECSYS_MODELS = ("wide-deep", "sasrec", "mind")
RETRIEVAL_ARCHS = ("dlrm-mlperf", "wide-deep", "sasrec", "mind")
N_RETR_WARMUP, N_RETR = 2, 5
# The models keep their published vocabs in every cell; dlrm-mlperf keeps
# VOCAB (its published 4,000,000 needs 240 GB). A retrieval cell holds two
# engines, each sized for the whole table (emb, m, v: 12 D bytes a row, and
# 42 bytes of IDMap): Wide & Deep's two take 67.7 GB, and a request of
# 1,000,000 candidates about 8 GB more.
# smoke cells card against CPU: each arch's smoke config, and Wide & Deep's
# with two dim groups (embed_dim 16, wide_dim 8)
SMOKE_MODELS = (("wide-deep", {}), ("wide-deep", {"embed_dim": 16}), ("sasrec", {}), ("mind", {}))
RECSYS_KERNELS = ("fused_gather.gather_rows", "segment_reduce.segment_sum_csr_group",
                  "segment_reduce.segment_expand_csr_group", "sequence_tile.sequence_tile",
                  "sequence_tile.sequence_untile", "fused_scatter.scatter_add_rows", "fused_scatter.scatter_set_rows")


def _recsys_arch(arch_id: str, smoke: bool = False, **change):
    from repro_torch.configs import get_config

    arch = get_config(arch_id, smoke=smoke)
    return dataclasses.replace(arch, model=dataclasses.replace(arch.model, **change)) if change else arch


def _vocab(arch) -> int:
    m = arch.model
    return m.vocab_per_feature if hasattr(m, "vocab_per_feature") else m.vocab


def _per_step(engine, train: bool, inserting: int = 0) -> dict:
    """The launches one serve request or train step makes through a recsys
    engine: per dim group one row gather (four in training: the fetch, then
    SparseAdam's reads of emb, m and v), one grouped sum (and its gradient)
    if the group has a sum or mean feature, one tile (and untile) per
    sequence feature, three scatter adds (SparseAdam's writes) and, in each
    of the ``inserting`` groups that inserted rows, three sets."""
    groups = engine.groups.values()
    sums = sum(any(s.pooling in ("sum", "mean") for s in g.features) for g in groups)
    tiles = sum(s.pooling in ("none", "tile") for g in groups for s in g.features)
    want = {k: 0 for k in DRIVER_PER_STEP}
    want.update({"fused_gather.gather_rows": (4 if train else 1) * len(groups),
                 "segment_reduce.segment_sum_csr_group": sums,
                 "segment_reduce.segment_expand_csr_group": sums if train else 0,
                 "sequence_tile.sequence_tile": tiles, "sequence_tile.sequence_untile": tiles if train else 0,
                 "fused_scatter.scatter_add_rows": 3 * len(groups) if train else 0,
                 "fused_scatter.scatter_set_rows": 3 * inserting})
    return want


def _request_rows(engines, ids_list, dev, scale: float = 0.05) -> tuple[dict, dict]:
    """Rows (random emb, zero moments) for every engine id the requests
    touch, in the export form ``import_rows`` takes; and their count per
    group."""
    per_group: dict = {}
    for engine, ids in zip(engines, ids_list):
        for key, e in engine.engine_ids(ids).items():
            per_group.setdefault(key, []).append(e)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, n = {}, {}
    for key, parts in per_group.items():
        u = torch.unique(torch.cat(parts))
        u = u[u != -1]
        d = int(key[3:])
        emb = torch.randn((u.numel(), d), generator=gen, device=dev) * scale
        zeros = torch.zeros_like(emb)
        rows[key] = {"ids": u, "emb": emb, "slots": {"m": zeros, "v": zeros},
                     "last_use": torch.zeros(u.numel(), dtype=torch.int32, device=dev)}
        n[key] = u.numel()
    return rows, n


def _without_engines(state: dict) -> dict:
    """A fresh cell state without its engine states, freed on the card: an
    engine's ``import_rows`` builds a state of its own, and Wide & Deep's
    retrieval engines (67.7 GB) do not fit twice."""
    out = {k: v for k, v in state.items() if not k.startswith("sparse")}
    del state
    torch.cuda.empty_cache()
    return out


def _keep(a, whole: bool):
    """A copy with the same strides; tables over 2^28 elements are kept as
    they are unless ``whole`` (the scatter writes into its table)."""
    if not torch.is_tensor(a):
        return a
    if a.numel() >= (1 << 28) and not whole:
        return a.detach()
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=a.device).copy_(a.detach())


def _smoke_rows(rows: dict, rng, train: bool) -> dict:
    """``_request_rows``' rows with every 7th id left out (a zero row at
    serve, inserted in training); in training with moments drawn as the
    dlrm smoke train's are."""
    out = {}
    for key, r in rows.items():
        keep = torch.ones(r["ids"].numel(), dtype=torch.bool)
        keep[::7] = False
        emb = r["emb"][keep]
        n, d = emb.shape
        slots = ({"m": torch.from_numpy(rng.normal(scale=1e-3, size=(n, d)).astype(np.float32)),
                  "v": torch.from_numpy((rng.random(size=(n, d)) * 1e-5).astype(np.float32))} if train
                 else {k: torch.zeros_like(emb) for k in ("m", "v")})
        out[key] = {"ids": r["ids"][keep], "emb": emb, "slots": slots, "last_use": torch.ones(n, dtype=torch.int32)}
    return out


def smoke_models_phase(rng) -> None:
    """Phase 3 for the other recsys models: each smoke serve cell (three
    requests over imported rows, every 7th id missing) and three train steps
    from one state, then each arch's smoke retrieval cell (1,000
    candidates), on the card against the same cells on the CPU: metrics and
    IDMaps equal, floats within the dlrm smoke cells' tolerances."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core import idmap as idmap_lib
    from repro_torch.io.ragged import Ragged
    from repro_torch.launch import recsys_cell

    seeds = (0, 1, 2)
    for arch_id, change in SMOKE_MODELS:
        arch = _recsys_arch(arch_id, smoke=True, **change)
        label = arch_id + ("" if not change else "-" + "-".join(f"{k}{v}" for k, v in change.items()))
        result = {"phase": "smoke_recsys_card_vs_cpu", "arch": label, "batch": 32,
                  "groups": None, "tolerance": {"logits_and_loss": MIXED_TOL, "emb_and_dense_atol": TRAIN_PARAM_ATOL,
                                                "moments": f"{TRAIN_MOMENT_FRAC} of the largest magnitude"}}
        for kind in ("serve", "train"):
            name = "serve_p99" if kind == "serve" else "train_batch"
            cells = {d: recsys_cell.build(arch, ShapeCell(name, kind, {"batch": 32}), device=d)
                     for d in ("cpu", "cuda")}
            eng = cells["cpu"].engine
            result["groups"] = list(eng.groups)
            ids = [cells["cpu"].ids_fn(cells["cpu"].make_batch(s)) for s in seeds]
            rows, _ = _request_rows([eng] * len(ids), ids, "cpu", scale=1.0 if kind == "serve" else 0.1)
            rows = _smoke_rows(rows, rng, kind == "train")
            states = {}
            for d, c in cells.items():
                states[d] = c.init_state()
                states[d]["sparse"] = c.engine.import_rows(rows)
            states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
            diffs = 0.0
            for s in seeds:
                outs = {}
                for d, c in cells.items():
                    if kind == "serve":
                        outs[d] = c.step_fn(states[d], c.make_batch(s))
                    else:
                        states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
                val = "logits" if kind == "serve" else "loss"
                met = {d: {k: int(v) for k, v in o.items() if k != val} for d, o in outs.items()}
                check(met["cuda"] == met["cpu"], f"{label} smoke {kind} metrics differ: {met}")
                got, want = outs["cuda"][val].float().cpu(), outs["cpu"][val].float()
                check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MIXED_TOL),
                      f"{label} smoke {kind} {val} differ by {(got - want).abs().max()}")
                diffs = max(diffs, float((got - want).abs().max()))
            result[f"{kind}_max_abs_{'logit' if kind == 'serve' else 'loss'}_diff"] = diffs
            if kind == "train":
                for key in eng.groups:
                    for f in idmap_lib.TENSOR_FIELDS:
                        got, want = (getattr(states[d]["sparse"][key]["idmap"], f).cpu() for d in ("cuda", "cpu"))
                        check(torch.equal(got, want), f"{label} smoke train {key} IDMap field {f} differs")
                    exp = {d: cells[d].engine.export_rows(states[d]["sparse"])[key] for d in states}
                    check(np.array_equal(exp["cuda"]["ids"], exp["cpu"]["ids"]), f"{label} smoke train {key} ids")
                    e = float(np.abs(exp["cuda"]["emb"] - exp["cpu"]["emb"]).max())
                    check(e <= TRAIN_PARAM_ATOL, f"{label} smoke train {key} rows differ by {e}")
                    for k in ("m", "v"):
                        got, want = exp["cuda"]["slots"][k], exp["cpu"]["slots"][k]
                        check(np.abs(got - want).max() <= TRAIN_MOMENT_FRAC * np.abs(want).max(),
                              f"{label} smoke train {key} {k} differs")
                    result[f"train_{key}_max_abs_emb_diff"] = e
                dense = {d: states[d]["dense"].state_dict() for d in states}
                e = max(float((dense["cuda"][k].cpu() - v).abs().max()) for k, v in dense["cpu"].items())
                check(e <= TRAIN_PARAM_ATOL, f"{label} smoke train dense params differ by {e}")
                result["train_max_abs_dense_diff"] = e
            del cells, states
        emit(result)
    for arch_id in RETRIEVAL_ARCHS:
        arch = _recsys_arch(arch_id, smoke=True)
        shape = ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000})
        cells = {d: recsys_cell.build(arch, shape, device=d) for d in ("cpu", "cuda")}
        c = cells["cpu"]
        ids = [c.ids_fn(c.make_batch(2 * s, vocab=500)) for s in seeds]
        rows, _ = _request_rows([c.engine_user, c.engine_cand] * len(ids),
                                [x[p] for x in ids for p in ("user", "cand")], "cpu", scale=0.5)
        states = {}
        for d, cell in cells.items():
            states[d] = cell.init_state()
            states[d]["sparse_user"] = cell.engine_user.import_rows(rows)
            states[d]["sparse_cand"] = cell.engine_cand.import_rows(rows)
        states["cuda"]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
        diff = 0.0
        for s in seeds:
            b = c.make_batch(2 * s, vocab=500)
            on_card = {p: {k: Ragged(v.values.to(cells["cuda"].device), v.row_splits.to(cells["cuda"].device))
                           for k, v in cols.items()} for p, cols in b.items()}
            outs = {"cpu": c.step_fn(states["cpu"], b), "cuda": cells["cuda"].step_fn(states["cuda"], on_card)}
            met = {d: {k: int(v) for k, v in o.items() if k != "scores"} for d, o in outs.items()}
            check(met["cuda"] == met["cpu"], f"{arch_id} smoke retrieval metrics differ: {met}")
            got, want = outs["cuda"]["scores"].cpu(), outs["cpu"]["scores"]
            check(got.shape == (1_000,) and bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MIXED_TOL),
                  f"{arch_id} smoke retrieval scores differ by {(got - want).abs().max()}")
            check(torch.unique(got).numel() > 100, f"{arch_id} smoke retrieval scores are degenerate")
            diff = max(diff, float((got - want).abs().max()))
        emit({"phase": "smoke_retrieval_card_vs_cpu", "arch": arch_id, "n_candidates": 1_000,
              "requests": len(seeds), "metrics": met["cuda"], "max_abs_score_diff": diff, "tolerance": MIXED_TOL})
        del cells, states


def recsys_models_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, dev,
                        device_info: dict) -> dict:
    """Wide & Deep, SASRec and MIND at published widths: each model's
    ``serve_p99`` (batch 512, 3 warm-up and 20 timed requests over rows
    imported for the ids they touch) and ``train_batch`` (batch 65,536 from
    a fresh state: 3 warm-up and 3 timed steps with exact launches a step,
    zero overflow, finite losses, a torch.profiler trace of one step, three
    steps on one repeated batch); then ``retrieval_cand`` (1,000,000
    candidates, 2 warm-up and 5 timed requests) for the four recsys archs
    and the serve_retrieval twin's ``main()``. The kernels are measured on
    the inputs these paths gave them (the D-50 scalar path of the gather,
    tile, untile and scatter; the grouped sum at D 32 and 8 and at D 64; the
    gathers of the candidates' rows). Returns the launches over every
    sub-path, each counted from 0."""
    from repro_torch.examples import serve_retrieval
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.kernels.sequence_tile import ops as st_ops, ref as st_ref
    from repro_torch.launch import recsys_cell

    phase_t0 = time.perf_counter()
    total = {k: 0 for k in counts()}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            total[k] += v

    wrapped = ((fg_ops, "gather_rows", False, True), (fs_ops, "scatter_add_rows", True, False),
               (fs_ops, "scatter_set_rows", True, False), (sr_ops, "segment_sum_csr_group", False, True),
               (sr_ops, "segment_expand_csr_group", False, True), (st_ops, "sequence_tile", False, True),
               (st_ops, "sequence_untile", False, True))
    real = {name: recorder(mod, name, whole, every) for mod, name, whole, every in wrapped}
    # what each model's probe step records, measured after its train run:
    # (wrapper, call indices (None: all), plain version, kernel entry)
    probes = {
        "wide-deep": [("segment_sum_csr_group", None, sr_ref.segment_sum_csr_group, "segment_reduce.segment_sum_csr_group"),
                      ("segment_expand_csr_group", None, sr_ref.segment_expand_csr_group,
                       "segment_reduce.segment_expand_csr_group")],
        "sasrec": [("gather_rows", (0,), fg_ref.gather_rows, "fused_gather.gather_rows"),
                   ("scatter_add_rows", (0,), fs_ref.scatter_add_rows, "fused_scatter.scatter_add_rows"),
                   ("scatter_set_rows", (0,), fs_ref.scatter_set_rows, "fused_scatter.scatter_set_rows"),
                   ("sequence_tile", (0,), st_ref.sequence_tile, "sequence_tile.sequence_tile"),
                   ("sequence_untile", (0,), st_ref.sequence_untile, "sequence_tile.sequence_untile")],
        "mind": [("segment_sum_csr_group", None, sr_ref.segment_sum_csr_group, "segment_reduce.segment_sum_csr_group"),
                 ("segment_expand_csr_group", None, sr_ref.segment_expand_csr_group,
                  "segment_reduce.segment_expand_csr_group"),
                 ("sequence_tile", None, st_ref.sequence_tile, "sequence_tile.sequence_tile"),
                 ("sequence_untile", None, st_ref.sequence_untile, "sequence_tile.sequence_untile")]}

    def measure(path: str, todo) -> dict:
        """The recorded inputs of ``path``, each held to its plain version
        and timed; added to the kernel entries' ``at``."""
        out = {}
        for kname, which, plain, entry in todo:
            # an ``every`` wrapper's calls are keyed by index, another's first call is index 0
            keys = sorted(k for k in recorded
                          if k[:2] == (kname, path) and (which is None or (k[2:] or (0,))[0] in which))
            check(keys, f"{path}: no recorded call of {kname}")
            for key in keys:
                args, kw = recorded.pop(key)
                label = path if len(keys) == 1 else f"{path}_{key[2]}"
                if kname.startswith("sequence"):
                    m = _measure_mse_kernel(kname, real[kname], plain, args, iters=20)
                else:
                    m = _measure(kname, real[kname], plain, args, kw, 20, dev)
                _add_path(by_name[entry], label, m)
                out[f"{kname}@{label}"] = {k: m[k] for k in ("shape", "ms", "kernel_device_ms", "plain_ms",
                                                             "library_ms", "bound_ms", "bound_by", "host_us")}
                del args
                torch.cuda.empty_cache()
        for key in [k for k in recorded if k[1] == path]:  # calls that are not measured
            del recorded[key]
        return out

    models = {}
    try:
        for arch_id in RECSYS_MODELS:
            arch = _recsys_arch(arch_id)
            mcfg, vocab = arch.model, _vocab(arch)
            part_t0 = time.perf_counter()
            # ------------------------------------------------ serve_p99
            cell = recsys_cell.build(arch, arch.shape("serve_p99"), device=dev)
            batches = [cell.make_batch(40_000 + s, vocab=vocab) for s in range(N_WARMUP + N_P99_REQUESTS)]
            state = _without_engines(cell.init_state())  # import_rows builds the engine state
            rows, n_rows = _request_rows([cell.engine] * len(batches), [cell.ids_fn(b) for b in batches], dev)
            state["sparse"] = cell.engine.import_rows(rows)
            del rows
            state_bytes = sum(t.numel() * t.element_size() for t in _tensors(state["sparse"]))
            torch.cuda.synchronize()
            reset_counts()
            lat = []
            for s, b in enumerate(batches):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = cell.step_fn(state, b)
                end.record()
                end.synchronize()
                if s >= N_WARMUP:
                    lat.append(start.elapsed_time(end))
                met = {k: int(v) for k, v in out.items() if k != "logits"}
                check(out["logits"].shape == (512,) and bool(torch.isfinite(out["logits"]).all()),
                      f"{arch_id} serve logits")
                check(all(v == 0 for k, v in met.items() if "overflow" in k), f"{arch_id} serve overflow: {met}")
                check(all(met[f"{k}/dev_rows_live"] == n for k, n in n_rows.items()), f"{arch_id} serve rows: {met}")
            serve_launches = counts()
            add(serve_launches)
            want = {k: v * len(batches) for k, v in _per_step(cell.engine, False).items()}
            check(all(serve_launches[k] == v for k, v in want.items()),
                  f"{arch_id} serve launches {serve_launches}, expected {want}")
            lat_a = np.array(lat)
            serve = {"batch": 512, "requests": N_P99_REQUESTS, "warmup": N_WARMUP, "rows_imported": n_rows,
                     "state_bytes": state_bytes, "latency_ms_p50": float(np.percentile(lat_a, 50)),
                     "latency_ms_p99": float(np.percentile(lat_a, 99)), "latency_ms_mean": float(lat_a.mean()),
                     "latency_ms": lat, "launches": serve_launches,
                     "launches_per_request": {k: v / len(batches) for k, v in serve_launches.items()}}
            del cell, state, batches, out
            torch.cuda.empty_cache()

            # ------------------------------------------------ train_batch
            cell = recsys_cell.build(arch, arch.shape("train_batch"), device=dev)
            n_steps = N_TRAIN_WARMUP + N_RM_STEPS
            tbatches = [cell.make_batch(50_000 + s, vocab=vocab) for s in range(n_steps + 3 + 1)]
            ids_per_step = {k: int(v.numel()) for k, v in cell.engine.engine_ids(cell.ids_fn(tbatches[0])).items()}
            tstate = cell.init_state()
            tstate_bytes = sum(t.numel() * t.element_size() for t in _tensors(tstate["sparse"]))
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            step_ms, losses, inserted, per_step = [], [], [], []
            for s in range(n_steps):
                phase["name"] = f"{arch_id.replace('-', '_')}_train" if s == N_TRAIN_WARMUP - 1 else None
                before = counts()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                tstate, out = cell.step_fn(tstate, tbatches[s])
                end.record()
                end.synchronize()
                phase["name"] = None
                if s >= N_TRAIN_WARMUP:
                    step_ms.append(start.elapsed_time(end))
                met = {k: int(v) for k, v in out.items() if k != "loss"}
                losses.append(float(out["loss"]))
                ins = {k.split("/")[0]: v for k, v in met.items() if k.endswith("/idmap_inserted")}
                inserted.append(ins)
                delta = {k: v - before[k] for k, v in counts().items()}
                want = _per_step(cell.engine, True, sum(v > 0 for v in ins.values()))
                check(delta == want, f"{arch_id} train step {s + 1}: launches {delta}, expected {want}")
                per_step.append(delta)
                check(all(v == 0 for k, v in met.items() if "overflow" in k),
                      f"{arch_id} train overflow at step {s + 1}: {met}")
                check(np.isfinite(losses[-1]), f"{arch_id} train loss {losses[-1]} at step {s + 1}")
                if s == N_TRAIN_WARMUP - 2:  # steps 1-2: before the probe step's recorded copies
                    train_peak = torch.cuda.max_memory_allocated()
            train_launches = counts()
            add(train_launches)
            check(sum(ins for step in inserted for ins in step.values()) > 0, f"{arch_id}: no row inserted")

            def run_step(b):
                nonlocal tstate
                tstate, _ = cell.step_fn(tstate, b)

            prof = profile_requests(f"{arch_id}_train_batch", run_step, tbatches[n_steps:n_steps + 1])
            emit(prof)
            repeat = []
            for _ in range(N_RM_REPEAT):
                tstate, out = cell.step_fn(tstate, tbatches[-1])
                repeat.append(float(out["loss"]))
            check(all(np.isfinite(repeat)) and repeat[-1] < repeat[0], f"{arch_id} loss on one repeated batch: {repeat}")
            st_a = np.array(step_ms)
            models[arch_id] = {"serve_p99": serve, "train_batch": {
                "batch": cell.shape["batch"], "warmup": N_TRAIN_WARMUP, "steps": N_RM_STEPS,
                "engine_ids_per_step": ids_per_step, "step_ms_p50": float(np.percentile(st_a, 50)),
                "step_ms_p99": float(np.percentile(st_a, 99)), "step_ms_mean": float(st_a.mean()), "step_ms": step_ms,
                "loss": losses, "idmap_inserted": inserted, "loss_on_one_repeated_batch": repeat,
                "max_memory_allocated_bytes_steps_1_2": train_peak, "allocated_before_bytes": base_bytes,
                "step_transient_bytes": train_peak - base_bytes, "state_bytes": tstate_bytes,
                "launches": train_launches, "launches_per_step": per_step[-1],
                "profile": {k: prof[k] for k in ("device_busy_ms_per_request", "device_idle_share",
                                                 "top_device_ms_per_request")}}}
            del cell, tstate, tbatches, out
            torch.cuda.empty_cache()
            models[arch_id]["kernels"] = measure(f"{arch_id.replace('-', '_')}_train", probes[arch_id])
            emit({"phase": "recsys_model", **device_info, "arch": arch_id, "source": arch.source,
                  "widths": dataclasses.asdict(mcfg), "reduced": {"devices": [256, 1]},
                  **models[arch_id], "part_s": time.perf_counter() - part_t0})
            torch.cuda.empty_cache()

        # ---------------------------------------------------- retrieval_cand
        retrieval = {}
        for arch_id in RETRIEVAL_ARCHS:
            part_t0 = time.perf_counter()
            cut = {"vocab_per_feature": VOCAB} if arch_id == "dlrm-mlperf" else {}
            arch = _recsys_arch(arch_id, **cut)
            vocab = _vocab(arch)
            cell = recsys_cell.build(arch, arch.shape("retrieval_cand"), device=dev)
            nc = cell.shape["n_candidates"]
            batches = [cell.make_batch(60_000 + 2 * s, vocab=vocab) for s in range(N_RETR_WARMUP + N_RETR)]
            ids = [cell.ids_fn(b) for b in batches]
            state = _without_engines(cell.init_state())
            rows, n_rows = _request_rows([cell.engine_user, cell.engine_cand] * len(ids),
                                         [x[p] for x in ids for p in ("user", "cand")], dev, scale=0.5)
            state["sparse_user"] = cell.engine_user.import_rows(rows)
            state["sparse_cand"] = cell.engine_cand.import_rows(rows)
            del rows, ids
            state_bytes = sum(t.numel() * t.element_size() for t in _tensors({
                k: state[k] for k in ("sparse_user", "sparse_cand")}))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            lat, uniq = [], []
            path = f"retrieval_{arch_id.replace('-', '_')}"
            for s, b in enumerate(batches):
                phase["name"] = path if s == N_RETR_WARMUP else None  # the first timed request
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = cell.step_fn(state, b)
                end.record()
                end.synchronize()
                phase["name"] = None
                if s >= N_RETR_WARMUP:
                    lat.append(start.elapsed_time(end))
                sc = out["scores"]
                met = {k: int(v) for k, v in out.items() if k != "scores"}
                check(sc.shape == (nc,) and sc.dtype == torch.float32 and bool(torch.isfinite(sc).all()),
                      f"{arch_id} retrieval scores")
                uniq.append(int(torch.unique(sc).numel()))
                check(uniq[-1] > 100, f"{arch_id} retrieval scores are degenerate: {uniq[-1]} distinct")
                check(all(v == 0 for k, v in met.items() if "overflow" in k), f"{arch_id} retrieval overflow: {met}")
            peak = torch.cuda.max_memory_allocated()
            launches = counts()
            add(launches)
            want = {k: (a + b) * len(batches) for (k, a), b in zip(
                _per_step(cell.engine_user, False).items(), _per_step(cell.engine_cand, False).values())}
            check(launches == want, f"{arch_id} retrieval launches {launches}, expected {want}")
            lat_a = np.array(lat)
            retrieval[arch_id] = {"n_candidates": nc, "vocab": vocab, "rows_imported": n_rows,
                                  "engines_state_bytes": state_bytes, "max_memory_allocated_bytes": peak,
                                  "latency_ms_p50": float(np.percentile(lat_a, 50)),
                                  "latency_ms_p99": float(np.percentile(lat_a, 99)), "latency_ms": lat,
                                  "distinct_scores": uniq, "launches": launches}
            del cell, state, batches, out, sc
            torch.cuda.empty_cache()
            # the candidates' row gather: the first timed request's largest
            big = max((k for k in recorded if len(k) == 3 and k[:2] == ("gather_rows", path)),
                      key=lambda k: recorded[k][0][1].numel())
            retrieval[arch_id]["kernels"] = measure(path, [("gather_rows", (big[2],), fg_ref.gather_rows,
                                                            "fused_gather.gather_rows")])
            emit({"phase": "recsys_retrieval", **device_info, "arch": arch_id, "source": arch.source,
                  "reduced": {"devices": [256, 1], **({"vocab_per_feature": [4_000_000, vocab]} if cut else {})},
                  **retrieval[arch_id], "part_s": time.perf_counter() - part_t0})
    finally:
        for mod, name, _, _ in wrapped:
            setattr(mod, name, real[name])  # the wrappers record no more

    # ------------------------------------------- the serve_retrieval twin's main()
    workdir = ROOT / "build" / "serve_retrieval"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        twin = serve_retrieval.main(["--device", "cuda", "--workdir", str(workdir)])
    twin_launches = counts()
    add(twin_launches)
    check(np.isfinite(twin["scores"]).all() and np.unique(twin["scores"]).size > 100,
          "serve_retrieval twin: scores not finite or degenerate")
    check(twin_launches["fused_gather.gather_rows"] > 0 and twin_launches["fused_scatter.scatter_add_rows"] > 0,
          f"serve_retrieval twin launches {twin_launches}")
    emit({"phase": "serve_retrieval_main", **device_info, "entry": "repro_torch.examples.serve_retrieval.main",
          "train_loss": twin["train_loss"], "train_overflow": twin["train_overflow"],
          "distinct_scores": int(np.unique(twin["scores"]).size), "latency_ms": twin["latency_ms"], "launches": twin_launches, "main_s": time.perf_counter() - t0,
          "printed_tail": printed.getvalue().strip().splitlines()[-3:]})
    shutil.rmtree(workdir, ignore_errors=True)
    check(all(total[k] > 0 for k in RECSYS_KERNELS), f"a kernel of the recsys paths never ran: {total}")
    emit({"phase": "recsys_models", **device_info, "launches": total, "phase_s": time.perf_counter() - phase_t0})
    torch.cuda.empty_cache()
    return total


KERNEL_NAMES = {"gather_rows": "gather_rows_kernel", "segment_sum_csr": "segment_sum_sorted_kernel",
                "segment_sum": "segment_sum_sorted_kernel",
                "segment_expand_csr": "segment_expand_csr_kernel", "scatter_add_rows": "scatter_rows_kernel",
                "scatter_set_rows": "scatter_rows_kernel", "segment_sum_csr_group": "segment_sum_group_kernel",
                "segment_expand_csr_group": "segment_expand_group_kernel"}


def writeback_device_ms(fn, iters: int = 30) -> float:
    """The device time of ``fn`` with the write-back of what it writes
    inside the window: CUDA events around ``fn`` and then a 256 MB read
    (buffer B), which evicts the lines ``fn`` left dirty in the 50 MB
    write-back L2, less the events around B's read alone; the median of
    ``iters`` pairs. Before each window a 1 GB read (buffer A) leaves the
    L2 cold and clean and gives the host time to enqueue the window. A
    scatter's trace event ends while its writes still sit in the L2, so
    ``kernel_device_ms`` can read it under its HBM bound."""
    pre = torch.zeros(1 << 28, dtype=torch.float32, device=torch.device("cuda"))
    post = torch.zeros(1 << 26, dtype=torch.float32, device=torch.device("cuda"))
    fn()
    torch.cuda.synchronize()
    diffs = []
    for _ in range(iters):
        ms = []
        for with_fn in (True, False):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            pre.amax()
            start.record()
            if with_fn:
                fn()
            post.amax()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        diffs.append(ms[0] - ms[1])
    del pre, post
    return float(np.median(diffs))


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
        if kname in ("segment_sum_csr", "segment_sum"):
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
        elif kname == "segment_sum":  # the id form: (N, D) values, ascending int32 ids, S segments
            vals, ids, S = args
            N, D = vals.shape
            ok_ids = (ids >= 0) & (ids < S)
            live = int(ok_ids.sum())
            n_bytes = (live * D + S * D) * 4 + N * ids.element_size()
            n_ops = float(live * D)
            shape = {"N": N, "live_rows": live, "D": D, "S": S, "ids": str(ids.dtype), "sorted": True}
            idx = torch.where(ok_ids, ids, S).long()
            del ok_ids
            lib = lambda: torch.zeros((S + 1, D), device=dev).index_add_(0, idx, vals)  # noqa: E731
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
    out = {"shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "host_us": host_us(run_kernel),
           "kernel_device_ms": kernel_device_ms(run_kernel, KERNEL_NAMES[kname])}
    if kname.startswith("scatter"):  # its writes' write-back, which the trace event leaves out
        out["writeback_device_ms"] = writeback_device_ms(run_kernel)
    return out


def _measure_group(kname: str, real, plain, args: list, iters: int, dev) -> dict:
    """The grouped segment sum or its gradient on one recorded input (a dim
    group's rows and its features' splits, slices and gradients): held to
    its plain version (the forward within rtol = atol = 1e-5 and bit-equal
    to the per-feature kernel on each slice, the gradient bit-equal), then
    timed beside the plain version and one library call on segment ids
    prebuilt for the group's rows (feature f's segment s is row base_f + s
    of one output): the forward's ``index_add_`` takes only the rows a
    segment covers, gathered beforehand; the gradient's ``index_select``
    reads a zero row for the rest. With the card's bound and the kernel's
    device time with a cold L2."""
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
        covered = idx != spare
        lib_vals, lib_idx = vals[covered], idx[covered]
        lib = lambda: torch.zeros((spare, D), device=dev).index_add_(0, lib_idx, lib_vals)  # noqa: E731
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

# ---------------------------------------------------------------------------
# 4 the multi-rank exchange (two ranks on one card over gloo; NCCL where the
# machine has two cards)
# ---------------------------------------------------------------------------
def _mr_rank(rank: int, world: int, backend: str, store: str, arch, n_warmup: int, n_steps: int,
             full: bool, turn, q) -> None:
    """One rank of the multi-rank phase (a spawned process): joins the
    group, waits for its ``turn`` (``_await_turn``), runs ``_mr_run`` and
    reports its result, or its traceback."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh

    try:
        group = mesh.init_group(backend, rank=rank, world_size=world, store_path=store)
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        _await_turn(turn)
        q.put((rank, True, _mr_run(rank, group, dev, arch, n_warmup, n_steps, full)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.close()


def _mr_spawn(backend: str, store: Path, arch, n_warmup: int, n_steps: int, full: bool) -> list:
    """Run ``_mr_rank`` on MR_RANKS spawned processes; stop them all, and
    fail with the first failing rank's traceback."""
    return _spawn_ranks(_mr_rank, MR_RANKS, (backend, str(store), arch, n_warmup, n_steps, full, None),
                        MR_TIMEOUT_S, "multi-rank")


def _to_host(a, whole: bool):
    """A host copy of a recorded argument (lists element by element); a
    table over 2^28 elements stays where it is unless ``whole``."""
    if isinstance(a, (list, tuple)):
        return type(a)(_to_host(x, whole) for x in a)
    if not torch.is_tensor(a):
        return a
    return a.detach() if a.numel() >= (1 << 28) and not whole else a.detach().cpu()


def _record_first(mod, name: str, whole: bool, on, recorded: dict, real: dict) -> None:
    """Wraps ``mod.name`` (in a rank's process) so that, while ``on()``, it
    keeps ``_to_host`` copies of its first call's inputs in
    ``recorded[name]``; the function it wrapped goes into ``real[name]``."""
    fn = real[name] = getattr(mod, name)

    def wrapper(*args, **kw):
        if on() and name not in recorded:
            recorded[name] = ([_to_host(a, whole) for a in args], kw)
        return fn(*args, **kw)
    setattr(mod, name, wrapper)


def _measure_in_turns(rank: int, group, plains: dict, recorded: dict, real: dict, iters: int, dev) -> dict:
    """Each kernel of ``plains`` (name -> plain version) on this rank's
    recorded inputs, held to its plain version and timed (``_measure``)
    while the other ranks wait, the ranks in turn."""
    import torch.distributed as dist

    from repro_torch.core import comm

    # a process's first profiler trace takes 11-13 s on the card: every
    # rank takes its own at once (before its turn, if ``_await_turn`` has
    # not), not in its turn
    kernel_device_ms(lambda: None, "", iters=1, tries=1)
    dist.barrier(group)
    out = {}
    for turn in range(comm.size(group)):
        if turn == rank:
            for name, plain in plains.items():
                check(name in recorded, f"rank {rank}: no recorded {name} call")
                args, kw = recorded.pop(name)
                out[name] = _measure(name, real[name], plain, _to_dev(args, dev), kw, iters, dev)
                del args
                torch.cuda.empty_cache()
        dist.barrier(group)
    return out


def _to_dev(a, dev):
    if isinstance(a, (list, tuple)):
        return type(a)(_to_dev(x, dev) for x in a)
    return a.to(dev) if torch.is_tensor(a) else a


def _rel(got: torch.Tensor, want: torch.Tensor, base: torch.Tensor) -> float:
    """|got - want| / |want - base| in float64 (Frobenius norms)."""
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm((want - base).double()).clamp_min(1e-300))


def _mr_save(engine, state, out_dir: Path, tag: str) -> int:
    """The one-rank run's export (sorted by id) and dense params under
    ``tag``, for the ranks to compare with; returns the rows' count."""
    rows = engine.export_rows(state["sparse"])["dim128"]
    order = np.argsort(rows["ids"])
    for k, v in (("ids", rows["ids"]), ("emb", rows["emb"]), ("m", rows["slots"]["m"]),
                 ("v", rows["slots"]["v"]), ("last_use", rows["last_use"])):
        np.save(out_dir / f"{tag}_{k}.npy", v[order])
    np.savez(out_dir / f"{tag}_dense.npz", **{k: v.detach().cpu().numpy() for k, v in state["dense"].state_dict().items()})
    return int(rows["ids"].size)


def _mr_compare(engine, state, dev, out_dir: Path, tag: str, rank: int | None) -> dict:
    """This process's export and dense params against the one-rank run's
    saved under ``tag``: the ids (the ones ``_owner_of`` gives ``rank``;
    all with no rank) bit-equal, each on its owner, and their last uses
    equal; the rows' update from their initial values, their moments and
    the dense params' update as |got − want| / |want − initial| with the
    largest differences; a hash of the dense params."""
    import hashlib

    from repro_torch.core import blocks, exchange

    rows = engine.export_rows(state["sparse"])["dim128"]
    order = np.argsort(rows["ids"])
    ids = rows["ids"][order]
    ids_all = np.load(out_dir / f"{tag}_ids.npy")
    want = ids_all if rank is None else ids_all[exchange._owner_of(torch.from_numpy(ids_all), MR_RANKS).numpy() == rank]
    out = {"n": int(ids.size), "ids_equal": bool(np.array_equal(ids, want)),
           "on_owner": rank is None or bool((exchange._owner_of(torch.from_numpy(ids), MR_RANKS).numpy() == rank).all())}
    if out["ids_equal"]:
        pos = np.searchsorted(ids_all, ids)
        out["last_use_equal"] = bool(np.array_equal(rows["last_use"][order], np.load(out_dir / f"{tag}_last_use.npy")[pos]))
        ids_dev = torch.from_numpy(ids).to(dev)
        for k in ("emb", "m", "v"):
            ref = torch.from_numpy(np.load(out_dir / f"{tag}_{k}.npy", mmap_mode="r")[pos]).to(dev)
            got = torch.from_numpy((rows["emb"] if k == "emb" else rows["slots"][k])[order]).to(dev)
            # the update from the rows' initial values (the moments start at 0)
            base = (blocks._hash_uniform(ids_dev, got.shape[1]) * float(np.float32(1.0 / np.sqrt(got.shape[1])))
                    if k == "emb" else torch.zeros_like(ref))
            out[f"{k}_rel_err"] = _rel(got, ref, base)
            out[f"{k}_max_abs_err"] = float((got - ref).abs().max())
            out[f"{k}_max_abs_update"] = float((ref - base).abs().max())
            del ref, got, base
    dense, dense0 = np.load(out_dir / f"{tag}_dense.npz"), np.load(out_dir / "one_rank_dense0.npz")
    mine = {k: v.detach().cpu().numpy() for k, v in state["dense"].state_dict().items()}
    flat = lambda d: torch.from_numpy(np.concatenate([d[k].ravel() for k in sorted(mine)]))  # noqa: E731
    out["dense_rel_err"] = _rel(flat(mine), flat(dense), flat(dense0))
    out["dense_max_abs_err"] = max(float(np.abs(v - dense[k]).max()) for k, v in mine.items())
    out["dense_sha256"] = hashlib.sha256(b"".join(mine[k].tobytes() for k in sorted(mine))).hexdigest()
    return out


def _mr_rows_ok(c: dict) -> bool:
    return c["ids_equal"] and c["on_owner"] and c["last_use_equal"]


def _mr_run(rank: int, group, dev, arch, n_warmup: int, n_steps: int, full: bool) -> dict:
    """This rank's train_batch steps on its slice of every global batch
    (step times, losses, launches a step, staged bytes); when ``full``,
    also after the first step its rows and dense params against the
    one-rank run's and two serve_p99 requests, after the last its rows and
    dense params again, each kernel of the path held to its plain version
    and timed on the inputs the last warm-up step gave it (the ranks in
    turn), and compressed_psum and the ZeRO-1 update on CUDA tensors
    against the CPU."""
    from repro_torch.core import comm
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.launch import recsys_cell
    from repro_torch.models import layers
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recsys_cell.MIXED = layers.FP32  # this process runs this phase only
    out_dir = ROOT / "build" / "multi_rank"
    cell = recsys_cell.build(arch, arch.shape("train_batch"), device=dev, group=group)
    spec = cell.engine.groups["dim128"].exchange
    state = cell.init_state()
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()

    # the first call of each kernel from the last warm-up step on (the set:
    # from the first step after it that inserts rows), kept on the host so
    # that the timed steps and the peak are those of the path alone
    kernels = (("gather_rows", fg_ops, fg_ref, False), ("segment_sum_csr_group", sr_ops, sr_ref, False),
               ("segment_expand_csr_group", sr_ops, sr_ref, False), ("scatter_add_rows", fs_ops, fs_ref, True),
               ("scatter_set_rows", fs_ops, fs_ref, True))
    probe, recorded, real = {"on": False}, {}, {}
    if full:
        for name, mod, _, whole in kernels:
            _record_first(mod, name, whole, lambda: probe["on"], recorded, real)
    plain_a2a, a2a_s = comm.all_to_all, [0.0]

    def timed_a2a(x, grp):  # the host time of each all_to_all, the copies to and from the host included
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_a2a(x, grp)
        torch.cuda.synchronize()
        a2a_s[0] += time.perf_counter() - t0
        return out

    comm.all_to_all = timed_a2a
    step_ms, losses, per_step, staged, mets, a2a_ms = [], [], [], [], [], []
    for s in range(n_warmup + n_steps):
        batch = cell.make_batch(MR_SEED + s, vocab=VOCAB)
        before, st0, a2a_s[0] = kernel_counts(), comm.STAGED_BYTES, 0.0
        probe["on"] = full and s >= n_warmup - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, o = cell.step_fn(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if s >= n_warmup:
            step_ms.append(ms)
        per_step.append({k: v - before[k] for k, v in kernel_counts().items() if v - before[k]})
        staged.append(comm.STAGED_BYTES - st0)
        a2a_ms.append(a2a_s[0] * 1e3)
        losses.append(float(o["loss"]))
        mets.append({k: int(v) for k, v in o.items() if k != "loss"})
        if full and s == 0:  # a warm-up step: held before Adam's sign noise builds up
            step1 = _mr_compare(cell.engine, state, dev, out_dir, "one_step1", rank)
            serve = recsys_cell.build(arch, arch.shape("serve_p99"), device=dev, group=group)
            serve_logits, serve_ms, serve_met = [], [], []
            for i in range(MR_SERVE):
                sbatch = serve.make_batch(MR_SEED + 100 + i, vocab=VOCAB)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                so = serve.step_fn(state, sbatch)
                torch.cuda.synchronize()
                serve_ms.append((time.perf_counter() - t0) * 1e3)
                serve_logits.append(so["logits"].cpu().numpy().tolist())
                serve_met.append({k: int(v) for k, v in so.items() if k != "logits"})
            del serve, so
    peak = torch.cuda.max_memory_allocated()
    comm.all_to_all = plain_a2a
    for name, mod, _, _ in kernels:  # no more records
        if name in real:
            setattr(mod, name, real[name])
    res = {"rank": rank, "transport": comm.transport(group, dev), "step_ms": step_ms, "loss": losses,
           "metrics": mets, "launches_per_step": per_step, "staged_bytes_per_step": staged,
           "a2a_ms_per_step": a2a_ms,
           "max_memory_allocated_bytes": peak, "state_bytes": state_bytes,
           "rows_per_shard": cell.engine.groups["dim128"].rows_per_shard,
           "a2a_bytes_per_step": {"ids": spec.n_devices * spec.per_dest_cap * 8,
                                  "reply_rows": spec.n_devices * spec.per_dest_cap * 128 * 4,
                                  "reply_grads": spec.n_devices * spec.per_dest_cap * 128 * 4},
           "per_dest_cap": spec.per_dest_cap}
    if not full:
        return res

    res.update(step1=step1, serve_logits=serve_logits, serve_ms=serve_ms, serve_metrics=serve_met,
               final=_mr_compare(cell.engine, state, dev, out_dir, "one_final", rank),
               launches=kernel_counts())  # the train steps and the serve requests

    # each kernel on this rank's recorded inputs, held to its plain version
    # and timed while the other rank waits
    res["kernels"] = _measure_in_turns(rank, group, {name: getattr(ref_mod, name) for name, _, ref_mod, _ in kernels},
                                       recorded, real, 20, dev)

    # compressed_psum and ZeRO-1 on CUDA tensors against the CPU
    gen = torch.Generator().manual_seed(SEED + 7 + rank)
    g, e = torch.randn(1 << 20, generator=gen), torch.randn(1 << 20, generator=gen) * 1e-3
    s_cpu, e_cpu = adamw.compressed_psum(g, group, e)
    s_gpu, e_gpu = adamw.compressed_psum(g.to(dev), group, e.to(dev))
    res["compressed_psum"] = {"n": g.numel(), "sum_bit_equal": bool(torch.equal(s_gpu.cpu(), s_cpu)),
                              "error_bit_equal": bool(torch.equal(e_gpu.cpu(), e_cpu))}
    params = {k: v.detach().clone() for k, v in state["dense"].named_parameters()}
    dims = adamw.zero1_dims({}, params)
    cfg = adamw.AdamWConfig()
    full_p = {k: v.clone() for k, v in params.items()}
    cpu_p = {k: v.detach().cpu().clone() for k, v in params.items()}
    st_sh, st_full, st_cpu = adamw.zero1_init(params, dims, group), adamw.init(full_p), adamw.init(cpu_p)
    gen = torch.Generator().manual_seed(SEED + 8)  # the same gradients on every rank
    for step in range(1, 4):
        grads = {k: torch.randn(v.shape, generator=gen) * 1e-2 for k, v in params.items()}
        adamw.update(cfg, cpu_p, grads, st_cpu, torch.tensor(step))
        grads = {k: v.to(dev) for k, v in grads.items()}
        adamw.zero1_update(cfg, params, grads, st_sh, torch.tensor(step, device=dev), dims, group)
        adamw.update(cfg, full_p, grads, st_full, torch.tensor(step, device=dev))
    res["zero1"] = {
        "sharded": sorted(k for k, d in dims.items() if d is not None),
        "moment_bytes": sum(v.numel() * 4 for v in st_sh["m"].values()) * 2,
        "unsharded_moment_bytes": sum(v.numel() * 4 for v in st_full["m"].values()) * 2,
        "bit_equal_to_unsharded": all(torch.equal(params[k], full_p[k]) for k in params),
        "max_abs_err_vs_cpu": max(float((params[k].cpu() - cpu_p[k]).abs().max()) for k in params)}
    return res


def multi_rank_phase(arch, dev, device_info: dict, by_name: dict) -> dict:
    """dlrm-mlperf train_batch at published widths (vocab cut to VOCAB a
    feature) on one rank in this process, then over two gloo ranks sharing
    the card, each holding half of every table, on the same global
    batches, in FP32: losses, the summed counters, the launches of every
    step on every rank; after the first step the ranks' exports against the
    one-rank export (ids bit-equal, each on its owner; the rows' updates and
    moments and the dense params' update within MR_REL_TOL of the one-rank
    run's, the dense params bit-equal across the ranks) and two serve_p99
    requests over both ranks against the one-rank logits; after the last
    step the ids, owners and last uses again, and the drift of the values
    beside that of the one-rank run with its dense params perturbed by
    MR_PERTURB after its first step; each kernel of the path on each rank's recorded
    inputs (added to the kernel entries' ``at`` as ``multi_rank_r<rank>``);
    compressed_psum and the ZeRO-1 update on CUDA tensors against the CPU.
    Over NCCL (one card a rank) only where the machine has two cards.
    Returns the launches of the two ranks' train and serve runs, summed."""
    from repro_torch.launch import recsys_cell
    from repro_torch.models import layers

    phase_t0 = time.perf_counter()
    out_dir = ROOT / "build" / "multi_rank"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n_all = MR_WARMUP + MR_STEPS

    # the ranks of (b) start now: they reach the card and take their first
    # trace while (a) runs, then wait for their turn
    early = EarlyRanks(_mr_rank, MR_RANKS, ("gloo", str(out_dir / "store"), arch, MR_WARMUP, MR_STEPS, True),
                       MR_TIMEOUT_S, "multi-rank")
    try:
        # (a) one rank, in this process, on the same global batches, in FP32
        recsys_cell.MIXED = layers.FP32
        one = recsys_cell.build(arch, arch.shape("train_batch"), device=dev)
        state = one.init_state()
        np.savez(out_dir / "one_rank_dense0.npz",
                 **{k: v.detach().cpu().numpy() for k, v in state["dense"].state_dict().items()})
        serve = recsys_cell.build(arch, arch.shape("serve_p99"), device=dev)
        one_ms, one_loss, one_met = [], [], []
        for s in range(n_all):
            batch = one.make_batch(MR_SEED + s, vocab=VOCAB)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, o = one.step_fn(state, batch)
            torch.cuda.synchronize()
            if s >= MR_WARMUP:
                one_ms.append((time.perf_counter() - t0) * 1e3)
            one_loss.append(float(o["loss"]))
            one_met.append({k: int(v) for k, v in o.items() if k != "loss"})
            check(all(v == 0 for k, v in one_met[-1].items() if "overflow" in k), f"one-rank overflow: {one_met[-1]}")
            if s == 0:
                _mr_save(one.engine, state, out_dir, "one_step1")
                one_logits = [serve.step_fn(state, serve.make_batch(MR_SEED + 100 + i, vocab=VOCAB))["logits"].cpu().numpy()
                              for i in range(MR_SERVE)]
        n_rows = _mr_save(one.engine, state, out_dir, "one_final")
        del state, batch, o
        torch.cuda.empty_cache()

        # (a') the drift a rounding alone makes: the same one-rank run with its
        # dense params scaled by 1 + MR_PERTURB * N(0, 1) after its first step
        state = one.init_state()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for s in range(n_all):
            state, _ = one.step_fn(state, one.make_batch(MR_SEED + s, vocab=VOCAB))
            if s == 0:
                with torch.no_grad():
                    for p in state["dense"].parameters():
                        p.mul_(1 + MR_PERTURB * torch.randn(p.shape, generator=gen, device=dev))
        perturbed = _mr_compare(one.engine, state, dev, out_dir, "one_final", None)
        recsys_cell.MIXED = layers.MIXED
        del one, serve, state
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < (1 << 30), f"{held} bytes still allocated before the ranks start")
    except BaseException:
        early.stop()
        raise
    one_s = time.perf_counter() - phase_t0

    # (b) two ranks on this card over gloo
    t0 = time.perf_counter()
    ranks = early.results()
    ranks_s = time.perf_counter() - t0  # after their start
    for r in ranks:
        check(r["transport"] == "gloo, host-staged", f"rank {r['rank']}: transport {r['transport']}")
        check(np.allclose(r["loss"], one_loss, **MR_FP32_TOL), f"rank {r['rank']} losses {r['loss']} vs {one_loss}")
        for at in ("step1", "final"):
            check(r[at]["dense_sha256"] == ranks[0][at]["dense_sha256"], f"the ranks' dense params differ ({at})")
            check(_mr_rows_ok(r[at]), f"rank {r['rank']} rows ({at}) {r[at]}")
        c = r["step1"]
        check(all(c[f"{k}_rel_err"] <= MR_REL_TOL for k in ("emb", "m", "v", "dense")),
              f"rank {r['rank']} after the first step {c}")
        for s, (m, m1) in enumerate(zip(r["metrics"], one_met)):
            check(all(v == 0 for k, v in m.items() if "overflow" in k), f"rank {r['rank']} overflow at {s + 1}: {m}")
            check(m["dim128/idmap_inserted"] == m1["dim128/idmap_inserted"]
                  and m["dim128/dev_rows_live"] == m1["dim128/dev_rows_live"]
                  and all(m[k] == m1[k] for k in m1 if "exch_" in k), f"step {s + 1} counters {m} vs {m1}")
        for s, n in enumerate(r["launches_per_step"]):
            check(all(n.get(k, 0) == v for k, v in MR_PER_STEP.items())
                  and n.get("fused_scatter.scatter_set_rows", 0) in (0, 3)  # new rows: emb, m and v
                  and set(n) <= set(MR_PER_STEP) | {"fused_scatter.scatter_set_rows"},
                  f"rank {r['rank']} step {s + 1} launches {n}")
        check(sum(n.get("fused_scatter.scatter_set_rows", 0) for n in r["launches_per_step"]) > 0,
              f"rank {r['rank']}: no row was initialised")
        for name, m in r["kernels"].items():
            _add_path(by_name[next(e for e in DLRM_TRAIN_KERNELS if e.endswith("." + name))],
                      f"multi_rank_r{r['rank']}", m)
        for m in r["serve_metrics"]:
            check(all(v == 0 for k, v in m.items() if "overflow" in k), f"serve overflow {m}")
        check(r["compressed_psum"]["sum_bit_equal"] and r["compressed_psum"]["error_bit_equal"],
              f"compressed_psum on the card differs from the CPU's: {r['compressed_psum']}")
        check(r["zero1"]["bit_equal_to_unsharded"] and r["zero1"]["max_abs_err_vs_cpu"] <= 1e-6
              and r["zero1"]["moment_bytes"] < r["zero1"]["unsharded_moment_bytes"], f"zero1 {r['zero1']}")
    check(sum(r["final"]["n"] for r in ranks) == n_rows, "the ranks' exports do not add up to the one-rank export")
    check(_mr_rows_ok(perturbed), f"the perturbed one-rank run's rows {perturbed}")
    logit_err = 0.0
    for i in range(MR_SERVE):
        got = np.concatenate([np.asarray(r["serve_logits"][i], np.float32) for r in ranks])
        check(got.shape == one_logits[i].shape and np.all(np.isfinite(got)), f"serve logits {got.shape}")
        check(np.allclose(got, one_logits[i], **MR_FP32_TOL), f"serve request {i}: logits off the one-rank run's")
        logit_err = max(logit_err, float(np.abs(got - one_logits[i]).max()))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}

    # (c) NCCL, one card a rank, only where there are two
    n_cards = torch.cuda.device_count()
    if n_cards >= MR_RANKS:
        nccl = _mr_spawn("nccl", out_dir / "store_nccl", arch, 0, MR_NCCL_STEPS, False)
        check(all(np.allclose(r["loss"], one_loss[:MR_NCCL_STEPS], **MR_FP32_TOL) for r in nccl),
              f"NCCL losses {[r['loss'] for r in nccl]}")
        nccl_out = {"run": True, "steps": MR_NCCL_STEPS, "loss": nccl[0]["loss"],
                    "step_ms": [r["step_ms"] for r in nccl], "transport": nccl[0]["transport"]}
    else:
        nccl_out = {"run": False, "why": f"{n_cards} card(s): NCCL needs one card a rank"}

    a2a = ranks[0]["a2a_bytes_per_step"]
    emit({"phase": "multi_rank", **device_info, "arch": arch.arch_id, "batch": arch.shape("train_batch")["batch"],
          "ranks": MR_RANKS, "transport": "gloo, one card, host-staged (not NCCL, not NVLink)",
          "precision": "fp32 (the cells' MIXED set to FP32, TF32 off), both runs",
          "reduced": {"vocab_per_feature": [4_000_000, VOCAB], "devices": [256, MR_RANKS]},
          "warmup": MR_WARMUP, "steps": MR_STEPS, "rows_per_shard": ranks[0]["rows_per_shard"],
          "per_dest_cap": ranks[0]["per_dest_cap"],
          "step_ms_p50_by_rank": [float(np.percentile(r["step_ms"], 50)) for r in ranks],
          "step_ms_by_rank": [r["step_ms"] for r in ranks],
          "one_rank_step_ms_p50": float(np.percentile(one_ms, 50)), "one_rank_step_ms": one_ms,
          "loss": ranks[0]["loss"], "one_rank_loss": one_loss,
          "a2a_bytes_per_step_per_rank": a2a,
          "staged_bytes_per_step_by_rank": [r["staged_bytes_per_step"] for r in ranks],
          "a2a_ms_per_step_by_rank": [r["a2a_ms_per_step"] for r in ranks],
          "max_memory_allocated_bytes_by_rank": [r["max_memory_allocated_bytes"] for r in ranks],
          "state_bytes_by_rank": [r["state_bytes"] for r in ranks],
          "after_step1_by_rank": [r["step1"] for r in ranks], "rel_tol": MR_REL_TOL,
          "after_last_step_by_rank": [r["final"] for r in ranks], "one_rank_rows": n_rows,
          "one_rank_perturbed_after_last_step": {"perturbation": MR_PERTURB, **perturbed},
          "kernels_by_rank": [{k: {f: m[f] for f in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "kernel_device_ms")}
                               for k, m in r["kernels"].items()} for r in ranks],
          "serve_p99_ms_by_rank": [r["serve_ms"] for r in ranks], "serve_logits_max_abs_err": logit_err,
          "launches_per_step_by_rank": [r["launches_per_step"] for r in ranks], "launches": launches,
          "compressed_psum": [r["compressed_psum"] for r in ranks], "zero1": [r["zero1"] for r in ranks],
          "nccl": nccl_out, "one_rank_s": one_s, "ranks_s": ranks_s,
          "phase_s": time.perf_counter() - phase_t0})
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches



# ---------------------------------------------------------------------------
# 4 the GNN family (gin-tu): smoke cells card against CPU, the four shape
# cells at published widths, the kernels at ogb_products' shapes, two gloo
# ranks sharing the card, the train driver
# ---------------------------------------------------------------------------
# the scale of minibatch_lg and ogb_products cut, their widths kept (as
# tests/test_torch_gnn.py); full_graph_sm and molecule as published
GNN_SMOKE_SHAPES = {"full_graph_sm": {}, "minibatch_lg": {"batch_nodes": 16},
                    "ogb_products": {"n_nodes": 4_000, "n_edges": 30_001}, "molecule": {}}
GNN_SHAPE_NAMES = ("ogb_products", "minibatch_lg", "molecule", "full_graph_sm")
GNN_WARMUP, GNN_STEPS, GNN_RANK_STEPS, GNN_SMOKE_STEPS = 3, 5, 1, 3
GNN_LR = 1e-3
GNN_MIXED_LOSS_ATOL = 1e-2  # about one bf16 ulp of a loss near 1.6 (tests/test_torch_gnn.py)
# MIXED: the params' update after step 1 against the CPU's as a relative
# norm (tests/test_torch_gnn.py::MIXED_UPDATE_RTOL: a skipped update is off
# by 1, one of the wrong sign by 2)
GNN_MIXED_UPDATE_RTOL = 0.5
GNN_REL_TOL = 1e-4          # the ranks' update, m and v against the one-rank run's, after step 1
GNN_TIMEOUT_S = 600.0
GNN_RANKS = 2


def _gnn_per_step(task: str) -> dict:
    """Launches a GIN train step makes (5 layers): a segment sum a layer and
    its gradient (the row gather), and in the graph task as many again for
    the readout pooling."""
    n = 5 * (2 if task == "graph" else 1)
    return {"segment_reduce.segment_sum": n, "fused_gather.gather_rows": n}


def _gnn_shape(arch, name: str, change: dict | None = None):
    from repro_torch.configs.base import ShapeCell

    s = arch.shape(name)
    return ShapeCell(name, s.kind, {**s.params, **(change or {})})


def _adam_atol(v: torch.Tensor, steps: int) -> torch.Tensor:
    """Adam's per-element sensitivity to a gradient that moves by 1e-6 of
    the leaf's largest (tests/test_torch_gnn.py::_adam_atol)."""
    vhat = v.double() / (1 - 0.999 ** steps)
    dg = 1e-6 * float(vhat.max().sqrt())
    return torch.clamp(steps * GNN_LR * dg / (vhat.sqrt() + 1e-8), max=2 * GNN_LR * steps)


def _gnn_state(st) -> dict:
    """Host copies of a GIN train state's params and AdamW moments."""
    return {"p": {k: v.detach().cpu().clone() for k, v in st["dense"].named_parameters()},
            "m": {k: v.detach().cpu().clone() for k, v in st["opt"]["m"].items()},
            "v": {k: v.detach().cpu().clone() for k, v in st["opt"]["v"].items()}}


def _gnn_sha(params: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gnn_smoke(dev) -> dict:
    """(a) The smoke model (2 layers, d 16) in the four shape cells, and the
    molecule cell with compress_grads, three steps on the card against the
    CPU from the same params and batches: losses every step, params and
    moments after the first step; FP32 within 1e-5 (params plus Adam's
    sensitivity), MIXED within GNN_MIXED_LOSS_ATOL (losses), the params'
    update within GNN_MIXED_UPDATE_RTOL as a relative norm and the moments
    within 5e-2 of their largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.launch import gnn_cell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import layers

    arch = get_config("gin-tu", smoke=True)
    out = {}
    for name, change in GNN_SMOKE_SHAPES.items():
        for prec in ("fp32", "mixed"):
            for compress in ((False, True) if name == "molecule" else (False,)):
                gnn_cell.MIXED = layers.FP32 if prec == "fp32" else layers.MIXED
                runs = []
                try:
                    for where in (dev, torch.device("cpu")):
                        cell = build_arch_cell(arch, _gnn_shape(arch, name, change),
                                               CellOptions(compress_grads=compress), device=where)
                        st, losses = cell.init_state(), []
                        p0 = _gnn_state(st)["p"]
                        for s in range(GNN_SMOKE_STEPS):
                            st, o = cell.step_fn(st, cell.make_batch(s))
                            losses.append(float(o["loss"]))
                            if s == 0:
                                first = _gnn_state(st)
                        runs.append((losses, first))
                finally:
                    gnn_cell.MIXED = layers.MIXED
                (lc, fc), (lh, fh) = runs  # the card's, the CPU's
                loss_err = max(abs(a - b) for a, b in zip(lc, lh))
                excess = -float("inf")
                for part in ("p", "m", "v") if prec == "fp32" else ("m", "v"):
                    scale = max(float(t.abs().max()) for t in fh[part].values())
                    for k, want in fh[part].items():
                        if prec == "fp32":
                            atol = 1e-5 * scale + (_adam_atol(fh["v"][k], 1) if part == "p" else 0.0)
                        else:
                            atol = 5e-2 * scale
                        excess = max(excess, float(((fc[part][k] - want).abs().double() - atol).max()))
                upd = _rel(torch.cat([fc["p"][k].reshape(-1) for k in sorted(p0)]),
                           torch.cat([fh["p"][k].reshape(-1) for k in sorted(p0)]),
                           torch.cat([p0[k].reshape(-1) for k in sorted(p0)]))
                key = f"{name}-{prec}" + ("-compressed" if compress else "")
                out[key] = {"loss_card": lc, "loss_cpu": lh, "loss_max_abs_err": loss_err,
                            "state_step1_excess_over_tol": excess, "update_step1_rel_err": upd}
                check(all(np.isfinite(lc)) and loss_err <= (1e-5 if prec == "fp32" else GNN_MIXED_LOSS_ATOL),
                      f"gnn smoke {key}: losses card {lc} vs CPU {lh}")
                check(excess <= 0.0 and (prec == "fp32" or upd <= GNN_MIXED_UPDATE_RTOL),
                      f"gnn smoke {key}: state after step 1 off the CPU's by {excess} over its tolerance, "
                      f"update {upd} relative")
    return out


def _gnn_train(arch, name: str, dev, counts, reset_counts, phase: dict | None = None,
               profile: bool = False) -> tuple[dict, object, object]:
    """(b) One shape cell at published widths from a fresh state (MIXED), on
    one batch repeated (make_batch at these sizes is seconds of numpy):
    GNN_WARMUP + GNN_STEPS steps, the launches of each held to the path's,
    finite losses falling over the run, step p50 and p99 by the host clock
    (synced), max_memory_allocated; with ``profile`` a torch.profiler trace
    of one more step; with ``phase`` (main()'s) one more step run as phase
    ``gnn_ogb``, whose recorders keep their first call's inputs. Returns
    the line, the state and the batch."""
    from repro_torch.launch.cells import build_arch_cell

    t0 = time.perf_counter()
    shape = arch.shape(name)
    cell = build_arch_cell(arch, shape, device=dev)
    st = cell.init_state()
    batch = cell.make_batch(SEED)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    task = "graph" if shape.kind == "graph_batch" else "node"
    want = _gnn_per_step(task)
    losses, ms, per_step = [], [], []
    for s in range(GNN_WARMUP + GNN_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, o = cell.step_fn(st, batch)
        torch.cuda.synchronize()
        if s >= GNN_WARMUP:
            ms.append((time.perf_counter() - t1) * 1e3)
        per_step.append({k: v for k, v in counts().items() if v})
        losses.append(float(o["loss"]))
    launches = {k: sum(n.get(k, 0) for n in per_step) for k in counts()}
    peak = torch.cuda.max_memory_allocated()
    check(all(n == want for n in per_step), f"gnn {name}: launches a step {per_step}, expected {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"gnn {name}: losses {losses}")
    line = {"phase": f"gnn_train_{name}", "arch": arch.arch_id, "shape": dict(shape.params), "task": task,
            "precision": "mixed (bf16 MLPs, fp32 sums)", "warmup": GNN_WARMUP, "steps": GNN_STEPS,
            "step_ms_p50": float(np.percentile(ms, 50)), "step_ms_p99": float(np.percentile(ms, 99)),
            "step_ms": ms, "loss": losses, "batch_make_s": batch_s, "launches_per_step": per_step[-1],
            "max_memory_allocated_bytes": peak, "state_and_batch_bytes": held}
    if profile:
        def run(b):
            nonlocal st
            st, _ = cell.step_fn(st, b)
        reset_counts()
        line["profile"] = profile_requests(f"gnn_{name}_train", run, [batch])
        launches = {k: launches[k] + v for k, v in counts().items()}  # the trace's warm-up call and traced step
    if phase is not None:
        reset_counts()
        phase["name"] = "gnn_ogb"
        try:
            st, _ = cell.step_fn(st, batch)
            torch.cuda.synchronize()
        finally:
            phase["name"] = None
        launches = {k: launches[k] + v for k, v in counts().items()}
    line["launches"] = {k: v for k, v in launches.items() if v}
    line["phase_s"] = time.perf_counter() - t0
    return line, launches, (st, batch)


def _gnn_rank(rank: int, world: int, store: str, turn, q) -> None:
    """One rank of the GNN phase's two-rank run (a spawned process): joins
    the gloo group, waits for its ``turn`` (``_await_turn``), runs
    ``_gnn_rank_run`` and reports its result, or its traceback."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh

    try:
        group = mesh.init_group("gloo", rank=rank, world_size=world, store_path=store)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        _await_turn(turn)
        torch.backends.cuda.matmul.allow_tf32 = False
        q.put((rank, True, _gnn_rank_run(rank, group, dev)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.close()


def _gnn_rank_run(rank: int, group, dev) -> dict:
    """This rank's part of ogb_products edge-parallel (its half of the
    edges), FP32: the state after the first step, and the first segment sum
    and gather of that step held to their plain versions and timed on their
    inputs (the ranks in turn); then GNN_RANK_STEPS timed steps (the host
    clock, synced) with each step's all-reduce bytes and ms (each
    collective timed between two synchronises), launches and peak memory;
    then the molecule cell with compress_grads for three steps, its local
    batches kept for the one-rank run."""
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.launch import gnn_cell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import layers

    arch = get_config("gin-tu")
    gnn_cell.MIXED = layers.FP32
    real_all_reduce, ar = comm.all_reduce, {"ms": 0.0, "calls": 0, "bytes": 0}

    def timed_all_reduce(x, group, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_all_reduce(x, group, *a, **kw)
        torch.cuda.synchronize()
        ar["ms"] += (time.perf_counter() - t0) * 1e3
        ar["calls"] += 1
        ar["bytes"] += x.numel() * x.element_size()
        return out

    comm.all_reduce = timed_all_reduce
    probe, recorded, real = {"on": True}, {}, {}
    _record_first(sr_ops, "segment_sum", False, lambda: probe["on"], recorded, real)
    _record_first(fg_ops, "gather_rows", False, lambda: probe["on"], recorded, real)
    try:
        cell = build_arch_cell(arch, arch.shape("ogb_products"), device=dev, group=group)
        st = cell.init_state()
        p0 = {k: v.detach().cpu().clone() for k, v in st["dense"].named_parameters()}
        batch = cell.make_batch(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, per_step, ar_ms, ar_bytes, ar_calls, staged_bytes = [], [], [], [], [], [], []
        for s in range(1 + GNN_RANK_STEPS):
            reset_kernel_counts()
            ar.update(ms=0.0, calls=0, bytes=0)
            staged = comm.STAGED_BYTES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, o = cell.step_fn(st, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(o["loss"]))
            per_step.append({k: v for k, v in kernel_counts().items() if v})
            ar_ms.append(ar["ms"])
            ar_calls.append(ar["calls"])
            ar_bytes.append(ar["bytes"])
            staged_bytes.append(comm.STAGED_BYTES - staged)  # to the host and back
            if s == 0:
                step1 = _gnn_state(st)
                sha1 = _gnn_sha(st["dense"].state_dict())
                probe["on"] = False
                kernels = _measure_in_turns(rank, group, {"segment_sum": sr_ref.segment_sum,
                                                          "gather_rows": fg_ref.gather_rows}, recorded, real, 5, dev)
                torch.cuda.reset_peak_memory_stats()  # the timed steps' peak
        out = {"rank": rank, "transport": comm.transport(group, dev), "loss": losses, "step_ms": ms[1:],
               "step1": {part: {k: v.numpy() for k, v in d.items()} for part, d in step1.items()},
               "p0": {k: v.numpy() for k, v in p0.items()}, "dense_sha256_step1": sha1,
               "dense_sha256_final": _gnn_sha(st["dense"].state_dict()), "launches_per_step": per_step,
               "all_reduce_ms_per_step": ar_ms[1:], "all_reduce_bytes_per_step": ar_bytes[1:],
               "all_reduce_calls_per_step": ar_calls[1:], "staged_bytes_per_step": staged_bytes[1:],
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "kernels": kernels}
        del st, batch, cell
        torch.cuda.empty_cache()

        cell = build_arch_cell(arch, arch.shape("molecule"), CellOptions(compress_grads=True), device=dev,
                               group=group)
        st, mol_loss, mol_batches = cell.init_state(), [], []
        for s in range(GNN_SMOKE_STEPS):
            b = cell.make_batch(SEED + s)
            mol_batches.append({f: x.cpu().numpy() for f, x in b._asdict().items()})
            st, o = cell.step_fn(st, b)
            mol_loss.append(float(o["loss"]))
        tree = cell.state_tree(st)
        out.update(molecule_loss=mol_loss, molecule_batches=mol_batches,
                   molecule_ef_shape=list(tree["ef"]["encoder"]["w"].shape),
                   molecule_ef_max_abs=max(float(v.abs().max()) for v in st["ef"].values()),
                   molecule_dense_sha256=_gnn_sha(st["dense"].state_dict()))
        return out
    finally:
        comm.all_reduce = real_all_reduce
        sr_ops.segment_sum, fg_ops.gather_rows = real["segment_sum"], real["gather_rows"]
        gnn_cell.MIXED = layers.MIXED


def _await_turn(turn) -> None:
    """In a rank spawned ahead of its turn (``turn``: the (go, stop) pair of
    ``EarlyRanks``; None: no wait): the card reached and the process's first
    profiler trace (11-13 s) taken now, then the wait for ``go``; a set
    ``stop`` sends the rank home."""
    if turn is None:
        return
    go, stop = turn
    kernel_device_ms(lambda: None, "", iters=1, tries=1)
    go.wait()
    if stop.value:
        raise SystemExit("stopped before its turn")


class EarlyRanks:
    """The ranks of ``target`` (``_spawn_ranks`` in a thread) spawned now,
    so that their start, their reach of the card and their first profiler
    trace overlap this process's work; each waits in ``_await_turn`` until
    ``results()`` lets it run, or ``stop()`` sends it home. ``target``
    takes the (go, stop) pair before its result queue."""

    def __init__(self, target, n: int, args: tuple, timeout: float, what: str):
        ctx = mp.get_context("spawn")
        self.go, self.stop_flag, self.out = ctx.Event(), ctx.Value("b", 0), {}
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       args=(target, n, (*args, (self.go, self.stop_flag)), timeout, what))
        self.thread.start()

    def _run(self, *a) -> None:
        try:
            self.out["ranks"] = _spawn_ranks(*a)
        except BaseException as e:  # re-raised by results()
            self.out["error"] = e

    def results(self) -> list:
        self.go.set()
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["ranks"]

    def stop(self) -> None:
        if not self.go.is_set():
            self.stop_flag.value = 1
            self.go.set()
        self.thread.join(timeout=120)


def _spawn_ranks(target, n: int, args: tuple, timeout: float, what: str) -> list:
    """Run ``target(rank, n, *args, q)`` on n spawned processes; stop them
    all, and fail with the first failing rank's traceback."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, n, *args, q)) for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n and not errors:
            try:
                rank, ok, val = q.get(timeout=5)
            except queue.Empty:  # a rank that died without a word, or the time is up
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks exited {dead}" if dead else f"no result in {timeout} s")
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=10 if errors else 120)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors and len(results) == n, f"{what}: " + ("\n".join(errors) or "a rank never reported"))
    return [results[r] for r in range(n)]


def _gnn_driver(counts, reset_counts) -> tuple[dict, dict]:
    """(e) The train driver (repro_torch.launch.train.run) with --arch gin-tu
    at published widths (its molecule shape): 6 steps saving every 3, then
    3 steps in a second directory and a resume there to 6; the resumed
    steps' losses within 1e-5 of the uninterrupted run's (the scatter-add
    backward of the message gather sums in any order), the checkpoint under
    the reference's state names."""
    from repro_torch.checkpoint import saver
    from repro_torch.configs import get_config
    from repro_torch.launch import train as t_train

    out_dir = ROOT / "build" / "gnn_driver"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    arch = get_config("gin-tu")
    p = t_train.build_parser()
    base = ["--arch", "gin-tu", "--batch", "128", "--log-every", "1", "--ckpt-every", "3"]
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        t_train.run(p.parse_args(base + ["--steps", "6", "--ckpt-dir", str(out_dir / "a"),
                                         "--telemetry", str(out_dir / "a.jsonl")]), arch)
        t_train.run(p.parse_args(base + ["--steps", "3", "--ckpt-dir", str(out_dir / "b")]), arch)
        res, _ = t_train.run(p.parse_args(base + ["--steps", "6", "--ckpt-dir", str(out_dir / "b"), "--resume",
                                                  "--telemetry", str(out_dir / "r.jsonl")]), arch)
    torch.cuda.synchronize()
    launches = counts()
    a, r = _step_records(out_dir / "a.jsonl"), _step_records(out_dir / "r.jsonl")
    la = [a[s]["metrics"]["loss"] for s in sorted(a)]
    lr = [r[s]["metrics"]["loss"] for s in sorted(r)]
    names = saver.leaf_names(out_dir / "a", 6)
    check(sorted(a) == list(range(1, 7)) and sorted(r) == [4, 5, 6] and res.resumed_from == 3,
          f"gnn driver steps {sorted(a)}, resumed {sorted(r)} from {res.resumed_from}")
    check(all(np.isfinite(la)) and max(abs(x - y) for x, y in zip(lr, la[3:])) <= 1e-5,
          f"gnn driver: resumed losses {lr} vs {la[3:]}")
    check({"state/dense/layer4/eps", "state/opt/m/encoder/w", "state/dense/readout4/b"} <= names,
          f"gnn driver checkpoint names {sorted(names)[:8]}")
    per_step = _gnn_per_step("graph")
    check(all(launches[k] == per_step[k] * 12 for k in per_step), f"gnn driver launches {launches}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"phase": "gnn_driver", "loss": la, "resumed_loss": lr,
            "resumed_max_abs_err": max(abs(x - y) for x, y in zip(lr, la[3:])),
            "launches": {k: v for k, v in launches.items() if v}, "phase_s": time.perf_counter() - t0}, launches


def gnn_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, dev,
              device_info: dict) -> dict:
    """The GNN family on the card: (a) ``_gnn_smoke``; (b) the four shape
    cells at published widths (``_gnn_train``; ogb_products with a profile
    and its inputs recorded); (c) the segment sum and its gradient (the row
    gather) on ogb_products' recorded inputs against their plain versions,
    timed (path ``gnn_ogb``); (d) ogb_products edge-parallel over two gloo
    ranks sharing the card in FP32, after step 1 against the one-rank run
    (loss within 1e-5; the update, m and v within GNN_REL_TOL relative;
    params bit-equal across the ranks), each rank's first segment sum and
    gather of that step held to their plain versions and timed (paths
    ``gnn_r0``, ``gnn_r1``), and the molecule cell with compress_grads on
    the ranks against one rank on the same global batch; (e)
    ``_gnn_driver``. Returns the launches of the phase (its ranks'
    included)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.segment_reduce import ops as sr_ops, ref as sr_ref
    from repro_torch.launch import gnn_cell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import layers
    from repro_torch.models.gnn import GraphBatch

    phase_t0 = time.perf_counter()
    launches = dict.fromkeys(counts(), 0)
    entry = {"segment_sum": "segment_reduce.segment_sum", "gather_rows": "fused_gather.gather_rows"}

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    # the ranks of (d) start now: they reach the card and take their first
    # trace while (a)-(c) run, then wait for their turn
    out_dir = ROOT / "build" / "gnn_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    early = EarlyRanks(_gnn_rank, GNN_RANKS, (str(out_dir / "store"),), GNN_TIMEOUT_S, "gnn ranks")
    try:
        reset_counts()
        smoke = _gnn_smoke(dev)
        add(counts())
        emit({"phase": "gnn_smoke", **device_info, "steps": GNN_SMOKE_STEPS, "cells": smoke,
              "shapes": GNN_SMOKE_SHAPES, "phase_s": time.perf_counter() - phase_t0})

        arch = get_config("gin-tu")
        real = {"segment_sum": recorder(sr_ops, "segment_sum"), "gather_rows": recorder(fg_ops, "gather_rows")}
        line, n, (st, ogb_batch) = _gnn_train(arch, "ogb_products", dev, counts, reset_counts, phase=phase,
                                              profile=True)
        sr_ops.segment_sum, fg_ops.gather_rows = real["segment_sum"], real["gather_rows"]  # no more records
        add(n)
        emit({**line, **device_info})
        del st
        torch.cuda.empty_cache()

        # (c) the two kernels on ogb_products' recorded inputs
        t0 = time.perf_counter()
        at = {}
        args, kw = recorded.pop(("segment_sum", "gnn_ogb"))
        vals, ids, _ = args
        check(vals.shape == (arch.shape("ogb_products")["n_edges"], arch.model.d_hidden) and ids.dtype == torch.int32
              and kw == {"sorted_ids": True} and bool((ids[1:] >= ids[:-1]).all()),
              f"gnn: recorded segment sum {tuple(vals.shape)} {ids.dtype} {kw}")
        del vals, ids
        at[entry["segment_sum"]] = _measure("segment_sum", real["segment_sum"], sr_ref.segment_sum, args, kw, 5, dev)
        del args
        torch.cuda.empty_cache()
        args, kw = recorded.pop(("gather_rows", "gnn_ogb"))
        at[entry["gather_rows"]] = _measure("gather_rows", real["gather_rows"], fg_ref.gather_rows, args, kw, 5, dev)
        del args
        torch.cuda.empty_cache()
        for k, m in at.items():
            _add_path(by_name[k], "gnn_ogb", m)
        seg = by_name["segment_reduce.segment_sum"]  # on a path again: the GIN aggregation
        seg["main_path"] = "gnn"
        seg.pop("main_path_note", None)
        m = at["segment_reduce.segment_sum"]
        seg.update(ms=m["ms"], kernel_ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                   bound_by=m["bound_by"], kernel_device_ms=m["kernel_device_ms"], host_us=m["host_us"],
                   library_ms=m["library_ms"], library_call="zeros.index_add_")
        kernels_s = time.perf_counter() - t0
        for name in GNN_SHAPE_NAMES[1:]:
            line, n, _ = _gnn_train(arch, name, dev, counts, reset_counts)
            add(n)
            emit({**line, **device_info})
            torch.cuda.empty_cache()

        # (d) one rank in this process, then two gloo ranks sharing the card, FP32
        t0 = time.perf_counter()
        gnn_cell.MIXED = layers.FP32
        try:
            one = build_arch_cell(arch, arch.shape("ogb_products"), device=dev)
            st = one.init_state()
            p0 = {k: v.detach().cpu().clone() for k, v in st["dense"].named_parameters()}
            reset_counts()
            st, o = one.step_fn(st, ogb_batch)
            torch.cuda.synchronize()
            add(counts())
            one_loss, one1 = float(o["loss"]), _gnn_state(st)
            del st, ogb_batch, one
            torch.cuda.empty_cache()
            mol = build_arch_cell(arch, arch.shape("molecule"), CellOptions(compress_grads=True), device=dev)
        finally:
            gnn_cell.MIXED = layers.MIXED
        held = torch.cuda.memory_allocated()
        check(held < (1 << 30), f"{held} bytes still allocated before the GNN ranks start")
    except BaseException:
        early.stop()
        raise
    ranks = early.results()
    ranks_s = time.perf_counter() - t0

    def rel(part: str, r: dict) -> float:
        got = torch.cat([torch.from_numpy(r["step1"][part][k]).reshape(-1) for k in sorted(one1[part])])
        want = torch.cat([one1[part][k].reshape(-1) for k in sorted(one1[part])])
        return _rel(got, want, torch.cat([p0[k].reshape(-1) for k in sorted(p0)]) if part == "p" else 0.0)

    after1 = []
    for r in ranks:
        check(r["transport"] == "gloo, host-staged", f"gnn rank {r['rank']}: transport {r['transport']}")
        check(all(torch.equal(torch.from_numpy(r["p0"][k]), p0[k]) for k in p0),
              f"gnn rank {r['rank']}: another initial state")
        c = {"loss_abs_err": abs(r["loss"][0] - one_loss), "update_rel_err": rel("p", r),
             "m_rel_err": rel("m", r), "v_rel_err": rel("v", r)}
        after1.append(c)
        check(c["loss_abs_err"] <= 1e-5 and all(c[k] <= GNN_REL_TOL for k in ("update_rel_err", "m_rel_err", "v_rel_err")),
              f"gnn rank {r['rank']} after step 1 against one rank: {c}")
        check(r["dense_sha256_step1"] == ranks[0]["dense_sha256_step1"]
              and r["dense_sha256_final"] == ranks[0]["dense_sha256_final"]
              and r["molecule_dense_sha256"] == ranks[0]["molecule_dense_sha256"], "the GNN ranks' params differ")
        check(all(n == _gnn_per_step("node") for n in r["launches_per_step"]),
              f"gnn rank {r['rank']}: launches a step {r['launches_per_step']}")
        check(all(np.isfinite(r["loss"])) and r["molecule_ef_shape"][0] == GNN_RANKS
              and r["molecule_ef_max_abs"] > 0, f"gnn rank {r['rank']}: {r['loss']}, ef {r['molecule_ef_shape']}")
        add({k: sum(n.get(k, 0) for n in r["launches_per_step"]) for k in r["launches_per_step"][0]})
        for k, m in r["kernels"].items():
            _add_path(by_name[entry[k]], f"gnn_r{r['rank']}", m)

    # the molecule cell with compress_grads on one rank, on the ranks' global
    # batches (rank 1's node and graph ids shifted past rank 0's)
    n_loc = ranks[0]["molecule_batches"][0]["feats"].shape[0]
    g_loc = ranks[0]["molecule_batches"][0]["labels"].shape[0]
    gnn_cell.MIXED = layers.FP32
    mol_loss = []
    try:
        st = mol.init_state()
        for s in range(GNN_SMOKE_STEPS):
            parts = [r["molecule_batches"][s] for r in ranks]
            shift = {"edge_src": n_loc, "edge_dst": n_loc, "node_graph": g_loc}
            merged = GraphBatch(**{f: torch.from_numpy(np.concatenate(
                [p[f] + i * shift[f] if f in shift else p[f] for i, p in enumerate(parts)])).to(dev)
                for f in GraphBatch._fields})
            reset_counts()
            st, o = mol.step_fn(st, merged)
            add(counts())
            mol_loss.append(float(o["loss"]))
    finally:
        gnn_cell.MIXED = layers.MIXED
    del st, mol
    for r in ranks:
        check(abs(r["molecule_loss"][0] - mol_loss[0]) <= 1e-5
              and max(abs(a - b) for a, b in zip(r["molecule_loss"], mol_loss)) <= GNN_MIXED_LOSS_ATOL,
              f"gnn rank {r['rank']} molecule compressed losses {r['molecule_loss']} vs one rank {mol_loss}")
    emit({"phase": "gnn_ranks", **device_info, "ranks": GNN_RANKS,
          "transport": "gloo, one card, host-staged (not NCCL, not NVLink)",
          "precision": "fp32 (the cells' MIXED set to FP32, TF32 off), both runs",
          "shape": "ogb_products", "reduced": {"devices": [256, GNN_RANKS]}, "one_rank_loss": one_loss,
          "loss_by_rank": [r["loss"] for r in ranks], "after_step1_by_rank": after1, "rel_tol": GNN_REL_TOL,
          "step_ms_p50_by_rank": [float(np.percentile(r["step_ms"], 50)) for r in ranks],
          "step_ms_by_rank": [r["step_ms"] for r in ranks],
          "all_reduce_ms_per_step_by_rank": [r["all_reduce_ms_per_step"] for r in ranks],
          "all_reduce_bytes_per_step_by_rank": [r["all_reduce_bytes_per_step"] for r in ranks],
          "all_reduce_calls_per_step_by_rank": [r["all_reduce_calls_per_step"] for r in ranks],
          "staged_bytes_per_step_by_rank": [r["staged_bytes_per_step"] for r in ranks],
          "max_memory_allocated_bytes_by_rank": [r["max_memory_allocated_bytes"] for r in ranks],
          "launches_per_step_by_rank": [r["launches_per_step"][-1] for r in ranks],
          "kernels_by_rank": [{k: {f: m[f] for f in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "kernel_device_ms")}
                               for k, m in r["kernels"].items()} for r in ranks],
          "molecule_compressed": {"one_rank_loss": mol_loss, "loss_by_rank": [r["molecule_loss"] for r in ranks],
                                  "ef_shape": ranks[0]["molecule_ef_shape"], "later_atol": GNN_MIXED_LOSS_ATOL},
          "ranks_s": ranks_s})
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    driver, n = _gnn_driver(counts, reset_counts)
    add(n)
    emit({**driver, **device_info})
    emit({"phase": "gnn_kernels", **device_info, "path": "gnn_ogb",
          "kernels": {k: {f: m[f] for f in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by", "kernel_device_ms", "host_us", "bytes")}
                      for k, m in at.items()},
          "kernels_s": kernels_s, "phase_s": time.perf_counter() - phase_t0})
    return launches


# ---------------------------------------------------------------------------
# 4 LM decode: qwen2.5-3b decode_32k and long_500k on one card, long_500k
# sequence-sharded over two gloo ranks sharing it
# ---------------------------------------------------------------------------
DEC_SMOKE = {"decode_32k": {"seq_len": 128, "global_batch": 4},
             "long_500k": {"seq_len": 256, "global_batch": 1, "long_context": True}}
DEC_SMOKE_STEPS = 3
DEC_BATCH = 32               # decode_32k's batch, cut from 128 (its cache would take 154.6 GB)
DEC_T0, DEC_CHECK_S = 2_048, 4_096   # prefill T0 tokens, then decode token T0 in a cache of 4,096
# Decode of token T0 after a prefill of T0 tokens against the last logits of a
# prefill of T0 + 1: the two paths round differently (decode rounds the
# scores and p to bf16, the flash kernel keeps fp32 scores), and 36 bf16
# layers compound it: on the CPU at 4 of the 36 layers (d 2,048, T0 1,024)
# the difference was 0.4% of the largest logit, so 36 layers stay under
# about 4%. Held: within 10% of the largest magnitude, and the logits of
# the position before (what a decode that read the wrong position or cache
# gives) beyond it (142% at that cut).
DEC_PREFILL_FRAC = 0.1
DEC_BACK = 16                # the timed runs start at position S - 16 of a filled cache
N_DEC_WARMUP, N_DEC_STEPS = 3, 10
DEC_RANKS, DEC_RANK_HELD, DEC_RANK_TIMED = 2, 3, 5
DEC_TIMEOUT_S = 600.0
DEC_SEED = 50_000


def _dec_fill(cache: dict, seed: int, s_global: int, lo: int) -> None:
    """Fill a cache (L, B, S_local, Hk, hd) with seeded random bf16 values:
    each layer's K (and V) drawn whole, (B, s_global, Hk, hd), from its own
    generator and sliced at [lo, lo + S_local), so that every rank of a
    sequence-sharded cache holds its slice of one filled cache."""
    for j, (name, c) in enumerate(sorted(cache.items())):
        L, B, S, hk, hd = c.shape
        for layer in range(L):
            g = torch.Generator(device=c.device).manual_seed(seed + 2 * layer + j)
            whole = torch.randn((B, s_global, hk, hd), generator=g, device=c.device, dtype=c.dtype)
            c[layer].copy_(whole[:, lo:lo + S])
            del whole


def _dec_unwritten_equal(cache: dict, seed: int, s_global: int, lo: int, written: list[int]) -> bool:
    """Whether every position of the cache but the ``written`` ones (local)
    still holds ``_dec_fill``'s values, bit for bit."""
    for j, (name, c) in enumerate(sorted(cache.items())):
        L, B, S, hk, hd = c.shape
        keep = torch.ones(S, dtype=torch.bool, device=c.device)
        keep[written] = False
        for layer in range(L):
            g = torch.Generator(device=c.device).manual_seed(seed + 2 * layer + j)
            whole = torch.randn((B, s_global, hk, hd), generator=g, device=c.device, dtype=c.dtype)
            if not torch.equal(c[layer][:, keep], whole[:, lo:lo + S][:, keep]):
                return False
            del whole
    return True


def _dec_written(cache: dict, written: list[int]) -> dict:
    """The cache's rows at the ``written`` (local) positions, on the host:
    {"k", "v"} each (L, B, len(written), Hk, hd)."""
    idx = torch.tensor(written, dtype=torch.long, device=cache["k"].device)
    return {k: c.index_select(2, idx).cpu() for k, c in cache.items()}


def _dec_token_rows(engine, gkey: str, V: int, d: int, dev) -> dict:
    """Rows for all V tokens (seeded N(0, 1) embeddings, zero moments), as
    ``import_rows`` takes them; on a rank of a group it keeps its own."""
    from repro_torch.io.ragged import Ragged

    vocab = Ragged(torch.arange(V, dtype=torch.int64, device=dev), torch.tensor([0, V], dtype=torch.int32, device=dev))
    ids = engine.engine_ids({"tokens": vocab})[gkey]
    emb = torch.randn((V, d), generator=torch.Generator(device=dev).manual_seed(DEC_SEED), device=dev)
    zeros = torch.zeros((V, d), dtype=torch.float32, device=dev)
    return {gkey: {"ids": ids, "emb": emb, "slots": {"m": zeros, "v": zeros},
                   "last_use": torch.zeros(V, dtype=torch.int32, device=dev)}}


def _dec_bytes(cfg, B: int, S: int) -> dict:
    """What one decode step must move: the whole K and V caches read (the
    step reads every position, masked), and the dense params it uses; the
    MIXED cast of each fp32 weight reads 4 bytes a param and writes 2, and
    the bf16 product reads those 2 again. A MoE layer uses its router, the
    experts of the step's B·k assignments (k distinct ones a token: exact at
    batch 1, at most all of them) and its shared experts."""
    cache = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim * 2
    hd, d, m = cfg.head_dim, cfg.d_model, cfg.moe
    per_layer = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    if m is None:
        per_layer += 3 * d * cfg.d_ff
    else:
        per_layer += d * m.n_experts + 3 * d * m.d_ff * (min(m.n_experts, B * m.top_k) + m.n_shared)
    n_weights = cfg.n_layers * per_layer + d * cfg.vocab_size
    return {"cache_read": cache, "weights_fp32_read": 4 * n_weights, "weights_bf16_written": 2 * n_weights,
            "weights_bf16_read": 2 * n_weights, "weight_params": n_weights,
            "total": cache + 8 * n_weights, "least": cache + 4 * n_weights}


def _dec_smoke(dev) -> dict:
    """(a) The smoke decode cells (decode_32k S 128, B 4; long_500k S 256,
    B 1) on the card against the CPU from the same rows, weights and filled
    cache, three steps from position S - 3: logits within
    MIXED_PREFILL_TOL, metrics and pos equal, the caches equal where no
    step wrote and within MIXED_PREFILL_TOL where they did."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell

    out = {}
    for name, params in DEC_SMOKE.items():
        shape = ShapeCell(name, "decode", params)
        cells = {d: build_cell("qwen2.5-3b", name, smoke=True, shape_override=shape, device=d)
                 for d in ("cpu", dev)}
        cfg = cells["cpu"].arch.model
        gkey, S = f"dim{cfg.d_model}", params["seq_len"]
        rows = _dec_token_rows(cells["cpu"].engine, gkey, cfg.vocab_size, cfg.d_model, "cpu")
        states = {}
        for d, c in cells.items():
            states[d] = c.init_state()
            states[d]["sparse"] = c.engine.import_rows(rows)
            states[d]["pos"] = torch.tensor(S - DEC_SMOKE_STEPS, dtype=torch.int32, device=d)
        _dec_fill(states["cpu"]["cache"], DEC_SEED, S, 0)
        for k in ("k", "v"):
            states[dev]["cache"][k].copy_(states["cpu"]["cache"][k])
        states[dev]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
        err = 0.0
        for s in range(DEC_SMOKE_STEPS):
            outs = {}
            for d, c in cells.items():
                states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
            met = {d: {k: int(v) for k, v in o.items() if "/" in k} for d, o in outs.items()}
            check(met[dev] == met["cpu"], f"smoke {name} metrics differ: {met}")
            got, want = outs[dev]["logits"].cpu(), outs["cpu"]["logits"]
            check(bool(torch.isfinite(got).all()) and torch.allclose(got, want, **MIXED_PREFILL_TOL),
                  f"smoke {name} logits differ by {(got - want).abs().max()} at step {s + 1}")
            err = max(err, float((got - want).abs().max()))
        check(int(states[dev]["pos"]) == int(states["cpu"]["pos"]) == S, f"smoke {name} pos")
        written = list(range(S - DEC_SMOKE_STEPS, S))
        cache_err = 0.0
        for k in ("k", "v"):
            got, want = states[dev]["cache"][k].cpu(), states["cpu"]["cache"][k]
            keep = torch.ones(S, dtype=torch.bool)
            keep[written] = False
            check(torch.equal(got[:, :, keep], want[:, :, keep]), f"smoke {name}: cache {k} changed where no step wrote")
            g, w = got[:, :, ~keep].float(), want[:, :, ~keep].float()
            check(torch.allclose(g, w, **MIXED_PREFILL_TOL), f"smoke {name}: written cache {k} differs")
            cache_err = max(cache_err, float((g - w).abs().max()))
        out[name] = {"params": params, "steps": DEC_SMOKE_STEPS, "from_pos": S - DEC_SMOKE_STEPS,
                     "logits_max_abs_diff": err, "written_cache_max_abs_diff": cache_err, "metrics": met[dev]}
    return out


def _dec_nonzero_after(cache: dict, p: int) -> int:
    """Nonzero cache values at positions p and later (a layer at a time)."""
    return sum(int(torch.count_nonzero(c[layer][:, p:])) for c in cache.values() for layer in range(c.shape[0]))


def _dec_step_checks(o: dict, B: int, V: int, rows_live: int, gkey: str, what: str) -> None:
    met = {k: int(v) for k, v in o.items() if "/" in k}
    check(o["logits"].shape == (B, V) and o["logits"].dtype == torch.float32
          and bool(torch.isfinite(o["logits"]).all()), f"{what}: logits")
    check(all(v == 0 for k, v in met.items() if "overflow" in k) and met[f"{gkey}/dev_rows_live"] == rows_live,
          f"{what}: metrics {met}")


def _dec_timed(cell, st: dict, label: str, S: int, fill_seed: int, counts, reset_counts, phase: dict,
               per_step: dict, rows_live: int, trace: bool = True) -> tuple[dict, dict, list, dict]:
    """The timed run of a decode cell at full width: the cache filled with
    ``_dec_fill`` and ``pos`` at S - DEC_BACK, N_DEC_WARMUP + N_DEC_STEPS
    steps (CUDA events; the first records its inputs as phase ``label``),
    exact launches a step, then with ``trace`` a torch.profiler trace of
    one more step (``profile_requests``: two steps, one of them traced);
    every position no step wrote still holds the fill. Returns the state,
    the run's line, the warm-up steps' logits on the host, and the cache's
    rows at the warm-up steps' positions."""
    cfg = cell.arch.model
    B, V, gkey = cell.shape["global_batch"], cfg.vocab_size, f"dim{cfg.d_model}"
    t0 = time.perf_counter()
    _dec_fill(st["cache"], fill_seed, S, 0)
    p0 = S - DEC_BACK
    st["pos"] = torch.tensor(p0, dtype=torch.int32, device=cell.device)
    n = N_DEC_WARMUP + N_DEC_STEPS
    batches = [cell.make_batch(DEC_SEED + 10 + s) for s in range(n + 1)]
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, warm = [], []
    for s in range(n):
        phase["name"] = label if s == 0 else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, o = cell.step_fn(st, batches[s])
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= N_DEC_WARMUP:
            ms.append(start.elapsed_time(end))
        else:
            warm.append(o["logits"].cpu())
        _dec_step_checks(o, B, V, rows_live, gkey, f"{label} step {s + 1}")
    launches = counts()
    check(launches == {k: v * n for k, v in per_step.items()}, f"{label}: launches {launches}")
    peak = torch.cuda.max_memory_allocated()

    def step(b):
        nonlocal st
        st, _ = cell.step_fn(st, b)

    prof = profile_requests(label, step, batches[n:]) if trace else None  # two steps: one untraced, one traced
    launches = counts()
    written = list(range(p0, p0 + n + (2 if trace else 0)))
    check(int(st["pos"]) == p0 + len(written), f"{label}: pos {int(st['pos'])}")
    check(_dec_unwritten_equal(st["cache"], fill_seed, S, 0, written), f"{label}: the cache changed where no step wrote")
    warm_rows = _dec_written(st["cache"], written[:N_DEC_WARMUP])
    nbytes = _dec_bytes(cfg, B, S)
    msa = np.array(ms)
    line = {"phase": f"full_{label}", "arch": cell.arch.arch_id, "shape": cell.shape.name, "seq_len": S, "batch": B,
            "from_pos": p0, "warmup": N_DEC_WARMUP, "steps": N_DEC_STEPS, "fill_s": fill_s,
            "step_ms_p50": float(np.percentile(msa, 50)), "step_ms_p99": float(np.percentile(msa, 99)),
            "step_ms_mean": float(msa.mean()), "step_ms": ms, "tokens_per_s": B / (float(np.percentile(msa, 50)) / 1e3),
            "bytes_per_step": nbytes, "bound_ms": nbytes["least"] / HBM_BYTES_PER_S * 1e3,
            "bound_ms_with_weight_cast": nbytes["total"] / HBM_BYTES_PER_S * 1e3,
            "bound_share_p50": nbytes["least"] / HBM_BYTES_PER_S * 1e3 / float(np.percentile(msa, 50)),
            "max_memory_allocated_bytes": peak, "launches": launches,
            "profile": {k: prof[k] for k in ("wall_ms_per_request", "device_busy_ms_per_request", "device_idle_share",
                                              "device_events_per_request", "top_device_ms_per_request")}
            if trace else None}
    return st, line, warm, warm_rows


def _dec_rank(rank: int, world: int, store: str, weights, fill_seed: int, q) -> None:
    """One rank of the decode phase's two-rank run (a spawned process,
    started at the phase's start): joins the gloo group and takes its first
    profiler trace while the parent runs its one-card parts, then takes the
    parent's weights from the queue ``weights`` (the module itself, its
    tensors shared on the card through CUDA IPC; None: the parent failed),
    runs ``_dec_rank_run`` and reports its result, or its traceback."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh

    try:
        group = mesh.init_group("gloo", rank=rank, world_size=world, store_path=store)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        kernel_device_ms(lambda: None, "", iters=1, tries=1)  # a process's first trace takes 11-13 s
        model = weights.get(timeout=DEC_TIMEOUT_S)
        check(model is not None, "decode rank: the parent failed before the ranks' turn")
        q.put((rank, True, _dec_rank_run(rank, group, dev, fill_seed, model)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.close()


def _dec_rank_run(rank: int, group, dev, fill_seed: int, model) -> dict:
    """This rank's part of long_500k sequence-sharded over the group (its
    half of the cache's positions, the whole batch), from the one-rank
    run's filled state (the same rows, weights and cache values; the
    cell's ``init_state`` but for the weights, ``model``, the parent's
    seed-0 weights, which every process reads where they lie on the card):
    DEC_RANK_HELD steps whose logits and written cache rows the caller holds
    to the one-rank run's, then DEC_RANK_TIMED more; each step timed (host
    clock, synced) with its all-reduces (calls, bytes, ms, each timed
    between two synchronises), staged bytes and launches. The row gather of
    step 1 is held to its plain version and timed, the ranks in turn."""
    from repro_torch.configs import get_config
    from repro_torch.core import comm
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.models import transformer as tfm

    arch = get_config("qwen2.5-3b")
    cfg = arch.model
    V, gkey = cfg.vocab_size, f"dim{cfg.d_model}"
    S = arch.shape("long_500k")["seq_len"]
    real_all_reduce, ar = comm.all_reduce, {"ms": 0.0, "calls": 0, "bytes": 0}

    def timed_all_reduce(x, group, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_all_reduce(x, group, *a, **kw)
        torch.cuda.synchronize()
        ar["ms"] += (time.perf_counter() - t0) * 1e3
        ar["calls"] += 1
        ar["bytes"] += x.numel() * x.element_size()
        return out

    comm.all_reduce = timed_all_reduce
    probe, recorded, real = {"on": True}, {}, {}
    _record_first(fg_ops, "gather_rows", False, lambda: probe["on"], recorded, real)
    try:
        t0 = time.perf_counter()
        cell = build_arch_cell(arch, arch.shape("long_500k"), device=dev, group=group)
        s_loc = S // comm.size(group)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        st = {"step": zero, "pos": zero.clone(), "dense": model,
              "sparse": cell.engine.import_rows(_dec_token_rows(cell.engine, gkey, V, cfg.d_model, dev)),
              "cache": tfm.init_cache(cfg, 1, s_loc, dev)}
        lo = comm.rank(group) * s_loc
        _dec_fill(st["cache"], fill_seed, S, lo)
        p0 = S - DEC_BACK
        st["pos"] = torch.tensor(p0, dtype=torch.int32, device=dev)
        n = DEC_RANK_HELD + DEC_RANK_TIMED
        batches = [cell.make_batch(DEC_SEED + 10 + s) for s in range(n)]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        rows_live = int(st["sparse"][gkey]["idmap"].n_live())
        torch.cuda.reset_peak_memory_stats()
        logits, ms, per_step, ar_ms, ar_calls, ar_bytes, staged_bytes = [], [], [], [], [], [], []
        live_sum = []
        for s in range(n):
            reset_kernel_counts()
            ar.update(ms=0.0, calls=0, bytes=0)
            staged = comm.STAGED_BYTES
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, o = cell.step_fn(st, batches[s])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            per_step.append({k: v for k, v in kernel_counts().items() if v})
            ar_ms.append(ar["ms"])
            ar_calls.append(ar["calls"])
            ar_bytes.append(ar["bytes"])
            staged_bytes.append(comm.STAGED_BYTES - staged)
            met = {k: int(v) for k, v in o.items() if "/" in k}
            check(o["logits"].shape == (1, V) and bool(torch.isfinite(o["logits"]).all()),
                  f"decode rank {rank}: logits at step {s + 1}")
            check(all(v == 0 for k, v in met.items() if "overflow" in k), f"decode rank {rank}: {met}")
            live_sum.append(met[f"{gkey}/dev_rows_live"])
            if s < DEC_RANK_HELD:
                logits.append(o["logits"].cpu())
            if s == 0:
                probe["on"] = False
                kernels = _measure_in_turns(rank, group, {"gather_rows": fg_ref.gather_rows}, recorded, real, 20, dev)
                torch.cuda.reset_peak_memory_stats()
        written = [p - lo for p in range(p0, p0 + n) if lo <= p < lo + s_loc]
        held = [p - lo for p in range(p0, p0 + DEC_RANK_HELD) if lo <= p < lo + s_loc]
        return {"rank": rank, "transport": comm.transport(group, dev), "slice": [lo, lo + s_loc],
                "rows_live_here": rows_live, "rows_live_summed": live_sum, "setup_s": setup_s,
                "logits": [x.numpy() for x in logits], "step_ms": ms, "launches_per_step": per_step,
                "all_reduce_ms_per_step": ar_ms, "all_reduce_calls_per_step": ar_calls,
                "all_reduce_bytes_per_step": ar_bytes, "staged_bytes_per_step": staged_bytes,
                "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                "written_local": written, "held_local": held,
                "unwritten_equal_fill": _dec_unwritten_equal(st["cache"], fill_seed, S, lo, written),
                "held_rows": {k: v.float().numpy() for k, v in _dec_written(st["cache"], held).items()},
                "pos": int(st["pos"]), "kernels": kernels}
    finally:
        comm.all_reduce = real_all_reduce
        fg_ops.gather_rows = real["gather_rows"]


def _dec_after_prefill(arch, model, sparse: dict, dev, counts, reset_counts) -> dict:
    """A prefill of DEC_T0 tokens (the flash kernel) whose cache a decode
    cell takes at [0, DEC_T0), and that cell's decode of token DEC_T0 held
    to the last logits of a prefill of DEC_T0 + 1 tokens: within
    DEC_PREFILL_FRAC of their largest magnitude, and the logits of the
    position before (what a decode that read the wrong position or cache
    gives) beyond it. ``model`` and ``sparse`` (rows for every token) are
    shared by the three cells. Returns the numbers, the launches among them."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.models import transformer as tfm

    cfg = arch.model
    V, L = cfg.vocab_size, cfg.n_layers
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    pre = {T: build_arch_cell(arch, ShapeCell("prefill_32k", "prefill", {"seq_len": T, "global_batch": 1}),
                              device=dev) for T in (DEC_T0, DEC_T0 + 1)}
    chk = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {"seq_len": DEC_CHECK_S, "global_batch": 1}),
                          device=dev)
    tokens = torch.from_numpy(np.random.default_rng(DEC_SEED + 1).integers(0, V, (1, DEC_T0 + 1))).to(
        torch.int32).to(dev)
    pst = {"step": zero, "dense": model, "sparse": sparse}
    reset_counts()
    out_a = pre[DEC_T0].step_fn(pst, tokens[:, :DEC_T0])
    out_b = pre[DEC_T0 + 1].step_fn(pst, tokens)
    cst = {"step": zero, "pos": torch.tensor(DEC_T0, dtype=torch.int32, device=dev), "dense": model,
           "sparse": sparse, "cache": tfm.init_cache(cfg, 1, DEC_CHECK_S, dev)}
    for k in ("k", "v"):
        cst["cache"][k][:, :, :DEC_T0].copy_(out_a[f"cache_{k}"])
    cst, out_d = chk.step_fn(cst, tokens[:, DEC_T0])
    torch.cuda.synchronize()
    n = counts()
    want_n = {k: {"fused_gather.gather_rows": 3, "flash_attention.flash_fwd": 2 * L}.get(k, 0) for k in n}
    check(n == want_n, f"prefill then decode: launches {n}, expected {want_n}")
    got, want, prev = out_d["logits"][0], out_b["logits"][0], out_a["logits"][0]
    scale = float(want.abs().max())
    pd = {"t0": DEC_T0, "cache_seq_len": DEC_CHECK_S, "logits_max_abs": scale,
          "max_abs_err": float((got - want).abs().max()), "tolerance": DEC_PREFILL_FRAC * scale,
          "previous_position_max_abs_diff": float((got - prev).abs().max()),
          "argmax_equal": bool(int(got.argmax()) == int(want.argmax())), "launches": n,
          "s": time.perf_counter() - t0}
    check(bool(torch.isfinite(got).all()) and pd["max_abs_err"] <= pd["tolerance"],
          f"decode of token T0 against the prefill of T0 + 1 tokens: {pd}")
    check(pd["previous_position_max_abs_diff"] > pd["tolerance"], f"the prefill-then-decode check cannot tell a "
          f"position apart: {pd}")
    return pd


def decode_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, dev,
                 device_info: dict) -> dict:
    """LM decode on the card: (a) ``_dec_smoke``; (b) qwen2.5-3b
    ``decode_32k`` at published widths, batch DEC_BATCH, three steps from
    the cell's fresh state (pos 0, a zero cache, an empty engine: the
    tokens read zero rows; the state its ``init_state`` makes, its weights
    drawn on the card by ``card_model``); (c) prefill then decode at full
    width: rows for
    all tokens imported, a prefill of DEC_T0 tokens (the flash kernel) whose
    cache a decode cell takes at [0, DEC_T0), the decode of token DEC_T0
    held to the last logits of a prefill of DEC_T0 + 1 tokens; (d)
    ``decode_32k`` timed from a filled cache (``_dec_timed``, phase
    ``decode_32k``); (e) ``long_500k`` (S 524,288, batch 1) three steps from
    a fresh state (as (b)'s, the same weights) and timed from a filled cache (phase
    ``long_500k``); (f) ``long_500k`` over two gloo ranks sharing the card
    from the same filled state, held to (e)'s first three steps; (g) the
    row gather on each path's recorded inputs against its plain version,
    timed (paths ``decode_32k``, ``long_500k``, ``decode_r0``,
    ``decode_r1``). The ranks are spawned at the phase's start and reach
    the card during (a)-(e); in (f) they read this process's weights on the
    card (CUDA IPC: one copy of the 12.34 GB for three processes). Returns
    the launches of the phase (its ranks' included)."""
    phase_t0 = time.perf_counter()
    launches = dict.fromkeys(counts(), 0)
    per_step = {k: int(k == "fused_gather.gather_rows") for k in launches}  # one row gather a step

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    # the ranks start now: they reach the card and take their first trace
    # while this process runs the one-card parts, then wait for the weights
    out_dir = ROOT / "build" / "decode_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    weights = mp.get_context("spawn").Queue()
    spawned: dict = {"sent": False}

    def spawn():
        try:
            spawned["ranks"] = _spawn_ranks(_dec_rank, DEC_RANKS, (str(out_dir / "store"), weights, DEC_SEED + 200),
                                            DEC_TIMEOUT_S, "decode ranks")
        except BaseException as e:  # re-raised in this process below
            spawned["error"] = e

    ranks_thread = threading.Thread(target=spawn, daemon=True)
    ranks_thread.start()
    try:
        return _decode_one_card(counts, reset_counts, phase, recorded, recorder, by_name, dev, device_info,
                                launches, per_step, add, phase_t0, weights, ranks_thread, spawned)
    finally:
        if not spawned["sent"]:  # a failure before the ranks' turn: they stop
            for _ in range(DEC_RANKS):
                weights.put(None)
        ranks_thread.join(timeout=DEC_TIMEOUT_S)
        shutil.rmtree(out_dir, ignore_errors=True)


def _decode_one_card(counts, reset_counts, phase, recorded, recorder, by_name, dev, device_info, launches, per_step,
                     add, phase_t0, weights, ranks_thread, spawned) -> dict:
    """``decode_phase``'s parts in this process, then the ranks' turn."""
    from repro_torch.configs import qwen2_5_3b
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import transformer as tfm

    reset_counts()
    smoke = _dec_smoke(dev)
    n = counts()
    check(n == {k: v * DEC_SMOKE_STEPS * len(DEC_SMOKE) for k, v in per_step.items()}, f"smoke decode launches {n}")
    add(n)
    emit({"phase": "decode_smoke_card_vs_cpu", **device_info, "arch": "qwen2.5-3b (smoke)", "cells": smoke,
          "tolerance": MIXED_PREFILL_TOL, "phase_s": time.perf_counter() - phase_t0})

    arch = qwen2_5_3b.ARCH
    cfg = arch.model
    V, d, L = cfg.vocab_size, cfg.d_model, cfg.n_layers
    gkey = f"dim{d}"
    s32, s500 = arch.shape("decode_32k")["seq_len"], arch.shape("long_500k")["seq_len"]
    check((s32, arch.shape("decode_32k")["global_batch"], s500, arch.shape("long_500k")["global_batch"])
          == (32_768, 128, 524_288, 1), "the decode shapes")
    widths = {"n_layers": L, "d_model": d, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": V, "qkv_bias": cfg.qkv_bias}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(held < (1 << 30), f"{held} bytes still allocated before the decode phase")

    # (b) decode_32k from the cell's fresh state
    t0 = time.perf_counter()
    c32 = build_cell("qwen2.5-3b", "decode_32k", device=dev, shape_override=ShapeCell(
        "decode_32k", "decode", {"seq_len": s32, "global_batch": DEC_BATCH}))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    st = {"step": zero, "pos": zero.clone(), "dense": card_model(cfg, dev), "sparse": c32.engine.init_state(),
          "cache": tfm.init_cache(cfg, DEC_BATCH, s32, dev)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state_bytes = {"dense_params": sum(p.numel() * p.element_size() for p in st["dense"].parameters()),
                   "engine": sum(t.numel() * t.element_size() for t in _tensors(st["sparse"])),
                   "cache": sum(t.numel() * t.element_size() for t in st["cache"].values())}
    reset_counts()
    for s in range(DEC_SMOKE_STEPS):
        st, o = c32.step_fn(st, c32.make_batch(DEC_SEED + s))
        _dec_step_checks(o, DEC_BATCH, V, 0, gkey, f"decode_32k fresh step {s + 1}")
    n = counts()
    check(n == {k: v * DEC_SMOKE_STEPS for k, v in per_step.items()}, f"decode_32k fresh launches {n}")
    add(n)
    # an empty engine gives zero rows and the biases start at zero, so the
    # fresh steps write zeros: nothing may be written past them
    check(int(st["pos"]) == DEC_SMOKE_STEPS and _dec_nonzero_after(st["cache"], DEC_SMOKE_STEPS) == 0,
          "decode_32k fresh: the steps wrote other positions")
    fresh32 = {"fresh_steps": DEC_SMOKE_STEPS, "setup_s": setup_s, "state_bytes": state_bytes,
               "logits_max_abs": float(o["logits"].abs().max())}
    model = st["dense"]
    st["sparse"] = None  # import_rows builds the engine state
    t0 = time.perf_counter()
    st["sparse"] = c32.engine.import_rows(_dec_token_rows(c32.engine, gkey, V, d, dev))
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    check(int(st["sparse"][gkey]["idmap"].n_live()) == V, "not every token's row is live")

    # (c) prefill then decode
    pd = _dec_after_prefill(arch, model, st["sparse"], dev, counts, reset_counts)
    add(pd["launches"])
    emit({"phase": "decode_after_prefill", **device_info, "arch": arch.arch_id, "widths": widths, **pd,
          "tolerance_frac_of_largest": DEC_PREFILL_FRAC})
    torch.cuda.empty_cache()

    # (d) decode_32k timed from a filled cache
    real = {"gather_rows": recorder(fg_ops, "gather_rows")}
    try:
        st, line32, _, _ = _dec_timed(c32, st, "decode_32k", s32, DEC_SEED + 100, counts, reset_counts, phase,
                                      per_step, V)
        add(line32["launches"])
        line32.update(fresh32, import_rows_s=import_s, widths=widths,
                      reduced={"global_batch": [128, DEC_BATCH]}, **device_info)
        emit(line32)
        sparse = st["sparse"]
        del st, c32
        torch.cuda.empty_cache()

        # (e) long_500k: three steps from a fresh state, then timed from a filled cache
        t0 = time.perf_counter()
        c500 = build_cell("qwen2.5-3b", "long_500k", device=dev)
        st = {"step": zero, "pos": zero.clone(), "dense": model, "sparse": c500.engine.init_state(),
              "cache": tfm.init_cache(cfg, 1, s500, dev)}
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        for s in range(DEC_SMOKE_STEPS):
            st, o = c500.step_fn(st, c500.make_batch(DEC_SEED + s))
            _dec_step_checks(o, 1, V, 0, gkey, f"long_500k fresh step {s + 1}")
        n = counts()
        check(n == {k: v * DEC_SMOKE_STEPS for k, v in per_step.items()}, f"long_500k fresh launches {n}")
        add(n)
        check(int(st["pos"]) == DEC_SMOKE_STEPS and _dec_nonzero_after(st["cache"], DEC_SMOKE_STEPS) == 0,
              "long_500k fresh: the steps wrote other positions")
        st["sparse"] = sparse
        del sparse
        torch.cuda.empty_cache()
        st, line500, warm500, rows500 = _dec_timed(c500, st, "long_500k", s500, DEC_SEED + 200, counts, reset_counts,
                                                   phase, per_step, V)
        add(line500["launches"])
        line500.update(setup_s=setup_s, widths=widths, fresh_steps=DEC_SMOKE_STEPS, **device_info)
        emit(line500)
    finally:
        fg_ops.gather_rows = real["gather_rows"]  # no more records
    del st, c500
    torch.cuda.empty_cache()

    # (g) the row gather on the one-card paths' recorded inputs
    at = {}
    for path in ("decode_32k", "long_500k"):
        args, kw = recorded.pop(("gather_rows", path))
        check(args[0].shape[1] == d and args[0].dtype == torch.float32, f"{path}: recorded gather {args[0].shape}")
        at[path] = _measure("gather_rows", real["gather_rows"], fg_ref.gather_rows, args, kw, 20, dev)
        del args
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - state_bytes["dense_params"]
    check(held < (1 << 30), f"{held} bytes beside the weights still allocated before the decode ranks' turn")

    # (f) long_500k over two gloo ranks sharing the card: their turn, each
    # reading this process's weights where they lie (CUDA IPC)
    t0 = time.perf_counter()
    for _ in range(DEC_RANKS):
        weights.put(model)
    spawned["sent"] = True
    ranks_thread.join(timeout=DEC_TIMEOUT_S)
    if "error" in spawned:
        raise spawned["error"]
    check("ranks" in spawned, "decode ranks: no result")
    ranks = spawned["ranks"]
    ranks_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    p0 = s500 - DEC_BACK
    by_rank = []
    for r in ranks:
        rank = r["rank"]
        check(r["transport"] == "gloo, host-staged", f"decode rank {rank}: transport {r['transport']}")
        errs = [float(np.abs(got - want.numpy()).max()) for got, want in zip(r["logits"], warm500)]
        check(all(np.allclose(got, want.numpy(), **MIXED_PREFILL_TOL) for got, want in zip(r["logits"], warm500)),
              f"decode rank {rank}: logits off the one-rank run's by {errs}")
        check(r["unwritten_equal_fill"], f"decode rank {rank}: its cache slice changed where no step wrote")
        mine = [p for p in range(p0, p0 + DEC_RANK_HELD + DEC_RANK_TIMED) if r["slice"][0] <= p < r["slice"][1]]
        check(r["written_local"] == [p - r["slice"][0] for p in mine] and r["pos"] == p0 + DEC_RANK_HELD + DEC_RANK_TIMED,
              f"decode rank {rank}: written {r['written_local']}, pos {r['pos']}")
        held_err = {}
        if r["held_local"]:  # the rank that holds the first steps' positions: rank 1
            for k in ("k", "v"):
                got, want = r["held_rows"][k], rows500[k].float().numpy()
                check(np.array_equal(got[0], want[0]), f"decode rank {rank}: layer 0's written {k} rows differ")
                check(np.allclose(got, want, **MIXED_PREFILL_TOL), f"decode rank {rank}: written {k} rows differ")
                held_err[k] = float(np.abs(got - want).max())
        check(all(n == {"fused_gather.gather_rows": 1} for n in r["launches_per_step"]),
              f"decode rank {rank}: launches a step {r['launches_per_step']}")
        check(all(c == 3 * L + 1 for c in r["all_reduce_calls_per_step"]),
              f"decode rank {rank}: all-reduces a step {r['all_reduce_calls_per_step']}")
        check(all(x == V for x in r["rows_live_summed"]), f"decode rank {rank}: rows live {r['rows_live_summed']}")
        add({"fused_gather.gather_rows": len(r["launches_per_step"])})
        _add_path(by_name["fused_gather.gather_rows"], f"decode_r{rank}", r["kernels"]["gather_rows"])
        by_rank.append({"logits_max_abs_err": errs, "written_rows_max_abs_err": held_err})
    check(not ranks[0]["written_local"] and ranks[1]["held_local"] == [p - s500 // 2 for p in range(p0, p0 + 3)],
          "decode ranks: the new tokens' positions are not all on rank 1")
    t_ms = [r["step_ms"][DEC_RANK_HELD:] for r in ranks]
    emit({"phase": "decode_ranks", **device_info, "shape": "long_500k", "ranks": DEC_RANKS,
          "transport": "gloo, one card, host-staged (not NCCL, not NVLink)", "precision": "MIXED (bf16 compute)",
          "seq_len": s500, "slices": [r["slice"] for r in ranks], "from_pos": p0,
          "held_steps": DEC_RANK_HELD, "timed_steps": DEC_RANK_TIMED, "tolerance": MIXED_PREFILL_TOL,
          "against_one_rank": by_rank, "rows_live_by_rank": [r["rows_live_here"] for r in ranks],
          "step_ms_p50_by_rank": [float(np.percentile(m, 50)) for m in t_ms], "step_ms_by_rank": [r["step_ms"] for r in ranks],
          "all_reduce_calls_per_step": ranks[0]["all_reduce_calls_per_step"][-1],
          "all_reduce_ms_per_step_by_rank": [r["all_reduce_ms_per_step"] for r in ranks],
          "all_reduce_bytes_per_step_by_rank": [r["all_reduce_bytes_per_step"] for r in ranks],
          "staged_bytes_per_step_by_rank": [r["staged_bytes_per_step"] for r in ranks],
          "max_memory_allocated_bytes_by_rank": [r["max_memory_allocated_bytes"] for r in ranks],
          "setup_s_by_rank": [r["setup_s"] for r in ranks], "ranks_s": ranks_s})
    for path, m in at.items():
        _add_path(by_name["fused_gather.gather_rows"], path, m)
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "host_us", "bytes")
    emit({"phase": "decode_kernels", **device_info,
          "gather_rows": {**{p: {k: m[k] for k in keep} for p, m in at.items()},
                          **{f"decode_r{r['rank']}": {k: r["kernels"]["gather_rows"][k] for k in keep} for r in ranks}},
          "launches": launches, "phase_s": time.perf_counter() - phase_t0})
    return launches


# ---------------------------------------------------------------------------
# 4 the MoE family: qwen2-moe-a2.7b and moonshot-v1-16b-a3b serve on one card
# ---------------------------------------------------------------------------
MOE_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
MOE_SMOKE = {"prefill_32k": {"seq_len": 64, "global_batch": 2},
             "decode_32k": {"seq_len": 64, "global_batch": 4}}
# moonshot-v1-16b-a3b at its 48 layers holds 27.7 B fp32 params (110.9 GB):
# 12 layers (28.7 GB) beside its 8.05 GB engine; qwen2-moe-a2.7b at its 24
# (56.0 GB) beside a 7.47 GB engine
MOE_LAYERS = {"qwen2-moe-a2.7b": 24, "moonshot-v1-16b-a3b": 12}
MOE_PIECE = 1_024   # tokens a piece of the dense plain MoE at T 32,768 (whole, its (E, T, d) output takes 8.05 GB)
MOE_SEED = 60_000
# Card against CPU under MIXED, as tests/test_torch_moe.py holds the port to
# JAX: a token whose k-th and (k+1)-th router probabilities lie within 2% of
# the k-th (twice the largest drift that bf16 hidden states an ulp apart
# gave there) may rightly take another expert on each side; its values are
# left out, and at most a quarter of the tokens may be so.
MOE_NEAR_TIE_REL, MOE_MAX_TIE_SHARE = 2e-2, 0.25


def _moe_near_ties(calls: list, n: int) -> np.ndarray:
    """(n,) bool: the tokens whose k-th and (k+1)-th routing probabilities
    lie within MOE_NEAR_TIE_REL of the k-th, and are not equal, in any of
    ``calls`` ((probs, k) a MoE call)."""
    tie = np.zeros(n, bool)
    for probs, k in calls:
        p = -np.sort(-probs, axis=-1)
        gap = p[:, k - 1] - p[:, k]
        tie |= (gap > 0) & (gap < MOE_NEAR_TIE_REL * p[:, k - 1])
    return tie


@contextlib.contextmanager
def _moe_routes(moe_lib, calls: list):
    """Keeps the CPU-side routing probabilities of every MoE call in ``calls``."""
    real = moe_lib.route

    def recorded(router, x, top_k):
        out = real(router, x, top_k)
        if x.device.type == "cpu":
            calls.append((out[0].numpy(), top_k))
        return out

    moe_lib.route = recorded
    try:
        yield
    finally:
        moe_lib.route = real


def _moe_smoke(dev, counts, reset_counts) -> tuple[dict, dict]:
    """(a) The MoE archs' smoke prefill (T 64, batch 2: two requests) and
    decode (S 64, batch 4: three steps from a cache filled at S - 3) cells
    on the card against the CPU, from the same rows, weights and cache:
    integers equal, logits, caches and written cache rows within
    MIXED_PREFILL_TOL at the tokens off a near-tie of the CPU's routing,
    the cache unchanged where no step wrote; a flash launch a layer and a
    gather a request or step. Returns the numbers and the card's launches."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import moe as moe_lib

    out, launches = {}, {}

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    for arch_id in MOE_ARCHS:
        res = {}
        for name, params in MOE_SMOKE.items():
            shape = ShapeCell(name, name.split("_")[0], params)
            cells = {d: build_cell(arch_id, name, smoke=True, shape_override=shape, device=d) for d in ("cpu", dev)}
            cfg = cells["cpu"].arch.model
            gkey, S, B = f"dim{cfg.d_model}", params["seq_len"], params["global_batch"]
            rows = _dec_token_rows(cells["cpu"].engine, gkey, cfg.vocab_size, cfg.d_model, "cpu")
            states = {}
            for d, c in cells.items():
                states[d] = c.init_state()
                states[d]["sparse"] = c.engine.import_rows(rows)
            states[dev]["dense"].load_state_dict(states["cpu"]["dense"].state_dict())
            decode = shape.kind == "decode"
            if decode:
                for d in cells:
                    states[d]["pos"] = torch.tensor(S - DEC_SMOKE_STEPS, dtype=torch.int32, device=d)
                _dec_fill(states["cpu"]["cache"], MOE_SEED, S, 0)
                for k in ("k", "v"):
                    states[dev]["cache"][k].copy_(states["cpu"]["cache"][k])
            err, ties_all, steps = {}, [], DEC_SMOKE_STEPS if decode else 2
            for s in range(steps):
                outs, calls = {}, []
                with _moe_routes(moe_lib, calls):
                    for d, c in cells.items():
                        before = counts()
                        if decode:
                            states[d], outs[d] = c.step_fn(states[d], c.make_batch(s))
                        else:
                            outs[d] = c.step_fn(states[d], c.make_batch(s))
                        torch.cuda.synchronize()
                        n = {k: v - before[k] for k, v in counts().items()}
                        if d == dev:
                            want = {k: {"fused_gather.gather_rows": 1,
                                        "flash_attention.flash_fwd": 0 if decode else cfg.n_layers}.get(k, 0)
                                    for k in n}
                            check(n == want, f"smoke {arch_id} {name}: launches {n}, expected {want}")
                            add(n)
                met = {d: {k: int(v) for k, v in o.items() if "/" in k} for d, o in outs.items()}
                check(met[dev] == met["cpu"], f"smoke {arch_id} {name} metrics differ: {met}")
                ties = _moe_near_ties(calls, B * (1 if decode else S)).reshape(B, -1)
                ties_all.append(ties)
                rows_off = ~ties[:, -1]  # logits: rows whose (last) token is off a near-tie
                check(bool(rows_off.any()), f"smoke {arch_id} {name}: every row's last token at a near-tie")
                got, want = outs[dev]["logits"].cpu(), outs["cpu"]["logits"]
                check(bool(torch.isfinite(got).all()) and torch.allclose(got[rows_off], want[rows_off],
                                                                         **MIXED_PREFILL_TOL),
                      f"smoke {arch_id} {name} logits differ by {(got - want)[rows_off].abs().max()} at step {s + 1}")
                err["logits"] = max(err.get("logits", 0.0), float((got - want)[rows_off].abs().max()))
                for k in ("k", "v"):
                    if decode:  # the row this step wrote
                        p = S - DEC_SMOKE_STEPS + s
                        g, w = states[dev]["cache"][k][:, :, p].float().cpu(), states["cpu"]["cache"][k][:, :, p].float()
                        g, w = g[:, ~ties[:, 0]], w[:, ~ties[:, 0]]
                    else:
                        g, w = outs[dev][f"cache_{k}"].float().cpu()[:, ~ties], outs["cpu"][f"cache_{k}"].float()[:, ~ties]
                    check(torch.allclose(g, w, **MIXED_PREFILL_TOL), f"smoke {arch_id} {name}: cache {k} differs")
                    err[f"cache_{k}"] = max(err.get(f"cache_{k}", 0.0), float((g - w).abs().max()))
            tie_share = float(np.mean(ties_all))  # over the cell's requests or steps
            check(tie_share <= MOE_MAX_TIE_SHARE, f"smoke {arch_id} {name}: near-ties {ties_all}")
            if decode:
                keep = torch.ones(S, dtype=torch.bool)
                keep[S - DEC_SMOKE_STEPS:] = False
                for k in ("k", "v"):
                    check(torch.equal(states[dev]["cache"][k].cpu()[:, :, keep], states["cpu"]["cache"][k][:, :, keep]),
                          f"smoke {arch_id} {name}: cache {k} changed where no step wrote")
                check(int(states[dev]["pos"]) == int(states["cpu"]["pos"]) == S, f"smoke {arch_id} {name} pos")
            res[name] = {"params": params, "steps": steps, "max_abs_diff": err, "near_tie_share": tie_share,
                         "metrics": met[dev]}
        out[arch_id] = res
    return out, launches


def _moe_model(arch_id: str, dev):
    """The arch at published widths with MOE_LAYERS layers, built and drawn
    on the card (``card_model``)."""
    from repro_torch.configs import get_config

    arch = get_config(arch_id)
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, n_layers=MOE_LAYERS[arch_id]))
    t0 = time.perf_counter()
    model = card_model(arch.model, dev)
    torch.cuda.synchronize()
    return arch, model, time.perf_counter() - t0


def _prefill_bound(cfg, T: int) -> dict:
    """The least time of a prefill request (batch 1), term by term: the
    flash kernel's operations over the causal triangle each layer, every
    other product (projections, the dense SwiGLU or the routed experts' k
    and the shared experts' SwiGLUs and the router; the head for the last
    token) at the bf16 peak, and the MIXED cast of every fp32 weight (read 4
    bytes, write 2, read 2) at the HBM rate."""
    d, hd, m = cfg.d_model, cfg.head_dim, cfg.moe
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    flash_ops = 4.0 * hd * cfg.n_heads * T * (T + 1) / 2
    ffn = 3 * d * cfg.d_ff if m is None else 3 * d * m.d_ff * (m.top_k + m.n_shared) + d * m.n_experts
    tok_ops = 2.0 * (attn + ffn)
    prod_ops = cfg.n_layers * T * tok_ops + 2.0 * d * cfg.vocab_size
    ffn_weights = 3 * d * cfg.d_ff if m is None else d * m.n_experts + 3 * d * m.d_ff * (m.n_experts + m.n_shared)
    n_weights = cfg.n_layers * (attn + ffn_weights) + d * cfg.vocab_size
    terms = {"flash_ms": cfg.n_layers * flash_ops / BF16_OPS_PER_S * 1e3,
             "products_ms": prod_ops / BF16_OPS_PER_S * 1e3,
             "weight_cast_ms": 8.0 * n_weights / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": sum(terms.values()), **terms, "flash_flops": cfg.n_layers * flash_ops,
            "product_flops": prod_ops, "weight_params": n_weights}


def _moe_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over MIXED_TOL's bound at each element."""
    tol = MIXED_TOL["atol"] + MIXED_TOL["rtol"] * want.float().abs()
    return float(((got.float() - want.float()).abs() / tol).max())


@torch.inference_mode()
def _moe_layer0(moe_lib, m, x0: torch.Tensor, y0: torch.Tensor, what: str) -> dict:
    """Layer 0's MoE output of a prefill request, on its recorded input,
    held against the dense plain version (``moe_dense_ref``: every expert on
    every token, in MOE_PIECE-token pieces) within MIXED_TOL, and what a
    zero output or one with the two busiest experts' weights swapped would
    read; both timed."""
    import types

    N = x0.shape[0]
    want = torch.cat([moe_lib.moe_dense_ref(m, x0[i:i + MOE_PIECE])[0] for i in range(0, N, MOE_PIECE)])
    _, _, top_e = moe_lib.route(m.router, x0, m.cfg.top_k)
    load = torch.bincount(top_e.reshape(-1), minlength=m.gate.shape[0])
    e0, e1 = (int(e) for e in torch.topk(load, 2).indices)
    perm = torch.arange(m.gate.shape[0], device=x0.device)
    perm[e0], perm[e1] = e1, e0
    swapped = types.SimpleNamespace(cfg=m.cfg, router=m.router, gate=m.gate[perm], up=m.up[perm],
                                    down=m.down[perm], shared=m.shared)
    y_sw = moe_lib.moe_apply(swapped, x0)[0]
    del swapped
    out = {"tokens": N, "max_abs_y": float(want.float().abs().max()),
           "max_abs_err": float((y0.float() - want.float()).abs().max()), "err_over_tol": _moe_excess(y0, want),
           "zero_output_err_over_tol": _moe_excess(torch.zeros_like(want), want),
           "swapped_experts": [e0, e1], "swapped_err_over_tol": _moe_excess(y_sw, want),
           "expert_rows_min_max": [int(load.min()), int(load.max())], "tolerance": MIXED_TOL}
    del y_sw
    check(out["err_over_tol"] <= 1.0, f"{what} layer 0 MoE against the dense plain version: {out}")
    check(out["zero_output_err_over_tol"] > 1.0 and out["swapped_err_over_tol"] > 1.0,
          f"the {what} layer 0 MoE check cannot tell a wrong output: {out}")
    out["ms"] = time_ms(lambda: moe_lib.moe_apply(m, x0), 3)
    out["plain_ms"] = time_ms(lambda: [moe_lib.moe_dense_ref(m, x0[i:i + MOE_PIECE]) for i in range(0, N, MOE_PIECE)],
                              1)
    c = m.cfg
    n_ops = 2.0 * N * (3 * c.d_model * c.d_ff * (c.top_k + c.n_shared) + c.d_model * c.n_experts)
    # x read, y written, the fp32 weights read once
    n_bytes = 2 * x0.numel() * x0.element_size() + 4 * sum(p.numel() for p in m.parameters())
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
    out["flops"], out["bytes"] = n_ops, n_bytes
    return out


def _lm_prefill(arch, model, sparse: dict, dev, label: str, counts, reset_counts, phase: dict,
                group_waits: list | None = None, trace: bool = True) -> tuple[dict, dict]:
    """A prefill_32k request of ``arch`` (batch 1, rows for every token):
    1 warm-up and N_PREFILL timed requests (CUDA events; the first timed one
    runs as phase ``label``: its inputs recorded), a flash launch a layer
    (on the tensor cores) and a gather a request, for a MoE arch one wait
    for the group sizes a MoE layer (``group_waits``), outputs checked, peak
    memory, and with ``trace`` a torch.profiler trace of one more request.
    Returns the line and the launches."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.cells import build_arch_cell

    cfg = arch.model
    V, L, gkey = cfg.vocab_size, cfg.n_layers, f"dim{cfg.d_model}"
    pre = build_arch_cell(arch, ShapeCell("prefill_32k", "prefill", {"seq_len": PREFILL_T, "global_batch": 1}),
                          device=dev)
    st = {"step": torch.zeros((), dtype=torch.int32, device=dev), "dense": model, "sparse": sparse}
    batches = [pre.make_batch(MOE_SEED + s) for s in range(1 + N_PREFILL + (1 if trace else 0))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tc0 = fa_ops.tensor_core_launches()
    waits0 = len(group_waits) if group_waits is not None else 0
    ms = []
    for s, batch in enumerate(batches[:1 + N_PREFILL]):
        phase["name"] = label if s == 1 else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o = pre.step_fn(st, batch)
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= 1:
            ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in o.items() if "/" in k}
        check(all(v == 0 for k, v in met.items() if "overflow" in k) and met[f"{gkey}/dev_rows_live"] == V,
              f"{label}: metrics {met}")
        check(o["logits"].shape == (1, V) and o["logits"].dtype == torch.float32
              and bool(torch.isfinite(o["logits"]).all()), f"{label}: logits")
        for k in ("cache_k", "cache_v"):
            check(o[k].shape == (L, 1, PREFILL_T, cfg.n_kv_heads, cfg.head_dim) and o[k].dtype == torch.bfloat16
                  and bool(torch.isfinite(o[k]).all()), f"{label}: {k}")
        del o
    n = 1 + N_PREFILL
    launches = counts()
    tc = fa_ops.tensor_core_launches()[0] - tc0[0]
    peak = torch.cuda.max_memory_allocated()
    want = {k: {"fused_gather.gather_rows": n, "flash_attention.flash_fwd": L * n}.get(k, 0) for k in launches}
    check(launches == want and tc == L * n, f"{label}: launches {launches} ({tc} on the tensor cores), expected {want}")
    if cfg.moe is not None:
        check(len(group_waits) - waits0 == L * n and all(w == cfg.moe.n_experts for w in group_waits[waits0:]),
              f"{label}: {len(group_waits) - waits0} waits for the group sizes, expected {L * n}")
    msa = np.array(ms)
    bound = _prefill_bound(cfg, PREFILL_T)
    line = {"phase": f"full_{label}", "arch": arch.arch_id, "shape": "prefill_32k", "seq_len": PREFILL_T, "batch": 1,
            "warmup": 1, "requests": N_PREFILL, "request_ms_p50": float(np.percentile(msa, 50)),
            "request_ms_p99": float(np.percentile(msa, 99)), "request_ms_mean": float(msa.mean()), "request_ms": ms,
            "tokens_per_s": PREFILL_T / (float(np.percentile(msa, 50)) / 1e3), **bound,
            "bound_share_p50": bound["bound_ms"] / float(np.percentile(msa, 50)),
            "max_memory_allocated_bytes": peak, "launches": launches, "flash_fwd_tensor_core_launches": tc,
            "profile": None}
    if cfg.moe is not None:
        line["group_size_waits_per_request"] = L
    if trace:
        prof = profile_requests(label, lambda b: pre.step_fn(st, b), batches[1 + N_PREFILL:])
        line["profile"] = {k: prof[k] for k in ("wall_ms_per_request", "device_busy_ms_per_request",
                                                 "device_idle_share", "device_events_per_request",
                                                 "top_device_ms_per_request")}
    return line, launches


def moe_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, flash_at: dict, dev,
              device_info: dict) -> dict:
    """The MoE family serving on the card (prefill and decode through the
    dropless grouped and gathered dispatch): (a) ``_moe_smoke``; (b)
    qwen2-moe-a2.7b ``prefill_32k`` at published widths and depth (batch 1,
    rows for all 151,936 tokens, weights drawn on the card): ``_lm_prefill``
    (phase ``moe_prefill``), layer 0's attention on every query row against
    the plain formula and layer 0's MoE against the dense plain version
    (``_moe_layer0``); (c) its ``decode_32k`` at batch 1 with the same
    weights: the decode of token DEC_T0 after a prefill held to a longer
    prefill's last logits (``_dec_after_prefill``; its first prefill's
    layer-0 flash inputs recorded as phase ``moe_decode``), then timed from
    a filled cache (``_dec_timed``, phase ``moe_decode``), no wait for the
    device in any step; (d) moonshot-v1-16b-a3b ``prefill_32k`` at
    published widths and 12 of its 48 layers, as (b); (e) the row gather
    and the flash kernel on the paths' recorded inputs against their plain
    versions, timed (paths ``moe_prefill``, ``moe_decode``). Returns the
    launches of the main-path runs."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.models import moe as moe_lib, transformer as tfm

    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(held < (1 << 30), f"{held} bytes still allocated before the MoE phase")
    launches = dict.fromkeys(counts(), 0)

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    # (a) smoke cells, card against CPU
    smoke, n = _moe_smoke(dev, counts, reset_counts)
    add(n)
    emit({"phase": "moe_smoke_card_vs_cpu", **device_info, "cells": smoke, "tolerance": MIXED_PREFILL_TOL,
          "near_tie_rel": MOE_NEAR_TIE_REL, "phase_s": time.perf_counter() - phase_t0})

    # the grouped dispatch's waits for the group sizes, and each request's
    # layer-0 MoE input and output (its first MoE call)
    waits, moe_io = [], {}
    real_sizes, real_apply = moe_lib._group_sizes, moe_lib.moe_apply

    def sizes(c):
        out = real_sizes(c)
        waits.append(len(out))
        return out

    def apply_rec(m, x, prec=moe_lib.MIXED, with_aux=True):
        y, aux = real_apply(m, x, prec, with_aux)
        if (phase["name"] or "").startswith("moe_prefill") and phase["name"] not in moe_io:
            moe_io[phase["name"]] = (m, x.clone(), y.clone())
        return y, aux

    moe_lib._group_sizes, moe_lib.moe_apply = sizes, apply_rec
    real = {"flash_attention": recorder(fa_ops, "flash_attention"), "gather_rows": recorder(fg_ops, "gather_rows")}
    lines = {}
    try:
        # (b) qwen2-moe-a2.7b prefill_32k
        arch, model, draw_s = _moe_model("qwen2-moe-a2.7b", dev)
        cfg = arch.model
        V, d, gkey = cfg.vocab_size, cfg.d_model, f"dim{cfg.d_model}"
        check(arch.shape("prefill_32k")["seq_len"] == PREFILL_T and arch.shape("decode_32k")["seq_len"] == 32_768,
              "the MoE shapes")
        widths = {"n_layers": cfg.n_layers, "d_model": d, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                  "head_dim": cfg.head_dim, "vocab_size": V, "qkv_bias": cfg.qkv_bias,
                  "moe": dataclasses.asdict(cfg.moe)}
        t0 = time.perf_counter()
        eng_cell = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {"seq_len": 32_768, "global_batch": 1}),
                                   device=dev)
        sparse = eng_cell.engine.import_rows(_dec_token_rows(eng_cell.engine, gkey, V, d, dev))
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        check(int(sparse[gkey]["idmap"].n_live()) == V, "not every token's row is live")
        state_bytes = {"dense_params": sum(p.numel() * p.element_size() for p in model.parameters()),
                       "engine": sum(t.numel() * t.element_size() for t in _tensors(sparse))}
        line, n = _lm_prefill(arch, model, sparse, dev, "moe_prefill", counts, reset_counts, phase, waits)
        add(n)
        fa_ops.flash_attention, fg_ops.gather_rows = real["flash_attention"], real["gather_rows"]
        q0, k0, v0 = recorded[("flash_attention", "moe_prefill")][0]
        line["layer0_attention_vs_plain"] = _attention_layer0(fa_ops, fa_ref, q0, k0, v0, "moe_prefill")
        del q0, k0, v0
        m0, x0, y0 = moe_io.pop("moe_prefill")
        check(m0 is model.layers[0].moe, "moe_prefill: the recorded MoE call is not layer 0's")
        line["layer0_moe_vs_plain"] = _moe_layer0(moe_lib, m0, x0, y0, "moe_prefill")
        del m0, x0, y0
        line.update(widths=widths, reduced={"global_batch": [32, 1]}, draw_on_card_s=draw_s, import_rows_s=import_s,
                    state_bytes=state_bytes, **device_info)
        emit(line)
        lines["qwen2-moe-a2.7b"] = line
        torch.cuda.empty_cache()

        # (c) decode: after a prefill (its flash inputs recorded), then timed
        # from a filled cache, batch 1 (its gather's inputs recorded)
        recorder(fa_ops, "flash_attention")
        phase["name"] = "moe_decode"
        try:
            pd = _dec_after_prefill(arch, model, sparse, dev, counts, reset_counts)
        finally:
            phase["name"] = None
            fa_ops.flash_attention = real["flash_attention"]
        add(pd["launches"])
        emit({"phase": "moe_decode_after_prefill", **device_info, "arch": arch.arch_id, "widths": widths, **pd,
              "tolerance_frac_of_largest": DEC_PREFILL_FRAC})
        torch.cuda.empty_cache()
        S = arch.shape("decode_32k")["seq_len"]
        c32 = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {"seq_len": S, "global_batch": 1}), device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        st = {"step": zero, "pos": zero.clone(), "dense": model, "sparse": sparse,
              "cache": tfm.init_cache(cfg, 1, S, dev)}
        waits0 = len(waits)
        per_step = {k: int(k == "fused_gather.gather_rows") for k in launches}
        recorder(fg_ops, "gather_rows")
        st, dline, _, _ = _dec_timed(c32, st, "moe_decode", S, MOE_SEED + 100, counts, reset_counts, phase,
                                     per_step, V)
        fg_ops.gather_rows = real["gather_rows"]
        add(dline["launches"])
        check(len(waits) == waits0, f"moe_decode: the steps waited for the device {len(waits) - waits0} times")
        dline.update(widths=widths, reduced={"global_batch": [128, 1]}, group_size_waits=len(waits) - waits0,
                     **device_info)
        emit(dline)
        lines["qwen2-moe-a2.7b decode"] = dline
        del st, c32, model, sparse, eng_cell
        torch.cuda.empty_cache()

        # (d) moonshot-v1-16b-a3b prefill_32k, 12 of its 48 layers
        arch, model, draw_s = _moe_model("moonshot-v1-16b-a3b", dev)
        cfg = arch.model
        V, d, gkey = cfg.vocab_size, cfg.d_model, f"dim{cfg.d_model}"
        t0 = time.perf_counter()
        eng_cell = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {"seq_len": 32_768, "global_batch": 1}),
                                   device=dev)
        sparse = eng_cell.engine.import_rows(_dec_token_rows(eng_cell.engine, gkey, V, d, dev))
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        state_bytes = {"dense_params": sum(p.numel() * p.element_size() for p in model.parameters()),
                       "engine": sum(t.numel() * t.element_size() for t in _tensors(sparse))}
        line, n = _lm_prefill(arch, model, sparse, dev, "moe_prefill_moonshot", counts, reset_counts, phase,
                              waits)
        add(n)
        m0, x0, y0 = moe_io.pop("moe_prefill_moonshot")
        check(m0 is model.layers[0].moe, "moe_prefill_moonshot: the recorded MoE call is not layer 0's")
        line["layer0_moe_vs_plain"] = _moe_layer0(moe_lib, m0, x0, y0, "moe_prefill_moonshot")
        del m0, x0, y0
        line.update(widths={"n_layers": cfg.n_layers, "d_model": d, "n_heads": cfg.n_heads,
                            "n_kv_heads": cfg.n_kv_heads, "vocab_size": V, "moe": dataclasses.asdict(cfg.moe)},
                    reduced={"global_batch": [32, 1], "n_layers": [48, cfg.n_layers]}, draw_on_card_s=draw_s,
                    import_rows_s=import_s, state_bytes=state_bytes, **device_info)
        emit(line)
        lines["moonshot-v1-16b-a3b"] = line
        del model, sparse, eng_cell
    finally:
        moe_lib._group_sizes, moe_lib.moe_apply = real_sizes, real_apply
        fa_ops.flash_attention, fg_ops.gather_rows = real["flash_attention"], real["gather_rows"]
        moe_io.clear()
    torch.cuda.empty_cache()

    # (e) the kernels on the paths' recorded inputs
    gat = {}
    for path in ("moe_prefill", "moe_decode"):
        args, kw = recorded.pop(("gather_rows", path))
        check(args[0].shape[1] == 2_048 and args[0].dtype == torch.float32, f"{path}: recorded gather {args[0].shape}")
        gat[path] = _measure("gather_rows", real["gather_rows"], fg_ref.gather_rows, args, kw, 20, dev)
        _add_path(by_name["fused_gather.gather_rows"], path, gat[path])
        del args
        torch.cuda.empty_cache()
    for path in ("moe_prefill", "moe_decode"):
        flash_at[path] = _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref,
                                        *recorded.pop(("flash_attention", path))[0], path=path)
        torch.cuda.empty_cache()
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "host_us", "bytes")
    emit({"phase": "moe_kernels", **device_info, "gather_rows": {p: {k: m[k] for k in keep} for p, m in gat.items()},
          "flash_fwd": {p: {k: flash_at[p][k] for k in keep} for p in ("moe_prefill", "moe_decode")},
          "launches": launches, "phase_s": time.perf_counter() - phase_t0})
    return launches


# ---------------------------------------------------------------------------
# 4 the MoE family trains: train_4k of qwen2-moe-a2.7b and moonshot-v1-16b-a3b
# ---------------------------------------------------------------------------
# 4 layers of each (24 and 48 at their published depth): 2.59 B and 2.62 B
# fp32 params, whose weights, gradients and AdamW moments take about 42 GB
# beside a 7.47 (8.05) GB engine; the published 14.0 B (27.7 B) would take
# 224 (443) GB. (warm-up, timed) steps a cell; qwen2-moe then takes one
# profiled step and N_LM_REPEAT on one repeated batch.
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = {"qwen2-moe-a2.7b": (2, 5), "moonshot-v1-16b-a3b": (1, 2)}
MOE_TRAIN_SEED = 70_000


def _lm_train_bound(cfg, T: int, n_params: int) -> dict:
    """The least time of a train step (batch 1), term by term: the
    products of the layers (their forward, its recompute and a backward of
    twice the forward: the projections, the dense SwiGLU or the routed
    experts' k and the shared experts' SwiGLUs and the router) and of the head (forward and
    backward) and the flash kernels (the forward twice, the backward's five
    products to the forward's two) at the bf16 peak; AdamW (p, g, m and v
    read, p, m and v written, fp32) and the MIXED casts (every weight cast
    in the forward and in the recompute, 4 bytes read and 2 written, its
    bf16 gradient cast back, 2 read and 4 written) at the HBM rate."""
    d, hd, m = cfg.d_model, cfg.head_dim, cfg.moe
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    ffn = 3 * d * cfg.d_ff if m is None else 3 * d * m.d_ff * (m.top_k + m.n_shared) + d * m.n_experts
    tok_ops = 2.0 * (attn + ffn)
    prod_ops = 4.0 * cfg.n_layers * T * tok_ops + 3.0 * 2.0 * T * d * cfg.vocab_size
    flash_fwd = 4.0 * hd * cfg.n_heads * T * (T + 1) / 2
    flash_ops = cfg.n_layers * (2.0 + 2.5) * flash_fwd
    terms = {"products_ms": prod_ops / BF16_OPS_PER_S * 1e3, "flash_ms": flash_ops / BF16_OPS_PER_S * 1e3,
             "adamw_ms": 28.0 * n_params / HBM_BYTES_PER_S * 1e3,
             "cast_ms": 18.0 * n_params / HBM_BYTES_PER_S * 1e3}
    return {"bound_ms": sum(terms.values()), **terms, "product_flops": prod_ops, "flash_flops": flash_ops,
            "dense_params": n_params}


def _grad_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over MIXED_TOL in units of want's largest
    magnitude (atol · max|want| + rtol · |want|): a sum over 4,096 tokens
    moves by about an ulp of its largest terms, not of each element."""
    w = want.float()
    tol = MIXED_TOL["atol"] * w.abs().max() + MIXED_TOL["rtol"] * w.abs()
    return float(((got.float() - w).abs() / tol).max())


def _moe_grads(moe_lib, fn, m, x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``fn``'s (``moe_apply`` or ``moe_dense_ref``) output on x and the
    gradients of sum(y · dy) / N + aux in x, the router, the three stacks
    and the shared experts' weights."""
    xg = x.detach().requires_grad_()
    y, aux = fn(m, xg)
    named = {"x": xg, "router": m.router, "gate": m.gate, "up": m.up, "down": m.down}
    if m.shared is not None:
        named.update({f"shared.{n}": getattr(m.shared, n).weight for n in ("gate", "up", "down")})
    g = torch.autograd.grad(torch.sum(y.float() * dy) / x.shape[0] + aux, list(named.values()))
    return y.detach(), dict(zip(named, g))


def _moe_layer0_grads(moe_lib, m, x0: torch.Tensor, what: str) -> dict:
    """Layer 0's MoE on its recorded train input (every token of the step):
    the grouped dispatch's output and gradients (``GroupedSwiGLU``'s
    backward, the gather's, the weighted sum's, the router's through the
    top-k weights and the aux loss) against the dense plain version
    (``moe_dense_ref``, every expert on every token) under autograd, for a
    seeded output gradient; the output within MIXED_TOL, each gradient
    within MIXED_TOL in units of its largest magnitude; what a zero
    gradient and the two busiest experts' weights swapped read; both
    timed."""
    import types

    N = x0.shape[0]
    dy = torch.randn(x0.shape, generator=torch.Generator(device=x0.device).manual_seed(SEED), device=x0.device)
    y, got = _moe_grads(moe_lib, moe_lib.moe_apply, m, x0, dy)
    y_ref, want = _moe_grads(moe_lib, moe_lib.moe_dense_ref, m, x0, dy)
    with torch.no_grad():
        _, _, top_e = moe_lib.route(m.router, x0, m.cfg.top_k)
    load = torch.bincount(top_e.reshape(-1), minlength=m.gate.shape[0])
    e0, e1 = (int(e) for e in torch.topk(load, 2).indices)
    perm = torch.arange(m.gate.shape[0], device=x0.device)
    perm[e0], perm[e1] = e1, e0
    swapped = types.SimpleNamespace(cfg=m.cfg, router=m.router, gate=m.gate[perm], up=m.up[perm],
                                    down=m.down[perm], shared=m.shared)
    _, sw = _moe_grads(moe_lib, moe_lib.moe_apply, swapped, x0, dy)
    del swapped
    out = {"tokens": N, "y_err_over_tol": _moe_excess(y, y_ref),
           "grad_err_over_tol": {n: _grad_excess(got[n], want[n]) for n in want},
           "grad_max_abs": {n: float(want[n].abs().max()) for n in want},
           "grad_max_abs_err": {n: float((got[n].float() - want[n].float()).abs().max()) for n in want},
           "zero_grad_err_over_tol": min(_grad_excess(torch.zeros_like(want[n]), want[n]) for n in want),
           "swapped_experts": [e0, e1],
           "swapped_grad_err_over_tol": {n: _grad_excess(sw[n], want[n]) for n in ("x", "gate", "up", "down")},
           "expert_rows_min_max": [int(load.min()), int(load.max())], "tolerance": MIXED_TOL}
    del got, want, sw, y, y_ref
    check(out["y_err_over_tol"] <= 1.0 and max(out["grad_err_over_tol"].values()) <= 1.0,
          f"{what} layer 0 MoE gradients against the dense plain version: {out}")
    check(out["zero_grad_err_over_tol"] > 1.0 and min(out["swapped_grad_err_over_tol"].values()) > 1.0,
          f"the {what} layer 0 MoE gradient check cannot tell a wrong gradient: {out}")
    out["ms"] = time_ms(lambda: _moe_grads(moe_lib, moe_lib.moe_apply, m, x0, dy), 3)
    out["plain_ms"] = time_ms(lambda: _moe_grads(moe_lib, moe_lib.moe_dense_ref, m, x0, dy), 1)
    return out


def _layer0_attention(real_bwd, fa_ref, bargs, label: str) -> dict:
    """Layer 0's attention gradients on all of a train step's rows (its
    recorded flash backward inputs) against the plain backward (at T 4,096
    its (H, T, T) fp32 scores are 1.07 GB), and what a zero gradient or the
    dK of the other kv head would read: ``flash_bwd_readings``."""
    got, want = real_bwd(*bargs), fa_ref.flash_bwd(*bargs)
    readings = flash_bwd_readings(got, want, bargs[0].dtype)
    check(all(bool(torch.isfinite(g).all()) for g in got), f"{label} layer 0 gradients not finite")
    check(max(readings[f"{g}_err_over_tol"] for g in GRAD_NAMES) <= 1.0,
          f"{label} layer 0 attention gradients {readings}")
    check(min(readings[f"{g}_zero_err_over_tol"] for g in GRAD_NAMES) > 1.0
          and (readings["dk_other_kv_head_err_over_tol"] is None  # one kv head: no other to read
               or readings["dk_other_kv_head_err_over_tol"] > 1.0),
          f"the {label} layer 0 gradient check cannot tell a wrong gradient: {readings}")
    return readings


def _lm_train(arch, n_layers: int | None, opts, dev, counts, reset_counts, phase: dict, label: str, n_warm: int,
              n_timed: int, seed: int, waits: list | None = None, repeat: int = 0,
              trace: bool = True) -> tuple[dict, dict, dict]:
    """``arch``'s ``train_4k`` at its published widths (T 4,096, batch 1;
    ``n_layers`` layers, or all of them with None) with cell options
    ``opts``, from a fresh state (its weights drawn on the card, zero
    moments, an empty engine): ``n_warm`` warm-up and ``n_timed`` timed
    steps on the batches of seeds ``seed``, ``seed + 1``, ... (the last
    warm-up step runs as phase ``label``: the wrappers that record, record
    it), each checked: no overflow, a finite loss and params, the rows live
    equal to the distinct tokens seen, the exact launches and, for a MoE
    arch, two waits for the group sizes a MoE layer (``waits``, the sizes
    ``moe._group_sizes`` returned). With ``repeat`` one more step under the
    profiler (its line emitted; not without ``trace``) and ``repeat`` steps
    on one repeated batch (the loss falls). Returns the phase line, the
    launches and the state."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.optim import adamw

    published = arch
    if n_layers is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, n_layers=n_layers))
    check(arch.shape("train_4k")["seq_len"] == LM_TRAIN_T, f"{arch.arch_id} train_4k seq_len")
    t0 = time.perf_counter()
    cell = build_arch_cell(arch, ShapeCell("train_4k", "train", {"seq_len": LM_TRAIN_T, "global_batch": 1}),
                           opts, dev)
    cfg = cell.arch.model
    dense = card_model(cfg, dev)
    st = {"step": torch.zeros((), dtype=torch.int32, device=dev), "dense": dense,
          "opt": adamw.init(dict(dense.named_parameters())), "sparse": cell.engine.init_state()}
    del dense
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    L, gkey = cfg.n_layers, f"dim{cfg.d_model}"
    n_params = sum(p.numel() for p in st["dense"].parameters())
    state_bytes = {"dense_params": 4 * n_params,
                   "adamw_moments": sum(t.numel() * t.element_size() for t in _tensors(st["opt"])),
                   "engine": sum(t.numel() * t.element_size() for t in _tensors(st["sparse"]))}
    n = n_warm + n_timed
    batches = [cell.make_batch(seed + s) for s in range(n + (2 if repeat else 0))]
    expect_live, seen = [], torch.empty(0, dtype=torch.int32, device=dev)
    for b in batches[:n]:  # distinct tokens seen up to each step: the rows it must hold
        seen = torch.unique(torch.cat([seen, b.reshape(-1)]))
        expect_live.append(seen.numel())
    del seen
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tc0 = fa_ops.tensor_core_launches()
    step_ms, losses, inserted, per_step = [], [], [], []
    for s in range(n):
        phase["name"] = label if s == n_warm - 1 else None
        before, w0 = counts(), len(waits) if waits is not None else 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, out = cell.step_fn(st, batches[s])
        end.record()
        end.synchronize()
        phase["name"] = None
        if s >= n_warm:
            step_ms.append(start.elapsed_time(end))
        met = {k: int(v) for k, v in out.items() if k != "loss"}
        losses.append(float(out["loss"]))
        inserted.append(met[f"{gkey}/idmap_inserted"])
        got = {k: v - before[k] for k, v in counts().items()}
        want = {k: {"fused_gather.gather_rows": 4, "fused_scatter.scatter_add_rows": 3,
                    "fused_scatter.scatter_set_rows": 3 * (inserted[-1] > 0), "flash_attention.flash_fwd": 2 * L,
                    "flash_attention.flash_bwd": L}.get(k, 0) for k in got}
        check(all(v == 0 for k, v in met.items() if "overflow" in k), f"{label} overflow at step {s + 1}: {met}")
        check(np.isfinite(losses[-1]), f"{label} loss {losses[-1]} at step {s + 1}")
        check(all(bool(torch.isfinite(p).all()) for p in st["dense"].parameters()),
              f"{label} params not finite after step {s + 1}")
        check(met[f"{gkey}/dev_rows_live"] == expect_live[s],
              f"{label} step {s + 1}: {met[f'{gkey}/dev_rows_live']} rows live, {expect_live[s]} tokens seen")
        check(got == want, f"{label} step {s + 1}: launches {got}, expected {want}")
        if cfg.moe is not None:
            per_step.append(len(waits) - w0)
            check(per_step[-1] == 2 * L and all(w == cfg.moe.n_experts for w in waits[w0:]),
                  f"{label} step {s + 1}: {per_step[-1]} waits for the group sizes, expected {2 * L}")
    peak = torch.cuda.max_memory_allocated()
    launches = counts()
    tc = [a - b for a, b in zip(fa_ops.tensor_core_launches(), tc0)]
    check(tc == [launches["flash_attention.flash_fwd"], launches["flash_attention.flash_bwd"]],
          f"{label}: tensor-core launches {tc} of {launches}")
    check(inserted[0] > 0, f"{label} step 1 inserted nothing")
    sm = np.array(step_ms)
    bound = _lm_train_bound(cfg, LM_TRAIN_T, n_params)
    reduced = {"global_batch": [published.shape("train_4k")["global_batch"], 1]}
    if n_layers is not None:
        reduced["n_layers"] = [published.model.n_layers, L]
    line = {"phase": f"full_{label}", "arch": arch.arch_id, "shape": "train_4k", "seq_len": LM_TRAIN_T,
            "widths": {"n_layers": L, "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
                       "qkv_bias": cfg.qkv_bias, "rope_theta": cfg.rope_theta,
                       "moe": dataclasses.asdict(cfg.moe) if cfg.moe is not None else None},
            "reduced": reduced,
            "options": {"remat": cfg.remat, "remat_policy": cfg.remat_policy, "fused_ce": opts.fused_ce,
                        "dense_opt_lr": opts.dense_opt_lr, "sparse_opt_lr": opts.sparse_opt_lr},
            "warmup": n_warm, "steps": n_timed, "setup_s": setup_s,
            "step_ms_p50": float(np.percentile(sm, 50)), "step_ms_p99": float(np.percentile(sm, 99)),
            "step_ms_mean": float(sm.mean()), "step_ms": step_ms,
            "tokens_per_s": LM_TRAIN_T / (float(np.percentile(sm, 50)) / 1e3), **bound,
            "bound_share_p50": bound["bound_ms"] / float(np.percentile(sm, 50)),
            "loss": losses, "idmap_inserted": inserted, "rows_live": expect_live, "state_bytes": state_bytes,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "flash_tensor_core_launches": {"fwd": tc[0], "bwd": tc[1]},
            "launches_per_step": {k: v / n for k, v in launches.items()}}
    if cfg.moe is not None:
        line["group_size_waits_per_step"] = per_step
    if repeat:
        def step(b):
            nonlocal st
            st, _ = cell.step_fn(st, b)

        line["profile"] = None
        if trace:
            prof = profile_requests(label, step, [batches[n]])
            emit(prof)
            line["profile"] = {k: prof[k] for k in ("wall_ms_per_request", "device_busy_ms_per_request",
                                                     "device_idle_share", "device_events_per_request",
                                                     "fp32_add_ms_per_request", "fp32_fill_ms_per_request",
                                                     "top_device_ms_per_request")}
        losses_repeat = []
        for _ in range(repeat):  # one batch again and again: the loss must fall
            st, out = cell.step_fn(st, batches[-1])
            losses_repeat.append(float(out["loss"]))
        check(all(np.isfinite(losses_repeat)) and losses_repeat[-1] < losses_repeat[0],
              f"{label} loss on one repeated batch: {losses_repeat}")
        line["loss_on_one_repeated_batch"] = losses_repeat
        launches = counts()  # the profiled and repeated steps are on the path too
    return line, launches, st


def moe_train_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, flash_at: dict, dev,
                    device_info: dict) -> tuple[dict, dict]:
    """The MoE family training on the card (``train_4k``, the grouped
    dispatch and its backward, the aux loss): (a) qwen2-moe-a2.7b at
    published widths and MOE_TRAIN_LAYERS layers (``_lm_train``, phase
    ``moe_train``), then layer 0's attention gradients on all 4,096 rows
    against the plain backward and layer 0's MoE output and gradients
    against the dense plain version (``_moe_layer0_grads``); (b) the flash
    kernels, the row gather and the scatters on (a)'s recorded inputs
    against their plain versions, timed (path ``moe_train``); (c) the same
    arch from the same drawn weights with ``fused_ce=True,
    remat_policy="dots"`` for 1 step: its loss within MIXED_TOL of (a)'s
    step 1, its peak; (d) moonshot-v1-16b-a3b as (a), 1 + 2 steps. Returns
    the launches of the main-path runs and the flash backward's
    measurement."""
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.configs import get_config
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import moe as moe_lib

    phase_t0 = time.perf_counter()
    qwen = get_config("qwen2-moe-a2.7b")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(held < (1 << 30), f"{held} bytes still allocated before the MoE train phase")
    launches = dict.fromkeys(counts(), 0)

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    waits, moe_io = [], {}
    real_sizes, real_apply = moe_lib._group_sizes, moe_lib.moe_apply

    def sizes(c):
        out = real_sizes(c)
        waits.append(len(out))
        return out

    def apply_rec(m, x, prec=moe_lib.MIXED, with_aux=True):  # layer 0's: a step's first MoE call
        if phase["name"] and phase["name"] not in moe_io:
            moe_io[phase["name"]] = (m, x.detach().clone())
        return real_apply(m, x, prec, with_aux)

    real = {"flash_attention": recorder(fa_ops, "flash_attention"), "gather_rows": recorder(fg_ops, "gather_rows"),
            "scatter_add_rows": recorder(fs_ops, "scatter_add_rows"),
            "scatter_set_rows": recorder(fs_ops, "scatter_set_rows"), "flash_bwd": fa_ops.flash_bwd}

    def record_last_bwd(*args, **kw):  # layer 0's backward: the step's last call
        if phase["name"]:
            recorded[("flash_bwd", phase["name"])] = ([_keep(a, False) for a in args], kw)
        return real["flash_bwd"](*args, **kw)

    moe_lib._group_sizes, moe_lib.moe_apply, fa_ops.flash_bwd = sizes, apply_rec, record_last_bwd
    try:
        # (a) qwen2-moe-a2.7b train_4k, the main path
        line, n, st = _lm_train(qwen, MOE_TRAIN_LAYERS, CellOptions(), dev, counts, reset_counts, phase, "moe_train",
                                *MOE_TRAIN_STEPS["qwen2-moe-a2.7b"], MOE_TRAIN_SEED, waits, repeat=N_LM_REPEAT)
        add(n)
        for k, fn in real.items():  # the wrappers record no more
            setattr(fa_ops if k.startswith("flash") else fs_ops if k.startswith("scatter") else fg_ops,
                    k, fn)
        m0, x0 = moe_io.pop("moe_train")
        check(m0 is st["dense"].layers[0].moe, "moe_train: the recorded MoE call is not layer 0's")
        del st
        torch.cuda.empty_cache()
        bargs = recorded.pop(("flash_bwd", "moe_train"))[0]
        layer0 = _layer0_attention(real["flash_bwd"], fa_ref, bargs, "moe_train")
        line["layer0_attention_grads_vs_plain"] = layer0
        line["layer0_moe_grads_vs_plain"] = _moe_layer0_grads(moe_lib, m0, x0, "moe_train")
        del m0, x0
        line.update(device_info)
        emit(line)
        torch.cuda.empty_cache()

        # (b) the kernels on (a)'s recorded inputs, which hold (a)'s engine tables
        flash_at["moe_train"] = _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref,
                                               *recorded.pop(("flash_attention", "moe_train"))[0], path="moe_train")
        bwd = _measure_flash_bwd(real["flash_bwd"], fa_ref, *bargs, path="moe_train")
        bwd["at"]["moe_train"].update(readings=layer0, **{k: bwd[k] for k in (
            "ms", "kernel_device_ms", "kernel_device_ms_by_kernel", "plain_ms", "bound_ms", "bound_by", "bound_share",
            "host_us", "library_ms", "two_launches_bit_equal")})
        bwd["at"]["moe_train"]["max_abs_err"] = max(layer0[f"{g}_max_abs_err"] for g in GRAD_NAMES)
        del bargs
        at = {}
        for full, kname, plain in (("fused_gather.gather_rows", "gather_rows", fg_ref.gather_rows),
                                   ("fused_scatter.scatter_add_rows", "scatter_add_rows", fs_ref.scatter_add_rows),
                                   ("fused_scatter.scatter_set_rows", "scatter_set_rows", fs_ref.scatter_set_rows)):
            if (kname, "moe_train") not in recorded:  # the set runs on a step that inserts rows
                continue
            args, kw = recorded.pop((kname, "moe_train"))
            at[kname] = _measure(kname, real[kname], plain, args, kw, 20, dev)
            _add_path(by_name[full], "moe_train", at[kname])
            del args
            torch.cuda.empty_cache()

        # (c) the same weights with the chunked loss and the "dots" remat
        vline, n, st = _lm_train(qwen, MOE_TRAIN_LAYERS, CellOptions(fused_ce=True, remat_policy="dots"), dev,
                                 counts, reset_counts, phase, "moe_train_fused_dots", 0, 1, MOE_TRAIN_SEED, waits)
        del st
        add(n)
        moe_io.clear()
        check(abs(vline["loss"][0] - line["loss"][0]) <= MIXED_TOL["atol"] + MIXED_TOL["rtol"] * abs(line["loss"][0]),
              f"moe_train with fused_ce and dots: step-1 loss {vline['loss'][0]}, default {line['loss'][0]}")
        emit({**{k: vline[k] for k in ("phase", "arch", "options", "loss", "step_ms", "max_memory_allocated_bytes",
                                        "launches", "group_size_waits_per_step")},
              "default_step1_loss": line["loss"][0], "default_max_memory_allocated_bytes":
                  line["max_memory_allocated_bytes"], "tolerance": MIXED_TOL, **device_info})
        torch.cuda.empty_cache()

        # (d) moonshot-v1-16b-a3b train_4k
        mline, n, st = _lm_train(get_config("moonshot-v1-16b-a3b"), MOE_TRAIN_LAYERS, CellOptions(), dev, counts,
                                 reset_counts, phase, "moe_train_moonshot", *MOE_TRAIN_STEPS["moonshot-v1-16b-a3b"],
                                 MOE_TRAIN_SEED, waits)
        add(n)
        del st
        moe_io.clear()
        mline.update(device_info)
        emit(mline)
    finally:
        moe_lib._group_sizes, moe_lib.moe_apply = real_sizes, real_apply
        for k, fn in real.items():
            setattr(fa_ops if k.startswith("flash") else fs_ops if k.startswith("scatter") else fg_ops, k, fn)
        moe_io.clear()
    torch.cuda.empty_cache()
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "writeback_device_ms", "host_us", "bytes")
    emit({"phase": "moe_train_kernels", **device_info, **{k: {x: m[x] for x in keep if x in m} for k, m in at.items()},
          "flash_fwd": {x: flash_at["moe_train"][x] for x in keep if x in flash_at["moe_train"]},
          "flash_bwd": {x: bwd["at"]["moe_train"][x] for x in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                               "bound_ms", "bound_by", "kernel_device_ms", "host_us",
                                                               "bytes")},
          "launches": launches, "phase_s": time.perf_counter() - phase_t0})
    return launches, bwd["at"]["moe_train"]


# ---------------------------------------------------------------------------
# 4 the 20B dense archs serve and train: granite-20b (MQA, G 48) and
# internlm2-20b (GQA, G 6)
# ---------------------------------------------------------------------------
# Each at published widths with its depth cut: at full depth the fp32 weights
# take 111.5 GB (granite) and 77.2 GB (internlm2), which no card holds beside
# an engine and the activations. The three serve cells of an arch share one
# model drawn on the card and one engine with rows for every token (98,304
# and 185,088 rows of 6,144 with two moment slots: 7.25 and 13.65 GB);
# decode_32k's batch is cut so that its bf16 cache fits beside them (10.74
# and 25.77 GB); train_4k runs 4 layers at batch 1. The peaks reckoned from
# the configs before the first card run (PERF.md §4), in GB:
LM20B = {
    "granite-20b": {"short": "granite", "serve_layers": 20, "decode_batch": 32, "train_layers": 4,
                    "reckoned_gb": {"prefill_32k": 59, "decode_32k": 62, "long_500k": 57, "train_4k": 51}},
    "internlm2-20b": {"short": "internlm2", "serve_layers": 12, "decode_batch": 16, "train_layers": 4,
                      "reckoned_gb": {"prefill_32k": 44, "decode_32k": 61, "long_500k": 61, "train_4k": 55}},
}
LM20B_TRAIN_STEPS = (2, 3)  # warm-up, timed; then N_LM_REPEAT steps on one repeated batch
# The train cells' AdamW and SparseAdam learning rate. AdamW's first steps
# move every weight by about lr, and at d 6,144 a logit sums 6,144 such
# moves: at the default 1e-3 the loss rose over the random batches (granite
# in a dev run: 10.97, 10.97, 11.09, 13.95, 14.59) and on one repeated batch
# (13.54, 12.11, 17.57; internlm2 11.91, 12.41). The step's work is the same
# at any rate.
LM20B_LR = 1e-4
LM20B_SEED = 80_000
LM20B_PLAIN_ROWS = 256      # query rows a piece of the plain attention at H 48 (at 1,024: 6.4 GB of fp32 scores)
LM20B_TRACED = ("granite-20b", "train_4k")  # one trace in the phase (a trace costs 11-13 s)


def lm20b_phase(counts, reset_counts, phase: dict, recorded: dict, recorder, by_name: dict, flash_at: dict, dev,
                device_info: dict) -> tuple[dict, dict]:
    """granite-20b and internlm2-20b on the card, each in turn: (a) its
    ``prefill_32k`` (``_lm_prefill``, batch 1, phase ``<arch>_prefill``)
    with layer 0's attention on every query row against the plain formula
    (``_attention_layer0``), its ``decode_32k`` at a cut batch and its
    ``long_500k`` (``_dec_timed`` from a filled cache), all on one drawn
    model and engine; (b) the row gather and the flash forward on the
    prefill's recorded inputs against their plain versions, timed; (c) its
    ``train_4k`` at 4 layers (``_lm_train``, 2 warm-up and 3 timed steps,
    then N_LM_REPEAT on one repeated batch; AdamW and SparseAdam at
    LM20B_LR), layer 0's attention gradients
    on every row against the plain backward; (d) the flash backward, the
    gather and the scatters on (c)'s recorded inputs, timed. One cell
    (LM20B_TRACED) is traced. Each cell's line holds its cuts, p50, bound
    and share, peak against the reckoned one and launches. Returns the
    launches of the main-path runs and the flash backward's measurements by
    path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.fused_gather import ops as fg_ops, ref as fg_ref
    from repro_torch.kernels.fused_scatter import ops as fs_ops, ref as fs_ref
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.launch.common import CellOptions
    from repro_torch.models import transformer as tfm

    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    check(held < (1 << 30), f"{held} bytes still allocated before the 20B phase")
    launches = dict.fromkeys(counts(), 0)

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    mods = {"flash_attention": fa_ops, "flash_bwd": fa_ops, "gather_rows": fg_ops, "scatter_add_rows": fs_ops,
            "scatter_set_rows": fs_ops}
    real = {k: getattr(m, k) for k, m in mods.items()}

    def unwrap():
        for k, fn in real.items():
            setattr(mods[k], k, fn)

    def record_last_bwd(*args, **kw):  # layer 0's backward: the step's last call
        if phase["name"]:
            recorded[("flash_bwd", phase["name"])] = ([_keep(a, False) for a in args], kw)
        return real["flash_bwd"](*args, **kw)

    def finish(line: dict, arch_id: str, shape: str) -> None:  # the peak beside the reckoned one; emitted
        line["reckoned_peak_bytes"] = LM20B[arch_id]["reckoned_gb"][shape] * 1e9
        line["peak_over_reckoned"] = line["max_memory_allocated_bytes"] / line["reckoned_peak_bytes"]
        line["traced"] = (arch_id, shape) == LM20B_TRACED
        line.update(device_info)
        emit(line)

    bwd_at, at = {}, {}
    try:
        for arch_id, c in LM20B.items():
            published, short = get_config(arch_id), c["short"]
            L_pub = published.model.n_layers
            # (a) the serve cells on one model and engine
            arch = dataclasses.replace(published, model=dataclasses.replace(published.model,
                                                                            n_layers=c["serve_layers"]))
            cfg = arch.model
            V, d, gkey, label = cfg.vocab_size, cfg.d_model, f"dim{cfg.d_model}", f"{short}_prefill"
            widths = {"n_layers": cfg.n_layers, "d_model": d, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                      "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab_size": V, "qkv_bias": cfg.qkv_bias,
                      "rope_theta": cfg.rope_theta}
            t0 = time.perf_counter()
            model = card_model(cfg, dev)
            torch.cuda.synchronize()
            draw_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng_cell = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {
                "seq_len": 32_768, "global_batch": c["decode_batch"]}), device=dev)
            sparse = eng_cell.engine.import_rows(_dec_token_rows(eng_cell.engine, gkey, V, d, dev))
            torch.cuda.synchronize()
            import_s = time.perf_counter() - t0
            check(int(sparse[gkey]["idmap"].n_live()) == V, f"{arch_id}: not every token's row is live")
            state_bytes = {"dense_params": sum(p.numel() * p.element_size() for p in model.parameters()),
                           "engine": sum(t.numel() * t.element_size() for t in _tensors(sparse))}
            recorder(fa_ops, "flash_attention")
            recorder(fg_ops, "gather_rows")
            try:
                line, n = _lm_prefill(arch, model, sparse, dev, label, counts, reset_counts, phase,
                                      trace=LM20B_TRACED == (arch_id, "prefill_32k"))
            finally:
                unwrap()
            add(n)
            line["layer0_attention_vs_plain"] = _attention_layer0(
                fa_ops, fa_ref, *recorded[("flash_attention", label)][0], label, rows=LM20B_PLAIN_ROWS)
            line.update(widths=widths, reduced={"global_batch": [32, 1], "n_layers": [L_pub, cfg.n_layers]},
                        draw_on_card_s=draw_s, import_rows_s=import_s, state_bytes=state_bytes)
            finish(line, arch_id, "prefill_32k")
            torch.cuda.empty_cache()
            per_step = {k: int(k == "fused_gather.gather_rows") for k in launches}
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            for i, (name, B) in enumerate((("decode_32k", c["decode_batch"]), ("long_500k", 1))):
                shape = arch.shape(name)
                S = shape["seq_len"]
                cell = build_arch_cell(arch, ShapeCell(name, "decode", {**shape.params, "global_batch": B}),
                                       device=dev)
                st = {"step": zero, "pos": zero.clone(), "dense": model, "sparse": sparse,
                      "cache": tfm.init_cache(cfg, B, S, dev)}
                st, dline, _, _ = _dec_timed(cell, st, f"{short}_{name}", S, LM20B_SEED + i, counts,
                                             reset_counts, phase, per_step, V, trace=LM20B_TRACED == (arch_id, name))
                add(dline["launches"])
                dline.update(widths=widths, reduced={"n_layers": [L_pub, cfg.n_layers],
                                                     **({"global_batch": [shape["global_batch"], B]}
                                                        if B != shape["global_batch"] else {})},
                             cache_bytes=sum(t.numel() * t.element_size() for t in st["cache"].values()))
                finish(dline, arch_id, name)
                del st, cell
                torch.cuda.empty_cache()
            del model, sparse, eng_cell
            torch.cuda.empty_cache()

            # (b) the serve kernels on the prefill's recorded inputs
            flash_at[label] = _measure_flash(real["flash_attention"], fa_ops.flash_fwd, fa_ref,
                                             *recorded.pop(("flash_attention", label))[0], path=label)
            torch.cuda.empty_cache()
            args, kw = recorded.pop(("gather_rows", label))
            at[("gather_rows", label)] = _measure("gather_rows", real["gather_rows"], fg_ref.gather_rows, args, kw,
                                                  20, dev)
            _add_path(by_name["fused_gather.gather_rows"], label, at[("gather_rows", label)])
            del args
            torch.cuda.empty_cache()

            # (c) train_4k at 4 layers
            tlabel = f"{short}_train"
            for k in ("gather_rows", "scatter_add_rows", "scatter_set_rows"):
                recorder(mods[k], k)
            fa_ops.flash_bwd = record_last_bwd
            try:
                tline, n, st = _lm_train(published, c["train_layers"],
                                         CellOptions(dense_opt_lr=LM20B_LR, sparse_opt_lr=LM20B_LR), dev, counts,
                                         reset_counts, phase, tlabel, *LM20B_TRAIN_STEPS, LM20B_SEED + 10,
                                         repeat=N_LM_REPEAT,
                                         trace=LM20B_TRACED == (arch_id, "train_4k"))
            finally:
                unwrap()
            add(n)
            del st
            torch.cuda.empty_cache()
            bargs = recorded.pop(("flash_bwd", tlabel))[0]
            layer0 = _layer0_attention(real["flash_bwd"], fa_ref, bargs, tlabel)
            tline["layer0_attention_grads_vs_plain"] = layer0
            finish(tline, arch_id, "train_4k")
            torch.cuda.empty_cache()

            # (d) the train kernels on (c)'s recorded inputs
            bwd = _measure_flash_bwd(real["flash_bwd"], fa_ref, *bargs, path=tlabel)
            bwd["at"][tlabel].update(readings=layer0, max_abs_err=max(layer0[f"{g}_max_abs_err"] for g in GRAD_NAMES),
                                     **{k: bwd[k] for k in ("ms", "kernel_device_ms", "kernel_device_ms_by_kernel",
                                                            "plain_ms", "bound_ms", "bound_by", "bound_share",
                                                            "host_us", "library_ms", "two_launches_bit_equal")})
            bwd_at[tlabel] = bwd["at"][tlabel]
            del bargs, bwd
            torch.cuda.empty_cache()
            for full, kname, plain in (("fused_gather.gather_rows", "gather_rows", fg_ref.gather_rows),
                                       ("fused_scatter.scatter_add_rows", "scatter_add_rows", fs_ref.scatter_add_rows),
                                       ("fused_scatter.scatter_set_rows", "scatter_set_rows", fs_ref.scatter_set_rows)):
                if (kname, tlabel) not in recorded:  # the set runs on a step that inserts rows
                    continue
                args, kw = recorded.pop((kname, tlabel))
                at[(kname, tlabel)] = _measure(kname, real[kname], plain, args, kw, 20, dev)
                _add_path(by_name[full], tlabel, at[(kname, tlabel)])
                del args
                torch.cuda.empty_cache()
    finally:
        unwrap()
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "kernel_device_ms",
            "writeback_device_ms", "host_us", "bytes")
    emit({"phase": "lm20b_kernels", **device_info,
          **{f"{k}@{p}": {x: m[x] for x in keep if x in m} for (k, p), m in at.items()},
          **{f"flash_fwd@{short}_prefill": {x: flash_at[f"{short}_prefill"][x] for x in keep
                                             if x in flash_at[f"{short}_prefill"]}
             for short in (c["short"] for c in LM20B.values())},
          **{f"flash_bwd@{p}": {x: m[x] for x in keep if x in m} for p, m in bwd_at.items()},
          "launches": launches, "phase_s": time.perf_counter() - phase_t0})
    return launches, bwd_at


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
