#!/usr/bin/env python3
"""dlrm-mlperf's serve_p99 request with its 26 sum features pooled in one
grouped segment-sum launch (``EmbeddingEngine.activations``) against the
same request pooled feature by feature through ``_pool`` (one segment-sum
launch and wrapper call each, as the engine pooled before), in one process
on one card:

    python3 scripts/serve_pool_ab.py [--pairs 10] [--requests 20]

The cell is built at full width with the vocabulary cut to 250,000 rows per
feature and every id's row imported, as ``chip_smoke.py`` serves it. Each
pair times ``--requests`` requests (after 3 warm-up) one way and then the
other, alternating which goes first; a request's latency is CUDA events
around the step, synchronised. Both ways' logits are held bit-equal on
every batch. Prints the card and one JSON object per pair, then a summary:
each way's median of the per-pair p50s, the pairs the grouped way won,
and the spread of each way's p50s (the distance between their quartiles).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 250_000  # per feature, as chip_smoke.py serves it
SEED = 0


def per_feature_activations(self, rows_r, plans, ids_by_feature):
    """The engine's pooling feature by feature: each feature's slice of the
    routed rows through ``_pool``."""
    from repro_torch.core import embedding_engine as ee

    out = {}
    for key, g in self.groups.items():
        vals = ee.exchange.route_rows(rows_r[key], plans[key], g.exchange)
        ofs = 0
        for s in g.features:
            r = ids_by_feature[s.name]
            out[s.name] = ee._pool(vals[ofs:ofs + r.nnz_budget], r, s)
            ofs += r.nnz_budget
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--requests", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_pool_ab: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.core.feature_engine import FeatureEngine
    from repro_torch.io.ragged import Ragged
    from repro_torch.kernels.segment_reduce import ops as sr_ops
    from repro_torch.launch import recsys_cell

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    arch = dataclasses.replace(dlrm_mlperf.ARCH, model=dataclasses.replace(
        dlrm_mlperf.ARCH.model, vocab_per_feature=VOCAB))
    cell = recsys_cell.build(arch, arch.shape("serve_p99"), device=dev)
    hash_specs = [s for s in recsys_cell._model_mod(arch.arch_id).feature_specs(arch.model)
                  if s.transform == "hash"]
    raw = torch.arange(VOCAB, dtype=torch.int64, device=dev)
    splits = torch.arange(VOCAB + 1, dtype=torch.int32, device=dev)
    ids, _ = FeatureEngine(hash_specs, dev).apply({s.name: Ragged(raw, splits) for s in hash_specs})
    all_ids = cell.engine.engine_ids(ids)["dim128"]
    n = all_ids.numel()
    emb = torch.randn((n, arch.model.embed_dim), generator=torch.Generator(device=dev).manual_seed(SEED),
                      device=dev).mul_(0.05)
    zeros = torch.zeros_like(emb)
    state = cell.init_state()
    state["sparse"] = cell.engine.import_rows({"dim128": {
        "ids": all_ids, "emb": emb, "slots": {"m": zeros, "v": zeros},
        "last_use": torch.zeros(n, dtype=torch.int32, device=dev)}})
    del emb, zeros, all_ids, ids, raw, splits
    batches = [cell.make_batch(s, vocab=VOCAB) for s in range(3 + a.requests)]
    grouped = cell.engine.activations
    ways = {"grouped": grouped, "per_feature": types.MethodType(per_feature_activations, cell.engine)}

    def run(way: str) -> tuple[list[float], list[torch.Tensor], tuple[int, int]]:
        cell.engine.activations = ways[way]
        before = (sr_ops.GROUP_LAUNCHES, sr_ops.LAUNCHES)
        lat, logits = [], []
        for s, b in enumerate(batches):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = cell.step_fn(state, b)
            end.record()
            end.synchronize()
            if s >= 3:
                lat.append(start.elapsed_time(end))
            logits.append(out["logits"])
        return lat, logits, (sr_ops.GROUP_LAUNCHES - before[0], sr_ops.LAUNCHES - before[1])

    p50 = {w: [] for w in ways}
    for i in range(a.pairs):
        order = ("grouped", "per_feature") if i % 2 == 0 else ("per_feature", "grouped")
        res = {w: run(w) for w in order}
        if not all(torch.equal(x, y) for x, y in zip(res["grouped"][1], res["per_feature"][1])):
            raise AssertionError(f"pair {i}: the two ways' logits differ")
        launches = {w: res[w][2] for w in ways}
        if launches["grouped"] != (len(batches), 0) or launches["per_feature"] != (0, 26 * len(batches)):
            raise AssertionError(f"pair {i}: segment-sum launches (grouped, per feature) {launches}")
        row = {"pair": i, "first": order[0]}
        for w in ways:
            p50[w].append(float(np.percentile(res[w][0], 50)))
            row[w] = {"p50_ms": p50[w][-1], "p99_ms": float(np.percentile(res[w][0], 99)),
                      "segment_sum_launches_grouped_and_per_feature": launches[w]}
        print(json.dumps(row), flush=True)
    won = sum(g < p for g, p in zip(p50["grouped"], p50["per_feature"]))
    print(json.dumps({"summary": {w: {"median_p50_ms": float(np.median(v)),
                                      "p50_iqr_ms": float(np.percentile(v, 75) - np.percentile(v, 25))}
                                  for w, v in p50.items()},
                      "pairs": a.pairs, "grouped_faster_pairs": won}), flush=True)


if __name__ == "__main__":
    main()
