"""Serving example (twin of ``examples/serve_retrieval.py``): one user
scored against a large candidate set, the ``retrieval_cand`` cell of the
recsys archs, serving the engine state that training wrote.

Flow: train the wide-deep smoke cell for 20 steps → checkpoint it with the
saver → build a retrieval cell, restore its dense params from the
checkpoint and import the trained rows into both of its engines (serve
fetches: ids never trained read as zero rows) → score 12 requests and
report latency percentiles. On the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_retrieval [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import saver
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.cells import build_cell
from repro_torch.launch.common import resolve_device

TRAIN_STEPS, N_REQUESTS, N_WARMUP, N_CANDIDATES = 20, 12, 2, 4096


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the flow; returns the last request's scores (numpy), the timed
    requests' latencies in ms, the last train step's loss and the rows the
    train steps could not place (``idmap_*overflow``, summed: 0)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; no CPU fallback)")
    ap.add_argument("--workdir", default=None, help="checkpoint directory (default: a new temporary one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="recis_serve_")

    # --- 1) train briefly, checkpoint the state
    tshape = ShapeCell("train_batch", "train", {"batch": 64})
    tcell = build_cell("wide-deep", "train_batch", smoke=True, shape_override=tshape, device=device)
    state = tcell.init_state()
    overflow = 0
    for s in range(TRAIN_STEPS):
        state, out = tcell.step_fn(state, tcell.make_batch(s))
        overflow += sum(int(v) for k, v in out.items() if "overflow" in k)
    train_loss = float(out["loss"])
    print(f"trained {TRAIN_STEPS} steps, loss={train_loss:.4f}")
    if overflow:
        raise AssertionError(f"{overflow} ids found no row in training")
    saver.save(tcell.state_tree(state), workdir, step=TRAIN_STEPS)

    # --- 2) the retrieval cell: dense params from the checkpoint, the
    # trained rows through the portable export / import form
    rshape = ShapeCell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": N_CANDIDATES})
    rcell = build_cell("wide-deep", "retrieval_cand", smoke=True, shape_override=rshape, device=device)
    rstate = rcell.init_state()
    model = rstate["dense"]
    like = {"step": np.int64(0), "dense": convert.params_to_tree(model, model.state_dict())}
    ckpt = saver.restore(workdir, like, step=TRAIN_STEPS)
    model.load_state_dict(convert.params_from_tree(model, ckpt["dense"]))
    rows = tcell.engine.export_rows(state["sparse"])
    rstate["sparse_user"] = rcell.engine_user.import_rows(rows)
    rstate["sparse_cand"] = rcell.engine_cand.import_rows(rows)

    lat = []
    for s in range(N_REQUESTS):
        batch = rcell.make_batch(100 + s)
        _sync(device)
        t0 = time.perf_counter()
        out = rcell.step_fn(rstate, batch)
        _sync(device)
        lat.append(time.perf_counter() - t0)
    scores = out["scores"].cpu().numpy().reshape(-1)

    lat_ms = np.array(lat[N_WARMUP:]) * 1e3
    print(f"scored {scores.shape[0]} candidates/request")
    print(f"latency p50={np.percentile(lat_ms, 50):.2f}ms "
          f"p99={np.percentile(lat_ms, 99):.2f}ms over {len(lat_ms)} requests")
    print("top-5 candidates:", np.argsort(scores)[-5:][::-1].tolist())
    if not np.isfinite(scores).all():
        raise AssertionError("scores are not finite")
    # trained candidate rows must set the scores apart
    if np.unique(scores).size <= 100:
        raise AssertionError(f"scores are degenerate: {np.unique(scores).size} distinct values")
    return {"scores": scores, "latency_ms": lat_ms.tolist(), "train_loss": train_loss, "train_overflow": overflow}


if __name__ == "__main__":
    main()
