"""Twin of ``examples/online_window.py``: online-learning windows with
stale-feature eviction (paper §2.1 Pipelines and the Embedding Engine's
eviction; §4.2 continuous training).

A day of hourly windows with drifting id distributions (new items appear,
old ones expire). For each window:
  1. evaluate on the incoming window before training it (one-pass protocol),
  2. train on it,
  3. evict embedding rows idle for more than ``evict_age`` steps, through
     ``EmbeddingEngine.evict_local``.

On a CUDA tensor the row reads and writes run the gather and scatter
kernels and the sum pooling the grouped segment-sum kernel (forward and
gradient). The step mirrors the reference's: the two pooled embeddings
concatenated, an MLP (2·DIM, 32, 1) in the compute type, the inline BCE.

``main()`` runs the example's settings (5 windows of 120 steps, batch 128,
``rows_per_shard`` 4,096, eviction age 150) on the card unless ``--device
cpu``; its keyword arguments cut them for tests.

Run:  PYTHONPATH=src python -m repro_torch.examples.online_window [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch import nn

from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import local_view, resolve_device
from repro_torch.models.layers import MIXED, MLP, Precision
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig
from repro_torch.pipelines import OnlineWindowPipeline, TrainConfig, Trainer

DIM = 16
BATCH = 128
ITEMS_PER_WINDOW = 400     # each window introduces new hot items
ROWS_PER_SHARD = 4096

SPECS = [
    FeatureSpec("user", transform="hash", emb_dim=DIM),
    FeatureSpec("item", transform="hash", emb_dim=DIM),
    FeatureSpec("label", transform="raw"),
]


class Dense(nn.Module):
    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        self.mlp = MLP((2 * DIM, 32, 1), torch.Generator().manual_seed(seed), device)


class Cell:
    """The example's (state, batch) → (state, metrics) train step and its
    eval step, with the Trainer's contract; the step moves a batch to the
    cell's device. ``prec`` defaults to the example's MIXED."""

    returns_state = True
    donate_state = False

    def __init__(self, device=None, prec: Precision | None = None):
        self.device = resolve_device(device)
        self.prec = prec
        self.fe = FeatureEngine(SPECS, self.device)
        self.engine = EmbeddingEngine(
            [s for s in SPECS if s.emb_dim],
            EngineConfig(n_devices=1, rows_per_shard=ROWS_PER_SHARD, map_capacity_per_shard=2 * ROWS_PER_SHARD,
                         u_budget=512, per_dest_cap=512, recv_budget=512),
            self.device)
        self.step_fn = self._step(train=True)
        self.eval_fn = self._step(train=False)

    def _step(self, train: bool):
        fe, engine = self.fe, self.engine
        acfg, scfg = adamw.AdamWConfig(lr=1e-3), SparseAdamConfig(lr=5e-2)

        def loss_of(dense, rows_r, plans, ids, label):
            acts = engine.activations(rows_r, plans, ids)
            x = torch.cat([acts["user"], acts["item"]], dim=1)
            logits = dense.mlp(x.to(torch.float32), self.prec or MIXED).reshape(BATCH)
            return torch.mean(torch.clamp(logits, min=0) - logits * label
                              + torch.log1p(torch.exp(-torch.abs(logits))))

        def fn(state, batch):
            batch = {k: Ragged(v.values.to(self.device), v.row_splits.to(self.device)) for k, v in batch.items()}
            step = state["step"] + 1
            label = batch["label"].values.reshape(BATCH)
            if not train:
                with torch.inference_mode():
                    ids, _ = fe.apply(batch)
                    _, rows_r, plans, _ = engine.fetch_local(state["sparse"], ids, step, train=False)
                    return {"loss": loss_of(state["dense"], rows_r, plans, ids, label)}
            with torch.no_grad():  # not inference_mode: the plans are saved for backward
                ids, _ = fe.apply(batch)
                sp, rows_r, plans, _ = engine.fetch_local(state["sparse"], ids, step)
            dense = state["dense"]
            params = dict(dense.named_parameters())
            rows_r = {k: v.requires_grad_() for k, v in rows_r.items()}
            loss = loss_of(dense, rows_r, plans, ids, label)
            grads = torch.autograd.grad(loss, [*params.values(), *rows_r.values()])
            opt = adamw.update(acfg, params, dict(zip(params, grads)), state["opt"], step)
            with torch.no_grad():
                sp = engine.update_local(sp, plans, dict(zip(rows_r, grads[len(params):])), scfg, step)
            return ({"step": step, "dense": dense, "opt": opt, "sparse": sp},
                    {"loss": loss.detach(), "live_rows": _live(sp)})

        return fn

    def init_state(self) -> dict:
        dense = Dense(seed=0, device=self.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=self.device), "dense": dense,
                "opt": adamw.init(dict(dense.named_parameters())),
                "sparse": local_view(self.engine.init_state())}


def _live(sparse_state) -> torch.Tensor:
    return sum(v["idmap"].occupied.sum(dtype=torch.int32) for v in sparse_state.values())


def make_window_batch(window: int, i: int) -> dict[str, Ragged]:
    """Window w draws items from [w·K, (w+1)·K): full distribution drift."""
    r = np.random.default_rng(1000 * window + i)
    items = r.integers(window * ITEMS_PER_WINDOW, (window + 1) * ITEMS_PER_WINDOW, BATCH)
    users = r.integers(0, 2000, BATCH)
    # ground truth: item parity (directly learnable from the item embedding)
    label = (items % 2).astype(np.float32)
    return {
        "user": Ragged.from_lists([[int(u)] for u in users], nnz_budget=BATCH),
        "item": Ragged.from_lists([[int(x)] for x in items], nnz_budget=BATCH),
        "label": Ragged.from_lists([[float(v)] for v in label], nnz_budget=BATCH, dtype=torch.float32),
    }


def main(argv=None, *, n_windows: int = 5, steps_per_window: int = 120, evict_age: int = 150,
         log_every: int = 20, cell: Cell | None = None, state: dict | None = None,
         quiet: bool = False) -> dict:
    """The example's run (from ``state``, by default the cell's fresh one).
    Returns each window's pre-train eval loss and logged train metrics, and
    each eviction's count and the live rows after it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args([] if argv is None else argv)
    cell = cell or Cell(args.device)
    engine = cell.engine
    evictions = []
    say = (lambda *a: None) if quiet else print

    def evict_fn(state, older_than):
        sp, met = engine.evict_local(state["sparse"], older_than)
        evictions.append({"evicted": int(sum(met.values())), "live": int(_live(sp))})
        say(f"    evicted {evictions[-1]['evicted']} stale rows (live now: {evictions[-1]['live']})")
        return {**state, "sparse": sp}

    trainer = Trainer(cell, TrainConfig(total_steps=0, watchdog=False, log_every=log_every,
                                        evict_age_steps=evict_age), evict_fn=evict_fn)
    pipe = OnlineWindowPipeline(
        trainer,
        make_window_iter=lambda w: (make_window_batch(w, i % 20) for i in range(steps_per_window)),
        eval_step=cell.eval_fn, steps_per_window=steps_per_window)
    state, results = pipe.run(cell.init_state() if state is None else state, n_windows=n_windows)
    say("\nwindow | pre-train eval loss | post-train loss")
    for r in results:
        post = r.train_metrics[-1]["loss"] if r.train_metrics else float("nan")
        say(f"  {r.window}    |       {r.pre_eval.get('loss', float('nan')):.4f}        |    {post:.4f}")
    say("\nPre-eval is ~0.69+ on every window (unseen drifted items) while post-train drops: the "
        "engine keeps absorbing new ids; eviction keeps the live-row count bounded.")
    return {"state": state, "windows": [
        {"window": r.window, "pre_eval_loss": r.pre_eval.get("loss"), "train_metrics": r.train_metrics}
        for r in results], "evictions": evictions, "rows_per_shard": ROWS_PER_SHARD}


if __name__ == "__main__":
    main(sys.argv[1:])
