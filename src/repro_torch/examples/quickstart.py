"""Twin of ``examples/quickstart.py``: the RecIS unified sparse–dense step
in a few lines of the public API:

  FeatureSpecs → FeatureEngine (fused transforms)
               → EmbeddingEngine (conflict-free KV embedding; ``clicks`` is
                 the repo's one ``mean`` pooling)
               → dense MLP (bf16) → loss → SparseAdam + AdamW.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import local_view, resolve_device
from repro_torch.models.layers import MIXED, MLP, Precision
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig

# ---------------------------------------------------------------- features
SPECS = [
    FeatureSpec("user_id", transform="hash", emb_dim=16),
    FeatureSpec("item_id", transform="hash", emb_dim=16),
    FeatureSpec("price", transform="bucketize", emb_dim=16,
                boundaries=tuple(np.linspace(0, 100, 17))),
    FeatureSpec("clicks", transform="hash", emb_dim=16, pooling="mean"),  # multi-value
    FeatureSpec("label", transform="raw"),
]
ENGINE_CFG = EngineConfig(n_devices=1, rows_per_shard=4096, map_capacity_per_shard=8192,
                          u_budget=512, per_dest_cap=512, recv_budget=512)

# ------------------------------------------------------------------ model
BATCH = 128
MLP_DIMS = (4 * 16, 64, 32, 1)


def make_batch(seed: int, device) -> dict[str, Ragged]:
    """The reference's batch of ``seed``, drawn by the same numpy calls."""
    r = np.random.default_rng(seed)
    cols = {
        "user_id": Ragged.from_lists([[int(x)] for x in r.zipf(1.3, BATCH)], nnz_budget=BATCH),
        "item_id": Ragged.from_lists([[int(x)] for x in r.zipf(1.2, BATCH)], nnz_budget=BATCH),
        "price": Ragged.from_lists([[float(x)] for x in r.uniform(0, 100, BATCH)],
                                   nnz_budget=BATCH, dtype=torch.float32),
        "clicks": Ragged.from_lists(
            [list(r.integers(0, 1000, r.integers(0, 6))) for _ in range(BATCH)],
            nnz_budget=BATCH * 5),
        "label": Ragged.from_lists([[float(x)] for x in r.integers(0, 2, BATCH)],
                                   nnz_budget=BATCH, dtype=torch.float32),
    }
    return {k: Ragged(v.values.to(device), v.row_splits.to(device)) for k, v in cols.items()}


class Quickstart:
    """The features, engine, MLP and optimizer states of the quickstart,
    and its train step."""

    def __init__(self, device=None, prec: Precision = MIXED):
        self.device = resolve_device(device)
        self.prec = prec
        self.fe = FeatureEngine(SPECS, self.device)
        self.engine = EmbeddingEngine([s for s in SPECS if s.emb_dim], ENGINE_CFG, self.device)
        self.mlp = MLP(MLP_DIMS, torch.Generator().manual_seed(0), self.device)
        self.opt = adamw.init(dict(self.mlp.named_parameters()))
        self.sparse = local_view(self.engine.init_state())

    def train_step(self, batch: dict[str, Ragged], step: int) -> tuple[torch.Tensor, dict]:
        """One step at 1-based ``step``: the loss and the engine metrics."""
        step_t = torch.tensor(step, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            ids, _ = self.fe.apply(batch)                                  # fused transforms
            sp, rows_r, plans, metrics = self.engine.fetch_local(self.sparse, ids, step_t)  # KV fetch
        label = batch["label"].values.reshape(BATCH)
        params = dict(self.mlp.named_parameters())
        rows_r = {k: v.requires_grad_() for k, v in rows_r.items()}
        acts = self.engine.activations(rows_r, plans, ids)                 # pooled, differentiable
        x = torch.cat([acts["user_id"], acts["item_id"], acts["price"], acts["clicks"]], dim=1)
        logits = self.mlp(x, self.prec).reshape(BATCH)
        loss = torch.mean(torch.clamp(logits, min=0) - logits * label
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        grads = torch.autograd.grad(loss, [*params.values(), *rows_r.values()])
        adamw.update(adamw.AdamWConfig(lr=1e-3), params, dict(zip(params, grads)), self.opt, step_t)
        with torch.no_grad():                                               # row-wise Adam
            self.sparse = self.engine.update_local(sp, plans, dict(zip(rows_r, grads[len(params):])),
                                                   SparseAdamConfig(lr=1e-2), step_t)
        return loss.detach(), metrics


def main(argv=None) -> float:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    qs = Quickstart(None if args.device == "cuda" else args.device)
    for step in range(1, 101):
        loss, met = qs.train_step(make_batch(step % 10, qs.device), step)
        if step % 20 == 0:
            print(f"step {step:4d} loss={float(loss):.4f} "
                  f"inserted={int(met['dim16/idmap_inserted'])}")
    print("quickstart done — loss should be well below 0.693 (random).")
    assert float(loss) < 0.67
    return float(loss)


if __name__ == "__main__":
    main()
