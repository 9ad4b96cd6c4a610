"""Twin of ``examples/train_mse.py``: the paper's MSE-like search-ranking
model (§3.2.1), its train step on the port.

  FeatureEngine (fused hash and bucketize, sequences truncated)
    → EmbeddingEngine (one merged dim-8 group: 40 hash, 20 bucketize, 4
      sequence columns and the query)
    → cross-attention of the query over each behaviour sequence + 5-layer
      DNN (bf16 compute)
    → SparseAdam (rows) + AdamW (dense)

On a CUDA tensor the bucketize group runs the fused_transform kernel, the
four sequence columns' ``none`` pooling the sequence-tile kernel (and its
gradient the untile kernel), the sum pooling the segment-sum kernels, the
row reads and writes the gather and scatter kernels.

The step mirrors the reference's line by line, its quirks included: the
softmax runs over all SEQ_LEN positions, padded ones too; ``q · k`` is
formed in the compute type, and the reference's division by a numpy
float64 promotes the scores to float64 before the softmax; ``interest``
is the Python sum of the four interests over N_SEQ; the BCE is the inline
formula, its ``log1p`` term in the compute type.

The reference's ``main()`` (Trainer, AsyncLoader, AsyncSaver, resume)
waits for the port of the training loop and of the observability layer;
here ``MSECell`` and ``batch_arrays`` (the batches ``io/datagen.py``'s
recipes give) drive the step.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.embedding_engine import EmbeddingEngine, EngineConfig
from repro_torch.core.feature_engine import FeatureEngine, FeatureSpec
from repro_torch.io.ragged import Ragged
from repro_torch.launch.common import local_view, resolve_device
from repro_torch.models.layers import MIXED, MLP, Precision, dense, dense_apply
from repro_torch.optim import adamw
from repro_torch.optim.sparse_adam import SparseAdamConfig

DIM = 8
N_HASH, N_BUCKET, N_SEQ = 40, 20, 4   # "MSE-like", scaled for CPU
SEQ_LEN = 8
BATCH = 128
SEQ_MEAN_LEN = 4.0  # the example's datagen.gen_for_specs(..., seq_mean_len=4.0)
D_FLAT = (N_HASH + N_BUCKET + 1) * DIM + DIM  # non-seq + query + interest
DNN_DIMS = (D_FLAT, 64, 64, 32, 32, 1)


def specs() -> list[FeatureSpec]:
    out = [FeatureSpec(f"h{i}", transform="hash", emb_dim=DIM) for i in range(N_HASH)]
    out += [FeatureSpec(f"b{i}", transform="bucketize", emb_dim=DIM,
                        boundaries=tuple(np.linspace(-2, 2, 17)))
            for i in range(N_BUCKET)]
    out += [FeatureSpec(f"s{i}", transform="hash", emb_dim=DIM, pooling="none",
                        max_len=SEQ_LEN) for i in range(N_SEQ)]
    out += [FeatureSpec("query", transform="hash", emb_dim=DIM),
            FeatureSpec("label", transform="raw")]
    return out


def batch_arrays(specs_: list[FeatureSpec], batch: int, seed: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """One batch as numpy {column: (values, row_splits)}, drawn as the
    reference's ``io/datagen.py`` recipes draw a table's rows and as its
    loader packs them (``columnio.AsyncLoader._assemble``): ids zipf(1.2) %
    2^30, floats normal, labels 0/1, sequence lengths geometric with mean
    SEQ_MEAN_LEN capped at ``max_len``; nnz budgets as
    ``datagen.batch_spec_for`` sets them (a sequence gets batch * max_len /
    2), rows past a budget cut from the tail, the padding -1 (ids) or 0."""
    r = np.random.default_rng(seed)
    vocab = 1 << 30
    out = {}
    for s in specs_:
        k = s.max_len or 1
        seq = s.pooling in ("none", "tile") or k > 1
        budget = (int(batch * k / 2.0) or batch) if seq else batch
        if s.name == "label":
            vals, lens = r.integers(0, 2, batch).astype(np.float32), np.ones(batch, np.int64)
        elif s.transform in ("raw", "bucketize"):
            vals, lens = r.normal(size=(batch * k,)).astype(np.float32), np.full(batch, k)
        elif seq:
            lens = np.minimum(r.geometric(1.0 / SEQ_MEAN_LEN, batch), k)
            vals = (r.zipf(1.2, size=int(lens.sum())) % vocab).astype(np.int64)
        else:
            vals, lens = (r.zipf(1.2, size=batch) % vocab).astype(np.int64), np.ones(batch, np.int64)
        if vals.shape[0] > budget:  # truncated from the tail, as the loader does
            cum = np.cumsum(lens)
            lens = np.where(cum <= budget, lens, np.maximum(budget - np.concatenate([[0], cum[:-1]]), 0))
            vals = vals[:budget]
        pad = np.zeros((budget,), dtype=vals.dtype)
        if np.issubdtype(vals.dtype, np.integer):
            pad -= 1
        pad[: vals.shape[0]] = vals
        splits = np.zeros((batch + 1,), np.int32)
        np.cumsum(lens, out=splits[1:])
        out[s.name] = (pad, splits)
    return out


def to_batch(arrays: Mapping[str, tuple[np.ndarray, np.ndarray]], device) -> dict[str, Ragged]:
    return {k: Ragged(torch.from_numpy(v).to(device), torch.from_numpy(sp).to(device))
            for k, (v, sp) in arrays.items()}


class MSEDense(nn.Module):
    """The dense params: the query and key projections and the DNN."""

    def __init__(self, seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.attn_q = dense(DIM, DIM, gen, device=device)  # query → attention space
        self.attn_k = dense(DIM, DIM, gen, device=device)
        self.dnn = MLP(DNN_DIMS, gen, device)              # 5-layer DNN


class MSECell:
    """The MSE model's (state, batch) → (state, metrics) train step.

    ``batch``, ``engine_cfg`` and ``prec`` default to the example's BATCH,
    EngineConfig and MIXED; they let a caller run a larger batch or FP32.
    """

    def __init__(self, device=None, *, batch: int = BATCH, engine_cfg: EngineConfig | None = None,
                 prec: Precision = MIXED):
        self.device = resolve_device(device)
        self.batch = batch
        self.prec = prec
        self.specs = specs()
        self.fe = FeatureEngine(self.specs, self.device)
        self.engine = EmbeddingEngine(
            [s for s in self.specs if s.emb_dim],
            engine_cfg or EngineConfig(n_devices=1, rows_per_shard=1 << 14, map_capacity_per_shard=1 << 15,
                                       u_budget=2048, per_dest_cap=2048, recv_budget=2048),
            self.device)
        self.step_fn = self._make_step()

    def _make_step(self):
        fe, engine, sspecs, prec, batch_rows = self.fe, self.engine, self.specs, self.prec, self.batch
        acfg, scfg = adamw.AdamWConfig(lr=1e-3), SparseAdamConfig(lr=1e-2)

        def step_fn(state, batch):
            step = state["step"] + 1
            with torch.no_grad():  # not inference_mode: the plans are saved for backward
                ids, _ = fe.apply(batch)
                sp, rows_r, plans, met = engine.fetch_local(state["sparse"], ids, step)
            label = batch["label"].values.reshape(batch_rows)
            model = state["dense"]
            params = dict(model.named_parameters())
            rows_r = {k: v.requires_grad_() for k, v in rows_r.items()}

            acts = engine.activations(rows_r, plans, ids)
            # cross-attention: the query embedding attends over each sequence
            q = dense_apply(model.attn_q, acts["query"], prec)             # (B, D)
            interests = []
            for i in range(N_SEQ):
                seq = acts[f"s{i}"]                                         # (B, L, D)
                k = dense_apply(model.attn_k, seq, prec)
                scores = torch.einsum("bd,bld->bl", q, k).to(torch.float32).to(torch.float64)
                a = torch.softmax(scores / np.sqrt(DIM), dim=-1)
                interests.append(torch.einsum("bl,bld->bd", a.to(seq.dtype), seq))
            interest = sum(interests) / N_SEQ
            flat = [acts[s.name] for s in sspecs if s.emb_dim and s.pooling == "sum"]
            x = torch.cat(flat + [interest], dim=1).to(torch.float32)
            logits = model.dnn(x, prec).reshape(batch_rows)
            bce = torch.mean(torch.clamp(logits, min=0) - logits * label
                             + torch.log1p(torch.exp(-torch.abs(logits))))

            grads = torch.autograd.grad(bce, [*params.values(), *rows_r.values()])
            del acts
            opt = adamw.update(acfg, params, dict(zip(params, grads)), state["opt"], step)
            with torch.no_grad():
                sp = engine.update_local(sp, plans, dict(zip(rows_r, grads[len(params):])), scfg, step)
            return ({"step": step, "dense": model, "opt": opt, "sparse": sp},
                    {"loss": bce.detach(), **{k: v for k, v in met.items() if "overflow" in k}})

        return step_fn

    def init_state(self) -> dict:
        model = MSEDense(seed=0, device=self.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=self.device), "dense": model,
                "opt": adamw.init(dict(model.named_parameters())),
                "sparse": local_view(self.engine.init_state())}
