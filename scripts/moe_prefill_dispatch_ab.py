#!/usr/bin/env python3
"""The MoE prefill's grouped expert dispatch without a gradient
(``moe._grouped_swiglu``: the whole (N·k, f) gate and up activations, silu
written over the gate's, the up's freed before the down products) against
the per-expert loop it replaced (each expert's gate and up activations made
and dropped in turn), on one card, in one process:

    python3 scripts/moe_prefill_dispatch_ab.py [--requests 4]

For qwen2-moe-a2.7b and moonshot-v1-16b-a3b at ``chip_smoke.py``'s MoE
serving sizes (published widths, its MOE_LAYERS layers, ``prefill_32k`` at
batch 1, every token's row imported into the engine, weights drawn on the
card): ``--requests`` prefill requests with each dispatch in turns (new,
loop, new, loop). For each turn the bytes allocated before it, the peak
allocated bytes over its requests (``torch.cuda.max_memory_allocated``),
each request's time by CUDA events and whether its last logits equal the
first turn's bit for bit. Prints the card and one JSON object per turn.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


def per_expert_loop(moe_lib):
    """The dispatch's expert step as a loop over the experts."""

    def experts_grouped(m, xc, top_e, counts, prec):
        n, k = top_e.shape
        order = torch.argsort(top_e.reshape(-1), stable=True)
        xs = xc.index_select(0, order // k)
        gate, up, down = prec.cast(m.gate), prec.cast(m.up), prec.cast(m.down)
        ys = torch.empty((n * k, xc.shape[1]), dtype=xs.dtype, device=xs.device)
        lo = 0
        for e, c in enumerate(moe_lib._group_sizes(counts)):
            if c:
                xe = xs[lo:lo + c]
                h = F.silu(xe @ gate[e]).mul_(xe @ up[e])
                torch.mm(h, down[e], out=ys[lo:lo + c])
            lo += c
        return torch.empty_like(ys).index_copy_(0, order, ys).view(n, k, -1)

    return experts_grouped


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("moe_prefill_dispatch_ab: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.cells import build_arch_cell
    from repro_torch.models import moe as moe_lib

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    kernels.build()
    kernels.load_library()
    variants = {"grouped_swiglu": moe_lib._experts_grouped, "per_expert_loop": per_expert_loop(moe_lib)}
    try:
        for arch_id in ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"):
            arch, model, _ = cs._moe_model(arch_id, dev)
            cfg = arch.model
            V, d, gkey = cfg.vocab_size, cfg.d_model, f"dim{cfg.d_model}"
            eng = build_arch_cell(arch, ShapeCell("decode_32k", "decode", {"seq_len": 32_768, "global_batch": 1}),
                                  device=dev)
            sparse = eng.engine.import_rows(cs._dec_token_rows(eng.engine, gkey, V, d, dev))
            pre = build_arch_cell(arch, ShapeCell("prefill_32k", "prefill",
                                                  {"seq_len": cs.PREFILL_T, "global_batch": 1}), device=dev)
            st = {"step": torch.zeros((), dtype=torch.int32, device=dev), "dense": model, "sparse": sparse}
            batches = [pre.make_batch(cs.MOE_SEED + s) for s in range(args.requests)]
            first = None
            for name in ("grouped_swiglu", "per_expert_loop") * 2:
                moe_lib._experts_grouped = variants[name]
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms = []
                for b in batches:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = pre.step_fn(st, b)
                    end.record()
                    end.synchronize()
                    ms.append(start.elapsed_time(end))
                    logits = out["logits"]
                    del out
                first = logits if first is None else first
                peak = torch.cuda.max_memory_allocated()
                print(json.dumps({"arch": arch_id, "n_layers": cfg.n_layers, "dispatch": name, "held_bytes": held,
                                  "peak_bytes": peak, "peak_over_held_bytes": peak - held, "request_ms": ms,
                                  "p50_ms_after_first": float(np.median(ms[1:])),
                                  "last_logits_equal_first_turn": bool(torch.equal(logits, first))}), flush=True)
            moe_lib._experts_grouped = variants["grouped_swiglu"]
            del model, sparse, eng, pre, st, first, logits
            torch.cuda.empty_cache()
    finally:
        moe_lib._experts_grouped = variants["grouped_swiglu"]


if __name__ == "__main__":
    main()
