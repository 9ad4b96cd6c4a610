#!/usr/bin/env python3
"""How far the online-window example's first window lies between the card and
the CPU, and how far a wrong compute type would put it: the twin
``repro_torch.examples.online_window`` trains its first window (the pre-train
eval and 120 steps) on the card and on the CPU, in FP32 and in the example's
MIXED, from four dense seeds. Per seed it prints the largest loss difference
of the sound pairs (same compute type) and of the controls (FP32 against
MIXED), and the card's MIXED run repeated. chip_smoke.py's online_window
limit for MIXED lies between the two.

    python3 scripts/window_precision_spread.py      # one NVIDIA card

Prints the card's name and power limit, then one JSON object per seed.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.examples import online_window as ow  # noqa: E402
from repro_torch.models.layers import FP32, MIXED  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def first_window(device: str, prec, seed: int) -> list[float]:
    cell = ow.Cell(device, prec=prec)
    state = cell.init_state()
    dense = ow.Dense(seed=seed, device=cell.device)
    state["dense"], state["opt"] = dense, adamw.init(dict(dense.named_parameters()))
    w = ow.main(n_windows=1, log_every=1, cell=cell, state=state, quiet=True)["windows"][0]
    return [w["pre_eval_loss"]] + [m["loss"] for m in w["train_metrics"]]


def max_diff(a: list[float], b: list[float]) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("window_precision_spread: this script needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for seed in range(4):
        r = {(d, p): first_window(d, prec, seed) for d in ("cuda", "cpu") for p, prec in (("fp32", FP32), ("mixed", MIXED))}
        rec = {"seed": seed,
               "fp32_card_vs_cpu": max_diff(r["cuda", "fp32"], r["cpu", "fp32"]),
               "mixed_card_vs_cpu": max_diff(r["cuda", "mixed"], r["cpu", "mixed"]),
               "control_card_fp32_vs_cpu_mixed": max_diff(r["cuda", "fp32"], r["cpu", "mixed"]),
               "control_card_mixed_vs_cpu_fp32": max_diff(r["cuda", "mixed"], r["cpu", "fp32"])}
        if seed == 0:
            rec["mixed_card_repeat"] = max_diff(r["cuda", "mixed"], first_window("cuda", MIXED, 0))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
