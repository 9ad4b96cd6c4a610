#!/usr/bin/env python3
"""What the hi + lo split of P and dS costs the bf16 flash-attention kernels
on the card, and what it buys. The kernels are built as shipped, then again
with -DREPRO_FLASH_TC_SPLIT=0 (P and dS rounded once to bf16, one wgmma per
product). Each build is held to the plain version on the bf16 cases of
chip_smoke.py's FLASH_CASES (the largest error over FLASH_TOL of O, dQ, dK
and dV) and timed by profiler events at the qwen2.5-3b shapes: the prefill
forward (T 32,768) and the train_4k forward and backward (T 4,096), B 1,
H 16, Hk 2, hd 128, causal.

    python3 scripts/flash_split_cost.py      # one NVIDIA card

Prints the card's name and power limit, then one JSON object per build.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402


def measure(build: str) -> dict:
    dev = torch.device("cuda")
    worst = {"o": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, T, H, Hk, hd, dt, causal in cs.FLASH_CASES:
        if dt != torch.bfloat16:
            continue
        g = torch.Generator().manual_seed(B * T + H * Hk + hd)
        q, k, v, do = (torch.randn((B, T, n, hd), generator=g).to(dt).to(dev) for n in (H, Hk, Hk, H))
        o, lse = ops.flash_fwd(q, k, v, causal)
        got = ops.flash_bwd(q, k, v, o, lse, do, causal)
        want_o = ref.flash_fwd(q, k, v, causal)[0]
        want = ref.flash_bwd(q, k, v, o, lse, do, causal)
        for n, a, b in zip(worst, (o, *got), (want_o, *want)):
            worst[n] = max(worst[n], cs.flash_excess(a, b, dt))
    times = {}
    for name, T in (("prefill", cs.PREFILL_T), ("lm_train", cs.LM_TRAIN_T)):
        g = torch.Generator().manual_seed(T)
        q, k, v, do = (torch.randn((1, T, n, 128), generator=g).to(torch.bfloat16).to(dev) for n in (16, 2, 2, 16))
        iters = 3 if T > 8192 else 20
        times[f"{name}_fwd_device_ms"] = cs.kernel_device_ms(lambda: ops.flash_fwd(q, k, v), "flash_fwd", iters)
        if name == "lm_train":
            o, lse = ops.flash_fwd(q, k, v)
            run = lambda: ops.flash_bwd(q, k, v, o, lse, do)  # noqa: E731
            times["lm_train_bwd_device_ms"] = cs.kernel_device_ms(run, "flash_bwd", iters)
            for part in ("dq", "dkv", "group_sum"):
                times[f"lm_train_bwd_{part}_device_ms"] = cs.kernel_device_ms(run, f"flash_bwd_{part}", iters)
        del q, k, v, do
        torch.cuda.empty_cache()
    return {"build": build, "nvcc_flags": kernels.NVCC_FLAGS, "max_err_over_flash_tol": worst, **times}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_split_cost: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    kernels.load_library()
    print(json.dumps(measure("split (as shipped)")), flush=True)
    kernels.NVCC_FLAGS = [*kernels.NVCC_FLAGS, "-DREPRO_FLASH_TC_SPLIT=0"]  # another build directory
    kernels._lib = None
    kernels.load_library()
    print(json.dumps(measure("no split")), flush=True)


if __name__ == "__main__":
    main()
