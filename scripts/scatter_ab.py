#!/usr/bin/env python3
"""The row-scatter kernel of this checkout against another checkout's (an
earlier commit unpacked with ``git archive``), on one card, at the shapes a
``chip_smoke.py`` run recorded on its paths:

    python3 scripts/scatter_ab.py --other DIR --shapes SMOKE_OUTPUT.jsonl

Each checkout's ``src/repro_torch/csrc/fused_scatter.cu`` is built with the
same nvcc flags into a library of its own (under ``build/scatter_ab/``) and
called through its C entry ``repro_scatter_rows``, whose signature both
share. For every path shape of the add and the set in the smoke run's
``{"kernels": [...]}`` line (table rows R, width D, K slots, the live ones
and where they lie): the live slots are laid out as that run saw them (a
contiguous run, as the exchange leaves them: sorted unique ids, then the
padding) at distinct random table rows; both kernels are held bit-equal to
``index_add_`` / ``index_copy_`` on the same inputs; then each kernel's device
time is taken with CUDA events around single launches, the 50 MB L2 flushed
before each, in turns (other, this, this, other). Prints the card and one
JSON object per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ENTRIES = {"fused_scatter.scatter_add_rows": True, "fused_scatter.scatter_set_rows": False}


def build(checkout: Path, label: str) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    out = ROOT / "build" / "scatter_ab" / label / "libscatter.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = checkout / "src" / "repro_torch" / "csrc" / "fused_scatter.cu"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.repro_scatter_rows.argtypes = [P, P, INT, P, P, I64, I64, I64, INT, P]
    lib.repro_scatter_rows.restype = ctypes.c_int
    return lib


def shapes(path: Path) -> list[dict]:
    """(entry, path, shape) of every scatter measurement in a smoke run."""
    line = next(json.loads(x) for x in path.read_text().splitlines() if x.startswith('{"kernels"'))
    out = []
    for e in line["kernels"]:
        if e["name"] in ENTRIES:
            out += [{"entry": e["name"], "path": p, **a["shape"]} for p, a in e["at"].items()]
    return out


def inputs(s: dict, dev) -> tuple:
    g = torch.Generator(device=dev).manual_seed(SEED)
    R, D, K, n = s["R"], s["D"], s["K"], s["live_slots"]
    first = s.get("first_live", 0)
    valid = torch.zeros(K, dtype=torch.bool, device=dev)
    if s.get("last_live", first + n - 1) - first + 1 == n:
        valid[first:first + n] = True
    else:  # spread over the span the run saw
        span = torch.randperm(s["last_live"] - first + 1, generator=g, device=dev)[:n] + first
        valid[span] = True
    ids = torch.full((K,), -1, dtype=torch.int64, device=dev)
    ids[valid] = torch.randperm(R, generator=g, device=dev)[:n]
    table = torch.randn((R, D), generator=g, device=dev)
    rows = torch.randn((K, D), generator=g, device=dev)
    return table, ids.to(torch.int32 if s.get("ids") == "torch.int32" else torch.int64), rows, valid


def call(lib, table, ids, rows, valid, add: bool) -> None:
    err = lib.repro_scatter_rows(table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
                                 valid.data_ptr(), rows.data_ptr(), table.shape[0], table.shape[1],
                                 ids.shape[0], int(add), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_scatter_rows: CUDA error {err}")


def device_ms(fn, iters: int = 20) -> float:
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="a checkout whose scatter kernel is compared")
    ap.add_argument("--shapes", type=Path, required=True, help="the JSON lines a chip_smoke.py run printed")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("scatter_ab: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    libs = {"other": build(a.other, "other"), "this": build(ROOT, "this")}
    for s in shapes(a.shapes):
        add = ENTRIES[s["entry"]]
        table, ids, rows, valid = inputs(s, dev)
        live = valid & (ids >= 0)
        want = table.clone()
        if add:
            want.index_add_(0, ids[live].long(), rows[live])
        else:
            want.index_copy_(0, ids[live].long(), rows[live])
        equal = {}
        for k, lib in libs.items():
            got = table.clone()
            call(lib, got, ids, rows, valid, add)
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(got, want))
            del got
        del want
        if not all(equal.values()):
            raise AssertionError(f"scatter disagrees with index_add_/index_copy_ at {s}: {equal}")
        times = {k: [] for k in libs}
        for k in ("other", "this", "this", "other"):
            times[k].append(device_ms(lambda: call(libs[k], table, ids, rows, valid, add)))
        n = int(live.sum())
        n_bytes = n * s["D"] * 4 * (3 if add else 2) + ids.numel() * (ids.element_size() + 1)
        print(json.dumps({**s, "bit_equal": equal, "device_ms": times,
                          "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}), flush=True)
        del table, ids, rows, valid, live
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
