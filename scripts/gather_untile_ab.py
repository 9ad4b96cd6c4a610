#!/usr/bin/env python3
"""The row-gather and sequence-untile kernels of this checkout against
another checkout's (an earlier commit unpacked with ``git archive``), on one
card, on the inputs a ``chip_smoke.py`` run saw on its paths:

    python3 chip_smoke.py --save-inputs DIR
    python3 scripts/gather_untile_ab.py --other CHECKOUT --inputs DIR

Each checkout's ``src/repro_torch/csrc/fused_gather.cu`` and
``sequence_tile.cu`` are built with the same nvcc flags into a library of its
own (under ``build/gather_untile_ab/``) and called through their C entries
``repro_gather_rows`` and ``repro_sequence_untile``, whose signatures both
share. Each saved input (``<kernel>.<path>.pt``) holds the path's ids (the
gather, with the table's shape) or splits (the untile, with g's shape and
N); the table's and g's values are random, made from a seed. Both kernels
are held bit-equal to the plain versions (``ref.py``) on the same inputs;
then each kernel's device time is taken with CUDA events around single
launches (``device_ms``) and from profiler events (``kernel_ms``: the
kernel alone, as chip_smoke.py's ``kernel_device_ms``), the 50 MB L2
flushed before each launch by a 256 MB write, and from profiler events
after a 256 MB read (``kernel_ms_clean_l2``: no written lines left to
write back), in turns (other, this, this, other). Prints the card and one
JSON object per input.
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
ENTRIES = ("fused_gather.gather_rows", "sequence_tile.sequence_untile")


def build(checkout: Path, label: str) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    out = ROOT / "build" / "gather_untile_ab" / label / "libab.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    csrc = checkout / "src" / "repro_torch" / "csrc"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(csrc / "fused_gather.cu"), str(csrc / "sequence_tile.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.repro_gather_rows.argtypes = [P, P, INT, P, I64, I64, I64, P]
    lib.repro_sequence_untile.argtypes = [P, P, INT, P, I64, I64, I64, I64, INT, P]
    lib.repro_gather_rows.restype = lib.repro_sequence_untile.restype = ctypes.c_int
    return lib


def inputs(path: Path, dev) -> tuple[str, tuple, dict]:
    """The kernel's entry, its arguments on the card and the input's shape."""
    saved = torch.load(path)
    g = torch.Generator(device=dev).manual_seed(SEED)
    if path.name.startswith("gather_rows."):
        table = torch.randn((saved["R"], saved["D"]), generator=g, device=dev)
        ids = saved["ids"].to(dev)
        return ENTRIES[0], (table, ids), {"R": saved["R"], "D": saved["D"], "K": ids.numel(), "ids": str(ids.dtype)}
    S, k, D = saved["S"], saved["k"], saved["D"]
    splits = saved["splits"].to(dev)
    return ENTRIES[1], (torch.randn((S, k, D), generator=g, device=dev), splits, saved["N"]), {
        "S": S, "k": k, "D": D, "N": saved["N"], "splits": str(splits.dtype)}


def call(lib, entry: str, args: tuple, out: torch.Tensor) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "fused_gather.gather_rows":
        table, ids = args
        err = lib.repro_gather_rows(table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(),
                                    table.shape[0], table.shape[1], ids.shape[0], stream)
    else:
        g, splits, n = args
        err = lib.repro_sequence_untile(g.data_ptr(), splits.data_ptr(), int(splits.dtype == torch.int64),
                                        out.data_ptr(), n, splits.shape[0] - 1, g.shape[1], g.shape[2],
                                        torch.cuda.get_device_properties(0).multi_processor_count, stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")


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


def profiled_ms(fn, name_part: str, iters: int = 20, dirty: bool = True) -> float | None:
    """The kernel's own device time (profiler events of the kernels whose
    name holds ``name_part``), the L2 flushed before each launch: by
    writing 256 MB, as chip_smoke.py does (``dirty``: the L2 is then full of
    written lines that the kernel's misses write back), or by reading them
    (the L2 is cold and clean)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_() if dirty else flush.amax()
            fn()
        torch.cuda.synchronize()
    d = [e.time_range.end - e.time_range.start for e in prof.events()
         if e.device_type == DeviceType.CUDA and name_part in e.name]
    return sum(d) / len(d) / 1e3 if d else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="a checkout whose kernels are compared")
    ap.add_argument("--inputs", type=Path, required=True, help="what chip_smoke.py --save-inputs wrote")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gather_untile_ab: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fused_gather import ref as fg_ref
    from repro_torch.kernels.sequence_tile import ref as st_ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    libs = {"other": build(a.other, "other"), "this": build(ROOT, "this")}
    for path in sorted(a.inputs.glob("*.pt")):
        entry, args, shape = inputs(path, dev)
        if entry == "fused_gather.gather_rows":
            table, ids = args
            want = fg_ref.gather_rows(table, ids)
            n_distinct = int(torch.unique(torch.where((ids >= 0) & (ids < table.shape[0]), ids, 0)).numel())
            n_bytes = (n_distinct + ids.numel()) * table.shape[1] * 4 + ids.numel() * ids.element_size()
        else:
            g, splits, n = args
            want = st_ref.sequence_untile(g, splits, n)
            lens = (splits[1:] - splits[:-1]).long()
            n_bytes = (int(lens.clamp(max=g.shape[1]).sum()) + n) * g.shape[2] * 4 + splits.numel() * splits.element_size()
        s = {"entry": entry, "path": path.stem.split(".", 1)[1], **shape}
        out = torch.empty_like(want)
        equal = {}
        for k, lib in libs.items():
            out.fill_(float("nan"))
            call(lib, entry, args, out)
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(out, want))
        del want
        if not all(equal.values()):
            raise AssertionError(f"{entry} disagrees with its plain version at {s}: {equal}")
        times, kernel, clean = {k: [] for k in libs}, {k: [] for k in libs}, {k: [] for k in libs}
        name = "gather_rows_kernel" if entry == ENTRIES[0] else "sequence_untile_kernel"
        for k in ("other", "this", "this", "other"):
            times[k].append(device_ms(lambda: call(libs[k], entry, args, out)))
            kernel[k].append(profiled_ms(lambda: call(libs[k], entry, args, out), name))
            clean[k].append(profiled_ms(lambda: call(libs[k], entry, args, out), name, dirty=False))
        print(json.dumps({**s, "bit_equal": equal, "device_ms": times, "kernel_ms": kernel,
                          "kernel_ms_clean_l2": clean, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}), flush=True)
        del args, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
