#!/usr/bin/env python3
"""The fused-bucketize kernel of this checkout against another checkout's
(an earlier commit unpacked with ``git archive``), on one card, on the same
inputs:

    python3 scripts/bucketize_ab.py --other CHECKOUT [--inputs DIR]

Each checkout's ``src/repro_torch/csrc/fused_transform.cu`` is built with
the same nvcc flags into a library of its own (under
``build/bucketize_ab/``) and called through its C entry
``repro_fused_bucketize``: a library that also exports
``repro_bucketize_path_launches`` takes this checkout's launch plan (the
grid, ``kernels/fused_transform/fused_transform.py``), an earlier one the
SM count. The inputs: the MSE step's (20 contiguous columns
of 17 boundaries, N 1,310,720; the saved ``fused_bucketize.mse_train.pt``
of ``chip_smoke.py --save-inputs DIR`` where given, else made from a seed)
and the operator benchmark's shape (``benchmarks/table1_operators.py:34-45``:
100 columns of widths 8-63, N 200,000) with contiguous and with random
column ids, as ``chip_smoke.py`` makes them. Both kernels are held
bit-equal to the plain version (``ref.py``) and this one to itself over two
launches; then each kernel's device time is taken with CUDA events around
single launches (``device_ms``) and from profiler events (``kernel_ms``:
the kernel alone, as chip_smoke.py's ``kernel_device_ms``), the 50 MB L2
flushed before each launch by a 256 MB write, and from profiler events
after a 256 MB read (``kernel_ms_clean_l2``), in turns (other, this, this,
other), and this kernel with every tile read through the read-only cache
(``this_cached``, its other path) between; then a copy of the same bytes
with no search (``copy_floor``: what this traffic costs the card). Prints
the card and one JSON object per input.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MSE_COLS, MSE_WIDTH, MSE_BUDGET = 20, 17, 65_536  # the MSE example's bucketize group at batch 65,536
OP_COLS, OP_VALS = 100, 2_000                     # the operator benchmark's bucketize


def build(checkout: Path, label: str) -> tuple[ctypes.CDLL, bool]:
    """The checkout's kernel in a library of its own, and whether its C
    entry takes a launch plan (this design) or the SM count (earlier)."""
    from repro_torch import kernels

    out = ROOT / "build" / "bucketize_ab" / label / "libab.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = checkout / "src" / "repro_torch" / "csrc" / "fused_transform.cu"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    planned = hasattr(lib, "repro_bucketize_path_launches")
    lib.repro_fused_bucketize.argtypes = [P] * 5 + [I64] * 3 + ([I64, INT] if planned else [INT]) + [P]
    lib.repro_fused_bucketize.restype = INT
    return lib, planned


# a copy of the bucketize's bytes with no search (out[i] = cids[i] + (vals[i] > 0)), 16 bytes a load
# and a store, eight 256-thread blocks an SM striding over N / 4 chunks: what this traffic costs the card
COPY_FLOOR = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(256) bucketize_copy_floor_kernel(const float* __restrict__ v,
    const int* __restrict__ c, int64_t* __restrict__ o, int64_t n4) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n4; i += int64_t(gridDim.x) * blockDim.x) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(v) + i);
    const int4 b = __ldg(reinterpret_cast<const int4*>(c) + i);
    longlong2* p = reinterpret_cast<longlong2*>(o) + 2 * i;
    p[0] = make_longlong2(b.x + (a.x > 0), b.y + (a.y > 0));
    p[1] = make_longlong2(b.z + (a.z > 0), b.w + (a.w > 0));
  }
}
extern "C" int copy_floor(const void* v, const void* c, void* o, int64_t n, int blocks, void* st) {
  bucketize_copy_floor_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(st)>>>(
      static_cast<const float*>(v), static_cast<const int*>(c), static_cast<int64_t*>(o), n / 4);
  return cudaGetLastError();
}
"""


def build_floor() -> ctypes.CDLL:
    from repro_torch import kernels

    d = ROOT / "build" / "bucketize_ab" / "floor"
    d.mkdir(parents=True, exist_ok=True)
    (d / "floor.cu").write_text(COPY_FLOOR)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(d / "libfloor.so"), str(d / "floor.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(d / "libfloor.so"))
    lib.copy_floor.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.copy_floor.restype = ctypes.c_int
    return lib


def make_inputs(dev, saved: Path | None) -> dict:
    """name → (values, column ids, boundaries, offsets) on the card."""
    cases = {}
    if saved is not None and (saved / "fused_bucketize.mse_train.pt").exists():
        cases["mse_train"] = [t.to(dev) for t in torch.load(saved / "fused_bucketize.mse_train.pt")]
    else:
        r = np.random.default_rng(SEED)
        bnds = np.concatenate([np.sort(r.normal(size=MSE_WIDTH)) for _ in range(MSE_COLS)]).astype(np.float32)
        cases["mse_train"] = [torch.from_numpy(x).to(dev) for x in (
            r.normal(size=MSE_COLS * MSE_BUDGET).astype(np.float32),
            np.repeat(np.arange(MSE_COLS, dtype=np.int32), MSE_BUDGET), bnds,
            (np.arange(MSE_COLS + 1) * MSE_WIDTH).astype(np.int32))]
    op_r = np.random.default_rng(SEED + 1)  # as chip_smoke.py's phase 5
    op_w = op_r.integers(8, 64, OP_COLS)
    op_b = np.concatenate([np.sort(op_r.normal(size=w)) for w in op_w]).astype(np.float32)
    vals = op_r.normal(size=OP_COLS * OP_VALS).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(op_w)]).astype(np.int32)
    contiguous = np.repeat(np.arange(OP_COLS, dtype=np.int32), OP_VALS)
    cases["operator_table1"] = [torch.from_numpy(x).to(dev) for x in (vals, contiguous, op_b, offs)]
    cases["operator_random_ids"] = [torch.from_numpy(x).to(dev) for x in (
        vals, np.random.default_rng(SEED + 2).permutation(contiguous), op_b, offs)]
    return cases


def call(lib, planned: bool, args: list, out: torch.Tensor, stage: bool = True) -> None:
    from repro_torch.kernels.fused_transform import fused_transform as ft

    vals, cids, bnds, offs = args
    n, b, c = vals.shape[0], bnds.shape[0], offs.shape[0] - 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptrs = (vals.data_ptr(), cids.data_ptr(), bnds.data_ptr(), offs.data_ptr(), out.data_ptr(), n, b, c)
    stream = torch.cuda.current_stream().cuda_stream
    if planned:
        err = lib.repro_fused_bucketize(*ptrs, ft.launch_plan(n, b, c, sms, stage).blocks, int(stage), stream)
    else:
        err = lib.repro_fused_bucketize(*ptrs, sms, stream)
    if err:
        raise RuntimeError(f"fused_bucketize: CUDA error {err}")


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


def profiled_ms(fn, iters: int = 20, dirty: bool = True, tries: int = 3,
                name: str = "fused_bucketize_kernel") -> float | None:
    """The kernel's own device time (profiler events of the kernels whose
    name holds ``name``), the L2 flushed before each launch by writing
    256 MB (``dirty``) or by reading them; the trace is taken again, up to
    ``tries`` times, where it holds no such event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_() if dirty else flush.amax()
                fn()
            torch.cuda.synchronize()
        d = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
        if d:
            return sum(d) / len(d) / 1e3
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True, help="a checkout whose kernel is compared")
    ap.add_argument("--inputs", type=Path, default=None, help="what chip_smoke.py --save-inputs wrote")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bucketize_ab: torch.cuda.is_available() is false; this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fused_transform import fused_transform as ft, ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    libs = {"other": build(a.other, "other"), "this": build(ROOT, "this")}
    floor_lib = build_floor()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in make_inputs(dev, a.inputs).items():
        vals, cids, bnds, offs = args
        n, b, c = vals.shape[0], bnds.shape[0], offs.shape[0] - 1
        plan = ft.launch_plan(n, b, c, sms)
        want = ref.fused_bucketize(*args)
        out = torch.empty_like(want)
        equal = {}
        for k, (lib, planned) in libs.items():
            out.fill_(-1)
            call(lib, planned, args, out)
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(out, want))
        first = out.clone()
        call(*libs["this"], args, out)
        torch.cuda.synchronize()
        equal["this_twice_bit_equal"] = bool(torch.equal(out, first))
        out.fill_(-1)
        call(*libs["this"], args, out, stage=False)
        torch.cuda.synchronize()
        equal["this_cached"] = bool(torch.equal(out, want))
        del want, first
        if not all(equal.values()):
            raise AssertionError(f"fused_bucketize disagrees at {name}: {equal}")
        sides = {"other": (libs["other"], True), "this": (libs["this"], True), "this_cached": (libs["this"], False)}
        times = {k: [] for k in sides}
        kernel, clean = {k: [] for k in sides}, {k: [] for k in sides}
        for k in ("other", "this", "this_cached", "this", "other"):
            (lib, planned), stage = sides[k]
            fn = lambda: call(lib, planned, args, out, stage)  # noqa: E731
            times[k].append(device_ms(fn))
            kernel[k].append(profiled_ms(fn))
            clean[k].append(profiled_ms(fn, dirty=False))
        if n % 4 == 0 and vals.dtype == torch.float32:  # the copy floor: whole 16-byte chunks only
            blocks = 8 * sms
            floor = lambda: floor_lib.copy_floor(vals.data_ptr(), cids.data_ptr(), out.data_ptr(), n, blocks,  # noqa: E731
                                                 torch.cuda.current_stream().cuda_stream)
            kernel["copy_floor"] = [profiled_ms(floor, name="bucketize_copy_floor_kernel")]
            clean["copy_floor"] = [profiled_ms(floor, dirty=False, name="bucketize_copy_floor_kernel")]
        n_bytes = n * (4 + 4 + 8) + (b + c + 1) * 4
        print(json.dumps({"input": name, "N": n, "columns": c, "boundaries": b,
                          "contiguous_columns": bool((cids[1:] >= cids[:-1]).all()),
                          "plan": plan._asdict(),
                          "bit_equal": equal, "device_ms": times, "kernel_ms": kernel, "kernel_ms_clean_l2": clean,
                          "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}), flush=True)
        del args, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
