"""Hand-written CUDA kernels for Hopper (sm_90a) and their build.

Every kernel package has three files, as in the JAX package:
  <name>.py  ctypes launcher of the CUDA kernel in ``repro_torch/csrc/``
  ops.py     public wrapper: checks, output allocation, launch count; a CPU
             tensor goes to the plain version instead
  ref.py     the plain PyTorch version (CPU path, tests, on-card comparison)

All ``csrc/*.cu`` sources build into one shared library with a plain C
interface, at first use, into ``<checkout>/build/repro_torch/<hash>/``
keyed by a hash of the sources. Each source compiles in its own ``nvcc``
process, all started together, then one link; ptxas's report of each
kernel's registers, spills and static shared memory is kept beside the
library (``ptxas.log``). Nothing here runs at import.

Every launcher takes its stream from ``current_stream`` and, where its C
entry sizes a grid by the card, the SM count from ``sm_count``: the launch
path reads no ``torch.cuda.Stream`` object and no device properties.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I64, _INT, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
# C entry points: name → argtypes. Each returns cudaGetLastError() as int.
_SIGNATURES = {
    "repro_gather_rows": [_P, _P, _INT, _P, _I64, _I64, _I64, _P],
    "repro_gather_rows_slab": [_P, _P, _INT, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "repro_segment_sum_sorted": [_P, _P, _INT, _P, _I64, _I64, _I64, _P],
    "repro_segment_expand_csr": [_P, _I64, _P, _INT, _P, _I64, _I64, _I64, _P],
    "repro_segment_sum_csr_group": [_P, _I64, _I64, _P, _INT, _P],
    "repro_segment_expand_csr_group": [_P, _I64, _I64, _I64, _I64, _P, _INT, _P],
    "repro_scatter_rows": [_P, _P, _INT, _P, _P, _I64, _I64, _I64, _INT, _P],
    "repro_flash_fwd": [_P, _P, _P, _P, _P, _INT, *[_I64] * 5, *[_I64] * 9, _F32, _INT, _P, _P],
    "repro_flash_bwd": [*[_P] * 12, _INT, *[_I64] * 5, *[_I64] * 15, _F32, _INT, _P, _P],
    "repro_fused_bucketize": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _INT, _P],
    "repro_sequence_tile": [_P, _P, _INT, _P, _I64, _I64, _I64, _I64, _INT, _P],
    "repro_sequence_untile": [_P, _P, _INT, _P, _I64, _I64, _I64, _I64, _INT, _P],
}

_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}  # device index -> SM count


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile and link the kernels unless a build of these sources exists."""
    out = BUILD_ROOT / _digest() / "libkernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = _wait(procs)
        lib = Path(tmp) / "libkernels.so"
        _wait([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        (out.parent / "ptxas.log").write_text("".join(logs))
        os.replace(lib, out)  # atomic: a concurrent process never sees a partial file
    return out


def _wait(procs: list[tuple[str, subprocess.Popen]]) -> list[str]:
    """Wait for every compiler process and return their logs; raise with the
    logs of those that failed."""
    logs, errors = [], []
    for what, p in procs:
        log, _ = p.communicate()
        logs.append(log)
        if p.returncode != 0:
            errors.append(f"{what}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' shared library (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            # a prototype's call converts its arguments faster than a
            # function with argtypes set, which the host-bound paths feel
            setattr(lib, name, ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)((name, lib)))
        for counter in ("repro_flash_tc_launches", "repro_bucketize_path_launches"):
            getattr(lib, counter).argtypes = [ctypes.c_int]
            getattr(lib, counter).restype = ctypes.c_int64
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def current_stream(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s card, the one
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives (so a launch
    follows ``torch.cuda.stream(s)``), without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def sm_count(x: torch.Tensor) -> int:
    """The SM count of ``x``'s card, read once per card."""
    dev = x.get_device()
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n
