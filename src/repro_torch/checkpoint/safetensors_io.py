"""Minimal pure-python SafeTensors (paper §2.1 Saver uses the format for
checkpoints and online-serving delivery). Compatible with the official
spec: [8B LE u64 header_len][header JSON][raw tensor bytes].

Writes are always staged through a same-directory temp file and committed
with ``os.replace`` so a crash mid-write can never leave a half-written
file at the final path (DESIGN.md §13); ``durable=True`` additionally
fsyncs before the rename so the commit survives power loss, not just
process death.
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
from typing import Mapping

import numpy as np

_DT = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "U32": np.uint32, "U64": np.uint64, "BOOL": np.bool_,
}
_DT_REV = {np.dtype(v): k for k, v in _DT.items()}
_DT_REV[np.dtype(np.uint16)] = "BF16"  # bf16 carried as uint16 payload


def dumps(tensors: Mapping[str, np.ndarray],
          metadata: Mapping[str, str] | None = None) -> bytes:
    """Serialize to safetensors bytes (the delta layer hashes these before
    they hit disk — manifest chain validation, DESIGN.md §13)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs = []
    for name in sorted(tensors):
        t = np.ascontiguousarray(tensors[name])
        if t.dtype == np.dtype("bfloat16") if hasattr(np, "bfloat16") else False:
            t = t.view(np.uint16)
        dt = _DT_REV.get(t.dtype)
        if dt is None:  # bf16 via ml_dtypes
            if t.dtype.name == "bfloat16":
                t, dt = t.view(np.uint16), "BF16"
            else:
                raise TypeError(f"{name}: unsupported dtype {t.dtype}")
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [offset, offset + t.nbytes]}
        offset += t.nbytes
        blobs.append(t.tobytes())
    hjson = json.dumps(header, separators=(",", ":")).encode()
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    return b"".join([struct.pack("<Q", len(hjson)), hjson, *blobs])


def write_bytes_atomic(data: bytes, path: str | pathlib.Path,
                       durable: bool = False):
    """Stage-and-rename write: the final path only ever holds a complete
    file. ``durable`` adds an fsync before the commit rename."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def save_file(tensors: Mapping[str, np.ndarray], path: str | pathlib.Path,
              metadata: Mapping[str, str] | None = None,
              durable: bool = False):
    write_bytes_atomic(dumps(tensors, metadata), path, durable=durable)


def load_file(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            lo, hi = info["data_offsets"]
            f.seek(base + lo)
            raw = f.read(hi - lo)
            if info["dtype"] == "BF16":
                import ml_dtypes  # noqa — fall back to uint16 view if absent

                arr = np.frombuffer(raw, np.uint16)
                try:
                    arr = arr.view(ml_dtypes.bfloat16)
                except Exception:
                    pass
            else:
                arr = np.frombuffer(raw, _DT[info["dtype"]])
            out[name] = arr.reshape(info["shape"])
    return out


def load_metadata(path: str | pathlib.Path) -> dict:
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    return header.get("__metadata__", {})
