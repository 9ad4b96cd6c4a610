"""Saver — sharded, parallel, async checkpointing (paper §2.1) with
elastic re-shard on restore (DESIGN.md §8).

Layout of one checkpoint:
  <dir>/step_<N>/
    manifest.json              — pytree structure, global shapes, shard map
    shard_<i>_of_<n>.safetensors — leaf slices (axis-0 partitioned)

Every leaf is stored as axis-0 slices across `n_shards` files, so a restore
onto a *different* device count just reads the overlapping byte ranges —
elastic scaling without a conversion step. Saves go to a temp dir and are
committed with an atomic rename; `async_save` runs the whole thing on a
background thread (checkpoint latency hidden behind training).

Port of ``repro/checkpoint/saver.py``. A tree is nested dicts, lists,
tuples and NamedTuples whose leaves are tensors, numpy arrays or Python
scalars; ``_flatten`` gives each leaf the key path the reference's
``jax.tree_util`` flatten gives it (dict keys sorted, sequence items by
index, NamedTuple fields as ``.name``), so both packages write the same
safetensors names. The manifest's ``treedef`` is this package's own string;
``restore`` never parses it (it goes by ``like``).

Crash consistency (DESIGN.md §13): every file inside the temp dir is
written via fsync'd temp+rename, the temp dir itself is fsync'd before
the commit rename, and an existing same-step dir is renamed ASIDE before
the commit — never `rmtree`'d first, which would leave a window with NO
valid checkpoint at that step. Readers (`latest_step`) only trust dirs
that contain a ``manifest.json``, so a dir torn mid-rename is invisible;
``_gc`` sweeps stale ``.tmp_step_*`` / ``.trash_step_*`` leftovers.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import safetensors_io as st


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in the reference's order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves_with_path(tree: Any, prefix: str = ""):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, c in kids:
        yield from _leaves_with_path(c, f"{prefix}/{k}" if prefix else k)


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host copy: the train loop updates the state's tensors in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf, the structure kept."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in tree}
    vals = [_tree_map(fn, c) for _, c in kids]
    return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(vals)


def _shape_dtype(leaf: Any) -> tuple[tuple[int, ...], np.dtype]:
    """A ``like`` leaf's shape and numpy dtype, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), torch.empty((), dtype=leaf.dtype).numpy().dtype
    leaf = np.asarray(leaf)  # tolerate python int/float leaves (cursors)
    return leaf.shape, leaf.dtype


def _treedef(tree: Any) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k}: {_treedef(c)}" for k, c in kids)
    return f"{type(tree).__name__}({inner})"


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves_with_path(tree)}


def save(tree: Any, directory: str | pathlib.Path, step: int, n_shards: int = 4,
         max_workers: int = 4, keep_last: int | None = 3,
         extra_tensors: dict[str, np.ndarray] | None = None) -> pathlib.Path:
    """Sharded parallel save with atomic commit. Returns the commit dir.

    ``extra_tensors`` is an optional flat {name: array} payload written as
    its own ``extra.safetensors`` inside the SAME atomic commit. Unlike the
    main tree it is restored from its self-describing shapes (no ``like``
    template), which is what dynamically-sized state — the tiered store's
    host arena + frequency counts — needs across checkpoints.
    """
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:010d}"
    tmp = directory / f".tmp_step_{step:010d}_{time.time_ns()}"
    tmp.mkdir(parents=True, exist_ok=True)

    flat = _flatten(tree)
    manifest = {
        "step": step, "n_shards": n_shards,
        "treedef": _treedef(tree),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
    }

    def write_shard(si: int):
        tensors = {}
        for k, v in flat.items():
            if v.ndim == 0:
                if si == 0:
                    tensors[k] = v[None]
                continue
            n = v.shape[0]
            lo = si * n // n_shards
            hi = (si + 1) * n // n_shards
            tensors[k] = v[lo:hi]
        st.save_file(tensors, tmp / f"shard_{si}_of_{n_shards}.safetensors",
                     metadata={"shard": str(si), "step": str(step)},
                     durable=True)

    with cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        list(ex.map(write_shard, range(n_shards)))
    if extra_tensors:
        st.save_file({k: np.asarray(v) for k, v in extra_tensors.items()},
                     tmp / "extra.safetensors", metadata={"step": str(step)},
                     durable=True)
    st.write_bytes_atomic(json.dumps(manifest).encode(),
                          tmp / "manifest.json", durable=True)
    _fsync_dir(tmp)
    # Never rmtree the live dir before the commit rename: a crash between
    # the two would leave NO valid checkpoint at this step. Move it aside,
    # commit, then sweep the corpse.
    trash = None
    if final.exists():
        trash = directory / f".trash_step_{step:010d}_{time.time_ns()}"
        final.rename(trash)
    tmp.rename(final)  # atomic commit
    _fsync_dir(directory)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    if keep_last is not None:
        _gc(directory, keep_last)
    return final


def _fsync_dir(path: pathlib.Path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _gc(directory: pathlib.Path, keep_last: int):
    steps = sorted(p for p in directory.glob("step_*")
                   if (p / "manifest.json").exists())
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    for junk in directory.glob(".tmp_step_*"):
        shutil.rmtree(junk, ignore_errors=True)
    for junk in directory.glob(".trash_step_*"):
        shutil.rmtree(junk, ignore_errors=True)


class AsyncSaver:
    """Background-thread saver; at most one save in flight (paper: hide
    checkpoint latency behind training).

    Reports into an ``obs.MetricsRegistry`` (default: the process-wide one)
    under the ``ckpt/`` namespace: save count, bytes written, background
    save duration, and how long the train loop actually *blocked* waiting
    for a previous save — the number that tells you whether checkpoint
    latency is really hidden behind training.
    """

    def __init__(self, directory, n_shards: int = 4, keep_last: int = 3,
                 registry=None):
        from repro_torch import obs  # local import: saver is imported early
        self.directory = directory
        self.n_shards = n_shards
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()   # guards the _thread hand-off
        reg = registry if registry is not None else obs.get_registry()
        self._c_saves = reg.counter("ckpt/saves")
        self._c_bytes = reg.counter("ckpt/bytes_written")
        self._h_save = reg.histogram("ckpt/save_s")
        self._h_block = reg.histogram("ckpt/wait_block_s")
        self._g_step = reg.gauge("ckpt/last_saved_step")

    def save(self, tree, step: int,
             extra_tensors: dict[str, np.ndarray] | None = None):
        self.wait()
        host_tree = _tree_map(_to_numpy, tree)  # snapshot before async write
        if extra_tensors:  # snapshot too: the host tier keeps mutating
            extra_tensors = {k: _to_numpy(v) for k, v in extra_tensors.items()}
        nbytes = sum(l.nbytes for _, l in _leaves_with_path(host_tree))
        if extra_tensors:
            nbytes += sum(v.nbytes for v in extra_tensors.values())

        def run():
            t0 = time.perf_counter()
            save(host_tree, self.directory, step, self.n_shards,
                 keep_last=self.keep_last, extra_tensors=extra_tensors)
            self._h_save.observe(time.perf_counter() - t0)
            self._c_saves.inc()
            self._c_bytes.inc(nbytes)
            self._g_step.set(step)

        t = threading.Thread(target=run, daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def wait(self):
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t0 = time.perf_counter()
            t.join()
            self._h_block.observe(time.perf_counter() - t0)


def latest_step(directory: str | pathlib.Path) -> int | None:
    # a dir without manifest.json is not a committed checkpoint (the
    # manifest is the last file written before the commit rename)
    steps = sorted(p for p in pathlib.Path(directory).glob("step_*")
                   if (p / "manifest.json").exists())
    return int(steps[-1].name.split("_")[1]) if steps else None


def restore_extra(directory: str | pathlib.Path,
                  step: int | None = None) -> dict[str, np.ndarray] | None:
    """Load a checkpoint's ``extra.safetensors`` payload (self-describing
    shapes, no template). Returns None when the checkpoint has none."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = directory / f"step_{step:010d}" / "extra.safetensors"
    return st.load_file(path) if path.exists() else None


def restore(directory: str | pathlib.Path, like: Any, step: int | None = None) -> Any:
    """Restore into the structure/shapes of ``like`` (elastic re-shard).

    ``like`` may have a different axis-0 device multiplicity than the
    checkpoint: leaves are reassembled from global byte ranges, then
    reshaped/validated against the target. Scalars restore from shard 0.
    The leaves come back as numpy arrays of the ``like`` leaves' dtypes.
    """
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no checkpoints in {directory}"
    d = directory / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    n_shards = manifest["n_shards"]
    shards = [st.load_file(d / f"shard_{si}_of_{n_shards}.safetensors")
              for si in range(n_shards)]

    out_leaves = {}
    for key, leaf in _leaves_with_path(like):
        info = manifest["leaves"].get(key)
        assert info is not None, f"checkpoint missing leaf {key}"
        shape, dtype = _shape_dtype(leaf)
        if not shape:
            val = shards[0][key][0]
        else:
            parts = [s[key] for s in shards if key in s and s[key].size]
            val = np.concatenate(parts, axis=0) if parts else shards[0][key]
            val = _reshard_axis0(val, shape, key)
        out_leaves[key] = np.asarray(val).astype(dtype).reshape(shape)
    return _unflatten(like, out_leaves)


def _unflatten(like: Any, leaves: dict[str, np.ndarray], prefix: str = "") -> Any:
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    vals = {k: _unflatten(c, leaves, f"{prefix}/{k}" if prefix else k) for k, c in kids}
    if isinstance(like, dict):
        return {k: vals[str(k)] for k in like}
    vals = list(vals.values())
    return type(like)(*vals) if _is_namedtuple(like) else type(like)(vals)


def leaf_names(directory: str | pathlib.Path, step: int) -> set[str]:
    """The leaf names of a committed checkpoint, from its manifest."""
    d = pathlib.Path(directory) / f"step_{step:010d}"
    return set(json.loads((d / "manifest.json").read_text())["leaves"])


def _reshard_axis0(val: np.ndarray, target: tuple, key: str) -> np.ndarray:
    """Adapt axis-0 between device multiplicities (elastic restore).

    Engine state is stacked [D, ...] per shard; moving D→D' requires the
    per-shard payload to be re-hashed in general — that is handled by the
    engine's re-import path. Here we support the common elastic cases:
    identical shape, and D→D' where the trailing dims match and axis0 is a
    clean split/merge (D' divides D or D divides D')."""
    if val.shape == target:
        return val
    assert val.shape[1:] == target[1:] or val.size == int(np.prod(target)), (
        f"{key}: cannot reshard {val.shape} -> {target}")
    return val.reshape(target)
