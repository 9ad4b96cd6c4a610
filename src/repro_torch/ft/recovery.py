"""Chain replay: frames → rows → ``engine.import_rows`` (port of
``repro/ft/recovery.py``, DESIGN.md §13).

Recovery is a fold over the committed chain, base-first:

  * a frame's rows overwrite earlier versions of the same id (last
    writer wins);
  * a frame's ``<group>/dead`` tombstones delete the id as of that
    frame; a later frame may legitimately resurrect it (evicted, then
    re-inserted);
  * the dense training state is taken whole from the newest frame.

The merged row set is handed to ``engine.import_rows``, which re-hash-
shards it onto THIS engine's device count and tier capacities, so a
chain written at N shards recovers onto M (elastic re-sharding), and the
recovered export is bit-identical to the writer's export at the same
step regardless of N, M, or where the tier boundary fell.

The reference folds a per-id Python dict; here each frame is one merge of
sorted id vectors, with the same result.

The recovery invariant the chaos tests enforce: for ANY prefix of a
crash schedule, ``recover`` returns the state of the newest save whose
manifest chain fully committed, bit-identical rows included.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Callable

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import safetensors_io as st
from repro_torch.ft import manifest as manifest_lib
from repro_torch.ft.manifest import Manifest

_DENSE = "__dense__/"


@dataclasses.dataclass
class RecoveryResult:
    state: Any
    step: int
    cursor: dict | None
    chain: list[Manifest]
    tip_sha: str
    frames_read: int


def _read_manifest_tensors(directory: pathlib.Path, m: Manifest
                           ) -> dict[str, np.ndarray]:
    """Load one save's frames and stitch the per-shard row ranges back
    together (dense + dead live only in shard 0: single part)."""
    parts: dict[str, list[np.ndarray]] = {}
    for fr in m.frames:
        for k, v in st.load_file(directory / fr["file"]).items():
            parts.setdefault(k, []).append(v)
    return {k: (v[0] if len(v) == 1 else np.concatenate(v))
            for k, v in parts.items()}


def _last_of_each(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique ids, row of each id's last occurrence)."""
    u, first_from_end = np.unique(ids[::-1], return_index=True)
    return u, ids.size - 1 - first_from_end


def replay_rows(directory: pathlib.Path, chain: list[Manifest]
                ) -> tuple[dict, dict[str, np.ndarray], int]:
    """→ (merged export_rows dict, newest dense flat dict, frames read)."""
    directory = pathlib.Path(directory)
    # per group: live ids (sorted) with the frame and row that last wrote each
    live: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    frames: list[dict[str, np.ndarray]] = []
    n_files = 0
    for fi, m in enumerate(chain):
        flat = _read_manifest_tensors(directory, m)
        frames.append(flat)
        n_files += len(m.frames)
        groups = sorted({k.split("/", 1)[0] for k in flat
                         if not k.startswith(_DENSE)})
        for g in groups:
            ids, fidx, ridx = live.get(g, (np.zeros(0, np.int64),) * 3)
            dead = flat.get(f"{g}/dead")
            if dead is not None:
                keep = ~np.isin(ids, np.asarray(dead, np.int64))
                ids, fidx, ridx = ids[keep], fidx[keep], ridx[keep]
            new = flat.get(f"{g}/ids")
            if new is not None:
                u, r = _last_of_each(np.asarray(new, np.int64))
                keep = ~np.isin(ids, u)
                ids = np.concatenate([ids[keep], u])
                fidx = np.concatenate([fidx[keep], np.full(u.size, fi, np.int64)])
                ridx = np.concatenate([ridx[keep], r.astype(np.int64)])
                order = np.argsort(ids, kind="stable")
                ids, fidx, ridx = ids[order], fidx[order], ridx[order]
            live[g] = (ids, fidx, ridx)
    rows: dict[str, dict] = {}
    for g, (ids, fidx, ridx) in live.items():

        def gather(key: str, g=g, fidx=fidx, ridx=ridx, default=None) -> np.ndarray | None:
            src0 = next((f[f"{g}/{key}"] for f in frames
                         if f"{g}/{key}" in f), None)
            if src0 is None:
                return None
            out = np.zeros((len(ridx),) + src0.shape[1:], src0.dtype)
            for fi in np.unique(fidx):
                sel = fidx == fi
                src = frames[fi].get(f"{g}/{key}")
                if src is None and default is not None:
                    out[sel] = default  # a frame of an untiered engine
                else:
                    out[sel] = src[ridx[sel]]
            return out

        slot_keys = sorted({k.split("/")[-1] for f in frames for k in f
                            if k.startswith(f"{g}/slots/")})
        rows[g] = {
            "ids": ids,
            "emb": gather("emb"),
            "slots": {sk: gather(f"slots/{sk}") for sk in slot_keys},
            "last_use": gather("last_use"),
        }
        # a chain that crosses from an untiered to a tiered engine has counts
        # in its later frames only: the others' rows count 1, as the tiered
        # export and import take a missing count (the reference raises)
        counts = gather("counts", default=1)
        if counts is not None:
            rows[g]["counts"] = counts
    dense = {k[len(_DENSE):]: v for k, v in frames[-1].items()
             if k.startswith(_DENSE)}
    return rows, dense, n_files


def recover(directory, engine, like_state=None,
            sparse_key: str | None = "sparse",
            registry: obs.MetricsRegistry | None = None,
            state_tree: Callable[[Any], Any] | None = None,
            load_state_tree: Callable[[Any, Any], Any] | None = None) -> RecoveryResult:
    """Rebuild training state from the newest committed chain.

    ``like_state`` supplies the dense-tree structure (and any keys the
    frames lack); the sparse entry is rebuilt by ``engine.import_rows``
    for THIS engine's shard count and device. ``state_tree`` and
    ``load_state_tree`` (a cell's pair) map the non-sparse state to the
    frames' tree and load it back; without them the dense leaves come back
    as numpy arrays. Raises FileNotFoundError when the directory holds no
    committed chain."""
    from repro_torch.ft.delta import unflatten_like

    t0 = time.perf_counter()
    directory = pathlib.Path(directory)
    chain = manifest_lib.load_chain(directory)
    if chain is None:
        raise FileNotFoundError(f"no committed ft chain in {directory}")
    rows, dense, n_files = replay_rows(directory, chain)
    sparse = engine.import_rows(rows)
    if sparse_key is None:
        state = sparse
    else:
        assert like_state is not None, "sparse_key set needs a like_state"
        rest_like = {k: v for k, v in like_state.items() if k != sparse_key}
        tree = unflatten_like(state_tree(rest_like) if state_tree else rest_like, dense)
        state = dict(load_state_tree(rest_like, tree) if load_state_tree else tree)
        state[sparse_key] = sparse
    tip = chain[-1]
    tip_sha = manifest_lib.sha256((directory / tip.name).read_bytes())
    reg = registry if registry is not None else obs.get_registry()
    reg.histogram("ckpt/recovery_s").observe(time.perf_counter() - t0)
    return RecoveryResult(state=state, step=tip.step, cursor=tip.cursor,
                          chain=chain, tip_sha=tip_sha, frames_read=n_files)
