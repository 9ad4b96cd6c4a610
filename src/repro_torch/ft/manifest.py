"""Crash-consistent manifest chain for incremental checkpoints
(DESIGN.md §13); a copy of ``repro/ft/manifest.py`` on the port's
``checkpoint.safetensors_io``, whose chain validation hashes the frames on
a few threads. A chain either package commits loads in the other.

Layout of a delta-checkpoint directory::

    ft_frame_00000003_0of2.safetensors     row payload (base or delta)
    ft_manifest_00000003.json              one manifest per save
    HEAD                                   "<manifest name> <sha256>"

Every artifact is committed write-temp → (fsync) → atomic rename, in
dependency order: frames first, then the manifest that names them, then
``HEAD``. A crash between any two steps leaves either the previous fully
valid chain or the new one — never a mix — because a manifest is only
trusted when (a) its own bytes hash to what its child (or HEAD) recorded
and (b) every frame it names exists with the recorded size and sha256.

``load_chain`` resolves the newest fully-valid chain: it tries the HEAD
pointer first, then falls back to scanning manifests newest-first, so a
torn frame, an unreferenced manifest, or a missing HEAD all degrade to
the previous committed checkpoint instead of an error.

GC keeps the last ``keep_chains`` committed chains (a chain = a base
manifest plus the deltas stacked on it). The reachable set is computed by
walking parent links from the trusted head, so a file is only ever
deleted when NO loadable chain references it — the "provably never
deletes a live dependency" property the tests exercise under injected
crashes.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Mapping

from repro_torch.checkpoint import safetensors_io as st

MANIFEST_VERSION = 1
MANIFEST_PREFIX = "ft_manifest_"
FRAME_PREFIX = "ft_frame_"
HEAD_NAME = "HEAD"


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class FileIO:
    """The durable persistence primitives. Every mutation of the
    checkpoint directory goes through this object, which is exactly what
    makes the chaos harness possible: ``chaos.ChaosIO`` subclasses it and
    injects crashes/torn writes at counted call sites.
    """

    durable: bool = True

    def write_frame(self, path: pathlib.Path,
                    tensors: Mapping, metadata: Mapping[str, str] | None = None
                    ) -> tuple[int, str]:
        """Serialize + commit one safetensors frame; returns (nbytes, sha)."""
        data = st.dumps(tensors, metadata)
        st.write_bytes_atomic(data, path, durable=self.durable)
        return len(data), sha256(data)

    def write_manifest(self, path: pathlib.Path, data: bytes):
        st.write_bytes_atomic(data, path, durable=self.durable)

    def write_head(self, path: pathlib.Path, text: str):
        st.write_bytes_atomic(text.encode(), path, durable=self.durable)

    def fsync_dir(self, path: pathlib.Path):
        if not self.durable:
            return
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def unlink(self, path: pathlib.Path):
        path.unlink(missing_ok=True)


@dataclasses.dataclass
class Manifest:
    seq: int                    # monotone save counter (also the filename)
    step: int                   # trainer step this save captured
    kind: str                   # "base" | "delta"
    frames: list[dict]          # [{"file", "nbytes", "sha256"}, ...]
    parent: str | None          # previous manifest's filename
    parent_sha256: str | None   # hash of the previous manifest's bytes
    chain_depth: int            # deltas since (and incl.) this chain's base
    cursor: dict | None = None  # data-pipeline cursor for resume
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return f"{MANIFEST_PREFIX}{self.seq:08d}.json"

    def to_bytes(self) -> bytes:
        obj = {"v": MANIFEST_VERSION, "seq": self.seq, "step": self.step,
               "kind": self.kind, "frames": self.frames,
               "parent": self.parent, "parent_sha256": self.parent_sha256,
               "chain_depth": self.chain_depth, "cursor": self.cursor,
               "extra": self.extra}
        return (json.dumps(obj, indent=1, sort_keys=True) + "\n").encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Manifest":
        obj = json.loads(data)
        if obj.get("v") != MANIFEST_VERSION:
            raise ValueError(f"manifest version {obj.get('v')} unsupported")
        return cls(seq=obj["seq"], step=obj["step"], kind=obj["kind"],
                   frames=obj["frames"], parent=obj["parent"],
                   parent_sha256=obj["parent_sha256"],
                   chain_depth=obj["chain_depth"], cursor=obj["cursor"],
                   extra=obj.get("extra", {}))


def commit(directory: pathlib.Path, manifest: Manifest, io: FileIO) -> str:
    """Publish a manifest whose frames are already on disk. Ordering is
    the crash-consistency argument: the manifest lands (durably) before
    HEAD points at it, so HEAD never names missing bytes."""
    data = manifest.to_bytes()
    digest = sha256(data)
    io.fsync_dir(directory)                       # frames durable first
    io.write_manifest(directory / manifest.name, data)
    io.fsync_dir(directory)
    io.write_head(directory / HEAD_NAME, f"{manifest.name} {digest}\n")
    io.fsync_dir(directory)
    return digest


def _read_manifest(directory: pathlib.Path, name: str,
                   want_sha: str | None = None) -> Manifest | None:
    path = directory / name
    try:
        data = path.read_bytes()
    except OSError:
        return None
    if want_sha is not None and sha256(data) != want_sha:
        return None
    try:
        return Manifest.from_bytes(data)
    except (ValueError, KeyError, json.JSONDecodeError):
        return None


def _frame_valid(path: pathlib.Path, fr: Mapping) -> bool:
    try:
        data = path.read_bytes()
    except OSError:
        return False
    return len(data) == fr["nbytes"] and sha256(data) == fr["sha256"]


def _frames_valid(directory: pathlib.Path, chain: list[Manifest]) -> bool:
    """Every frame of ``chain`` at its recorded size and hash. The frames
    are read and hashed on a few threads at once (``hashlib`` releases the
    GIL): a chain holds gigabytes, and the GC after every save validates it
    whole."""
    frames = [(directory / fr["file"], fr) for m in chain for fr in m.frames]
    if len(frames) <= 1:
        return all(_frame_valid(p, fr) for p, fr in frames)
    with concurrent.futures.ThreadPoolExecutor(min(len(frames), os.cpu_count() or 1, 8)) as ex:
        return all(ex.map(lambda x: _frame_valid(*x), frames))


def _build_chain(directory: pathlib.Path, tip: Manifest
                 ) -> list[Manifest] | None:
    """Walk parent links from ``tip`` back to its base, validating every
    manifest hash and every frame. Returns base-first, or None."""
    chain = [tip]
    cur = tip
    while cur.kind != "base":
        if cur.parent is None:
            return None
        parent = _read_manifest(directory, cur.parent, cur.parent_sha256)
        if parent is None:
            return None
        chain.append(parent)
        cur = parent
    if not _frames_valid(directory, chain):
        return None
    return chain[::-1]


def load_chain(directory: pathlib.Path) -> list[Manifest] | None:
    """Newest fully-valid chain (base-first), or None if no checkpoint
    has ever committed. HEAD is a hint, not an authority: if it is torn,
    stale, or points at an invalid chain, the manifest scan takes over."""
    directory = pathlib.Path(directory)
    tried: set[str] = set()
    head = directory / HEAD_NAME
    if head.exists():
        try:
            name, _, digest = head.read_text().strip().partition(" ")
        except OSError:
            name = digest = ""
        if name:
            tried.add(name)
            tip = _read_manifest(directory, name, digest or None)
            if tip is not None:
                chain = _build_chain(directory, tip)
                if chain is not None:
                    return chain
    # fall back: newest manifest whose whole chain validates
    names = sorted((p.name for p in directory.glob(MANIFEST_PREFIX + "*.json")),
                   reverse=True)
    for name in names:
        if name in tried:
            continue
        tip = _read_manifest(directory, name)
        if tip is None:
            continue
        chain = _build_chain(directory, tip)
        if chain is not None:
            return chain
    return None


def gc(directory: pathlib.Path, io: FileIO, keep_chains: int = 2) -> list[str]:
    """Delete unreachable artifacts; returns the deleted names.

    Reachability is computed from the *loadable* head chain, extended
    parent-ward until ``keep_chains`` bases have been collected. Anything
    else — torn frames from crashed saves, manifests never referenced by
    a valid HEAD, ``.tmp`` staging remnants, chains older than the keep
    window — is garbage. If no chain loads at all, nothing is deleted
    (an unreadable directory is evidence, not trash)."""
    directory = pathlib.Path(directory)
    chain = load_chain(directory)
    if chain is None:
        return []
    keep: set[str] = {HEAD_NAME}
    bases = 0
    cur: Manifest | None = chain[-1]
    # walk the full parent chain (committed history is linear: each base
    # records the previous chain's tip as its parent)
    while cur is not None:
        keep.add(cur.name)
        keep.update(fr["file"] for fr in cur.frames)
        if cur.kind == "base":
            bases += 1
            if bases >= keep_chains:
                break
        cur = (_read_manifest(directory, cur.parent, cur.parent_sha256)
               if cur.parent else None)
    deleted = []
    for p in sorted(directory.iterdir()):
        if not (p.name.startswith((MANIFEST_PREFIX, FRAME_PREFIX))
                or p.name.endswith(".tmp")):
            continue
        if p.name in keep:
            continue
        io.unlink(p)
        deleted.append(p.name)
    if deleted:
        io.fsync_dir(directory)
    return deleted
