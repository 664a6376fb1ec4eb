"""Checkpoint manifest + commit protocol (a copy of
horovod_tpu/ckpt/manifest.py: the same JSON, file names and atomic
writes, so either package reads what the other commits).

The crash-consistency contract, in one place:

* A checkpoint lives in a generation-numbered directory
  ``<root>/ckpt-<step>`` holding one ``.npy`` file per leaf shard, an
  optional ``objects.pkl`` (picklable non-array state), and a
  ``manifest.json`` naming every expected file with its slice of the
  global array.
* A checkpoint EXISTS only once its commit marker
  ``<root>/ckpt-<step>.done`` exists. The marker is a separate file,
  written atomically (tmp + rename) strictly AFTER every payload file
  and the manifest are durable — so a reader that sees the marker sees
  a complete checkpoint, and a writer killed mid-save leaves a
  marker-less directory that readers skip (CheckFreq's 2-phase commit,
  FAST '21 §4).
* Generations are monotone: each committed save records
  ``generation = latest committed generation + 1``, persisted in both
  the manifest and the marker. A resumed job continues the numbering
  (``latest_committed`` reads it back), so "newest" is a total order
  even when step counters regress across elastic rounds.
* Corrupt or partial directories are never deleted on the read path —
  they are QUARANTINED (renamed under ``<root>/quarantine/``) so the
  evidence survives for a postmortem while restore falls back to the
  next older committed generation.

Nothing here touches a device or takes a collective: this module is
pure filesystem protocol, shared by the async writer thread
(ckpt/async_ckpt.py), the restore path (ckpt/resume.py), and the
rank-0 ``checkpoint.py`` front door (its ``save`` writes the same
marker; ``restore_params`` requires it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.exceptions import CheckpointCorruptError

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"
OBJECTS_NAME = "objects.pkl"
DIR_PREFIX = "ckpt-"
DONE_SUFFIX = ".done"
QUARANTINE_DIR = "quarantine"


def dirname_for(step: int) -> str:
    return f"{DIR_PREFIX}{int(step):08d}"


def step_from_dirname(name: str) -> Optional[int]:
    if not name.startswith(DIR_PREFIX):
        return None
    tail = name[len(DIR_PREFIX):]
    return int(tail) if tail.isdigit() else None


def marker_path(root: str, step: int) -> str:
    return os.path.join(root, dirname_for(step) + DONE_SUFFIX)


@dataclasses.dataclass
class LeafEntry:
    """One pytree leaf: global shape/dtype, its recorded sharding spec
    (PartitionSpec serialized as a list per dim: axis-name list, or
    None for an unsharded dim), and the shard files covering it."""

    path: str                       # keypath string, e.g. "['params']['emb']"
    shape: Tuple[int, ...]
    dtype: str
    spec: Optional[List[Any]] = None
    # [{"file": name, "start": [...], "stop": [...]}] — start/stop per
    # dim of the global array; a single full-coverage file has
    # start=[0,...], stop=shape.
    files: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"path": self.path, "shape": list(self.shape),
                "dtype": self.dtype, "spec": self.spec,
                "files": self.files}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "LeafEntry":
        return LeafEntry(path=d["path"], shape=tuple(d["shape"]),
                         dtype=d["dtype"], spec=d.get("spec"),
                         files=list(d.get("files") or []))


@dataclasses.dataclass
class Manifest:
    step: int
    generation: int
    leaves: List[LeafEntry]
    mesh_axes: Optional[Dict[str, int]] = None   # axis name -> size at save
    world_size: Optional[int] = None
    has_objects: bool = False
    time: float = 0.0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": MANIFEST_VERSION,
            "step": int(self.step),
            "generation": int(self.generation),
            "time": self.time,
            "world_size": self.world_size,
            "mesh_axes": self.mesh_axes,
            "has_objects": self.has_objects,
            "extras": self.extras,
            "leaves": [l.to_json() for l in self.leaves],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Manifest":
        return Manifest(
            step=int(d["step"]), generation=int(d["generation"]),
            leaves=[LeafEntry.from_json(x) for x in d.get("leaves", [])],
            mesh_axes=d.get("mesh_axes"), world_size=d.get("world_size"),
            has_objects=bool(d.get("has_objects", False)),
            time=float(d.get("time", 0.0)),
            extras=dict(d.get("extras") or {}))


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_manifest(dirpath: str, manifest: Manifest) -> None:
    manifest.time = manifest.time or time.time()
    _atomic_write(os.path.join(dirpath, MANIFEST_NAME),
                  json.dumps(manifest.to_json(), indent=1).encode())


def read_manifest(dirpath: str) -> Manifest:
    """Raises CheckpointCorruptError on a missing or unparseable
    manifest — the caller decides whether to quarantine."""
    p = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(p, "rb") as f:
            return Manifest.from_json(json.loads(f.read().decode()))
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest unreadable at {p}: "
            f"{type(e).__name__}: {e}") from e


def write_marker(root: str, step: int, generation: int,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """The commit point: atomic, written only after every payload file
    is durable. Returns the marker path."""
    p = marker_path(root, step)
    body = {"step": int(step), "generation": int(generation),
            "time": time.time()}
    if extra:
        body.update(extra)
    _atomic_write(p, json.dumps(body).encode())
    return p


def write_done_marker(path: str,
                      extra: Optional[Dict[str, Any]] = None) -> str:
    """Path-addressed variant for non-generation checkpoints
    (checkpoint.py's dirs): writes ``<path>.done``."""
    p = os.path.abspath(path) + DONE_SUFFIX
    body = {"time": time.time()}
    if extra:
        body.update(extra)
    _atomic_write(p, json.dumps(body).encode())
    return p


def has_done_marker(path: str) -> bool:
    return os.path.exists(os.path.abspath(path) + DONE_SUFFIX)


def read_marker(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def committed(root: str) -> List[Tuple[int, int]]:
    """All committed checkpoints under `root` whose directory still
    exists, as (generation, step), sorted oldest generation first.
    Markers that fail to parse or point at a vanished directory are
    skipped (a GC'd generation leaves a brief marker-less window the
    other way around, never this one — dirs are removed AFTER their
    marker)."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    out: List[Tuple[int, int]] = []
    for name in names:
        if not (name.startswith(DIR_PREFIX) and name.endswith(DONE_SUFFIX)):
            continue
        body = read_marker(os.path.join(root, name))
        if not body or "generation" not in body or "step" not in body:
            continue
        step = int(body["step"])
        if os.path.isdir(os.path.join(root, dirname_for(step))):
            out.append((int(body["generation"]), step))
    return sorted(out)


def latest_committed(root: str) -> Optional[Tuple[int, int]]:
    """Newest committed checkpoint as (generation, step), or None."""
    all_c = committed(root)
    return all_c[-1] if all_c else None


def quarantine(root: str, step: int, reason: str) -> Optional[str]:
    """Move a corrupt/partial checkpoint dir (and its marker, if any)
    under <root>/quarantine/, suffixed with a timestamp so repeated
    failures never collide. Returns the new path (None if the dir was
    already gone)."""
    src = os.path.join(root, dirname_for(step))
    qdir = os.path.join(root, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dst = os.path.join(qdir, f"{dirname_for(step)}.{int(time.time() * 1e3)}")
    moved = None
    try:
        os.replace(src, dst)
        moved = dst
    except OSError:
        pass
    try:
        os.replace(marker_path(root, step), dst + DONE_SUFFIX)
    except OSError:
        pass
    if moved:
        _atomic_write(os.path.join(moved, "QUARANTINE_REASON"),
                      reason.encode())
    return moved


def sweep_stale(root: str) -> List[int]:
    """Quarantine marker-less ckpt dirs STRICTLY OLDER (by step) than
    the newest committed one: those are saves that died mid-write in a
    previous life — they can never be committed now. A marker-less dir
    NEWER than the last commit is left alone: it may be this process's
    own in-flight save. Returns the quarantined steps."""
    newest = latest_committed(root)
    if newest is None:
        return []
    _, newest_step = newest
    done_steps = {s for _, s in committed(root)}
    out = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for name in names:
        step = step_from_dirname(name)
        if step is None or name.endswith(DONE_SUFFIX):
            continue
        if step < newest_step and step not in done_steps:
            if quarantine(root, step, "stale uncommitted save (writer "
                                      "died before commit)"):
                out.append(step)
    return out


def gc(root: str, keep: int) -> List[int]:
    """Drop committed generations beyond the newest `keep` (marker
    first, then the directory — the inverse of the commit order, so a
    crash mid-GC leaves a marker-less dir, never a dir-less marker
    that `committed` would misread). Returns the dropped steps."""
    if keep <= 0:
        return []
    all_c = committed(root)
    dropped = []
    for _, step in all_c[:-keep]:
        try:
            os.remove(marker_path(root, step))
        except OSError:
            pass
        d = os.path.join(root, dirname_for(step))
        try:
            for name in os.listdir(d):
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass
            os.rmdir(d)
        except OSError:
            pass
        dropped.append(step)
    return dropped
