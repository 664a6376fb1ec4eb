"""Snapshot and assemble of checkpoint trees of torch tensors
(counterpart of horovod_tpu/ckpt/sharded.py).

A tree is nested dicts, lists and tuples whose leaves are torch tensors,
numpy arrays or scalars. Leaves are addressed by the JAX package's
keypaths (``['params']['w']``, ``[0]``), dict keys in sorted order, so a
manifest names the same leaves whichever package wrote it.

``snapshot_tree`` is the only phase that touches the card: the CUDA
leaves are copied into pinned host memory on a side stream that waits
for the current one, and one event wait ends the copy, so what the
snapshot holds is a copy that a later in-place optimizer step cannot
change. It is the bounded, on-critical-path half of the two-phase save
(ckpt/async_ckpt.py runs it under perfscope's ``checkpoint`` phase);
everything else here is host-only.

Which rank writes what:
- a plain leaf is replicated on every rank of a data-parallel job, so
  only the writer of replicated leaves (``keep_replicated``) writes it;
- a ``Fragment`` is a part of a larger leaf, given with its offsets into
  the global array; it writes one shard file named by its offsets, so
  the writers of a multi-writer save never clobber each other's files.
Placing an assembled leaf onto a device mesh (``reshard``) needs the
port's mesh, which comes with ROADMAP A11.

bf16 on disk: the JAX package writes an ml_dtypes bfloat16 leaf as a
``.npy`` of raw 2-byte voids (descr ``'<V2'``) with ``dtype
"bfloat16"`` in the manifest. The port writes a bf16 tensor's bits the
same way, byte for byte, and reads ``'<V2'`` (or int16) bits back as
``torch.bfloat16``; it never asks numpy for a bfloat16 dtype.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.exceptions import (CheckpointCorruptError,
                                                 HorovodError)
from horovod_tpu_torch.ckpt.manifest import LeafEntry

BF16 = "bfloat16"


class Fragment(NamedTuple):
    """A part of a global leaf of shape `shape`, starting at `start`."""

    data: Any
    start: Tuple[int, ...]
    shape: Tuple[int, ...]


def spec_to_json(spec) -> Optional[List[Any]]:
    """A partition spec (a sequence of None, an axis name, or a tuple of
    names per dim) -> JSON: per dim an axis-name list or None."""
    if spec is None:
        return None
    out: List[Any] = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append([str(a) for a in entry])
        else:
            out.append([str(entry)])
    return out


def spec_from_json(spec_json: Optional[List[Any]]) -> Optional[tuple]:
    """JSON -> the spec as a tuple (None stays None)."""
    if spec_json is None:
        return None
    entries = []
    for entry in spec_json:
        if entry is None:
            entries.append(None)
        elif len(entry) == 1:
            entries.append(entry[0])
        else:
            entries.append(tuple(entry))
    return tuple(entries)


# ---------------------------------------------------------------- trees

def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, Fragment,
                          bool, int, float, complex))


def _key(k) -> str:
    return f"[{k!r}]"


def flatten(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keypath, leaf) in the JAX package's order: dict keys sorted,
    sequences in order; None is an empty subtree."""
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], path + _key(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, path + _key(i))
    elif tree is not None:
        raise TypeError(f"checkpoint tree leaf {path or '<root>'} of type "
                        f"{type(tree).__name__} is not an array or scalar")


def _map_like(like: Any, fn, path: str = "") -> Any:
    """`like`'s structure with each leaf replaced by fn(keypath, leaf)."""
    if _is_leaf(like):
        return fn(path, like)
    if isinstance(like, dict):
        return type(like)((k, _map_like(like[k], fn, path + _key(k)))
                          for k in like)
    if isinstance(like, (list, tuple)):
        out = [_map_like(v, fn, path + _key(i)) for i, v in enumerate(like)]
        return out if isinstance(like, list) else type(like)(out)
    return like


def dtype_name(x) -> str:
    """The manifest's dtype name: numpy's, and torch's in the same
    words (torch.bfloat16 -> "bfloat16")."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[-1]
    return np.asarray(x).dtype.name


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointCorruptError(f"checkpoint dtype {name!r} has no "
                                     f"torch counterpart")
    return dt


# ------------------------------------------------------------- snapshot

class LeafSnapshot:
    """One leaf's host copy: manifest entry (files unfilled) + the
    shard payloads (host torch tensors or numpy arrays) to be written by
    the background persist phase."""

    __slots__ = ("entry", "shards")

    def __init__(self, entry: LeafEntry,
                 shards: List[Tuple[Tuple[int, ...], Tuple[int, ...], Any]]):
        self.entry = entry
        self.shards = shards  # [(start, stop, host array)]

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(a) for _, _, a in self.shards)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _host_copies(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of `tensors` in host memory, taken at this point of each
    tensor's device stream. CUDA tensors go into pinned buffers on a side
    stream per device, and one event wait per device ends the copies."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.device.type == "cuda":
            by_dev.setdefault(t.device, []).append(i)
        else:
            out[i] = t.detach().clone()
    events = []
    for dev, idx in by_dev.items():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for i in idx:
                t = tensors[i].detach()
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                out[i] = host
        events.append(side.record_event())
    for ev in events:
        ev.synchronize()
    return out


def snapshot_tree(tree: Any, keep_replicated: bool = True
                  ) -> Tuple[List[LeafSnapshot], int]:
    """Host snapshot of every leaf (in flatten order) and the total host
    bytes. Blocks until the device copies are done: the only part of a
    save on the training critical path. With `keep_replicated` False the
    plain (replicated) leaves get an entry and no shard: another rank
    writes them."""
    leaves = list(flatten(tree))
    tensors = []
    for _, leaf in leaves:
        data = leaf.data if isinstance(leaf, Fragment) else leaf
        if isinstance(data, torch.Tensor) and (
                keep_replicated or isinstance(leaf, Fragment)):
            tensors.append(data)
    copies = iter(_host_copies(tensors))
    out: List[LeafSnapshot] = []
    total = 0
    for path, leaf in leaves:
        frag = isinstance(leaf, Fragment)
        data = leaf.data if frag else leaf
        keep = keep_replicated or frag
        if isinstance(data, torch.Tensor):
            host = next(copies) if keep else None
        else:
            host = np.array(data) if keep else None  # a copy
            data = host if host is not None else np.asarray(data)
        shape = tuple(leaf.shape) if frag else tuple(data.shape)
        entry = LeafEntry(path=path, shape=shape, dtype=dtype_name(data))
        shards = []
        if keep:
            start = tuple(int(a) for a in leaf.start) if frag \
                else tuple(0 for _ in shape)
            stop = tuple(a + int(n) for a, n in zip(start, host.shape))
            shards.append((start, stop, host))
        snap = LeafSnapshot(entry, shards)
        total += snap.nbytes
        out.append(snap)
    return out, total


# ---------------------------------------------------------------- write

def _save(path: str, arr) -> None:
    """One shard as `.npy`; a bf16 tensor's bits under descr '<V2', as
    numpy writes an ml_dtypes bfloat16 array."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            bits = arr.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": tuple(bits.shape)})
                bits.tofile(f)  # no copy, and numpy lets go of the GIL
            return
        arr = arr.numpy()
    np.save(path, arr, allow_pickle=False)


def write_snapshots(dirpath: str, snaps: Sequence[LeafSnapshot]) -> int:
    """Persist every shard payload as `.npy` files into `dirpath`,
    filling each entry's `files` list. Host-only (the background
    phase). Returns bytes written.

    Shard files are named by their START OFFSETS into the global array,
    not by a local enumeration index: in a multi-writer save every
    process persists into the SAME directory, and offset names are
    unique per distinct shard, so concurrent writers never clobber each
    other's shards, and the primary's merge can dedupe fragments by
    filename (same name => same shard)."""
    os.makedirs(dirpath, exist_ok=True)
    written = 0
    for i, snap in enumerate(snaps):
        snap.entry.files = []
        for start, stop, arr in snap.shards:
            full = start == tuple(0 for _ in snap.entry.shape) and \
                stop == snap.entry.shape
            off = "" if full else ".o" + "-".join(str(a) for a in start)
            name = f"leaf-{i:05d}{off}.npy"
            _save(os.path.join(dirpath, name), arr)
            written += _nbytes(arr)
            snap.entry.files.append({"file": name, "start": list(start),
                                     "stop": list(stop)})
    return written


# --------------------------------------------------------------- restore

def _load(p: str, entry: LeafEntry) -> torch.Tensor:
    try:
        part = np.load(p, allow_pickle=False)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint leaf shard unreadable: {p}: "
            f"{type(e).__name__}: {e}") from e
    if not part.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        part = part.copy()
    if entry.dtype == BF16:
        if part.dtype.itemsize != 2 or part.dtype.kind not in "Vi":
            raise CheckpointCorruptError(
                f"checkpoint leaf shard {p} holds {part.dtype}, not the "
                f"2-byte bfloat16 bits the manifest says")
        return torch.from_numpy(part.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(part)


def assemble_leaf(dirpath: str, entry: LeafEntry) -> torch.Tensor:
    """Shard files -> the full leaf as a host tensor, coverage-verified."""
    arr = torch.empty(entry.shape, dtype=torch_dtype(entry.dtype))
    covered = 0
    for f in entry.files:
        p = os.path.join(dirpath, f["file"])
        part = _load(p, entry)
        want = tuple(b - a for a, b in zip(f["start"], f["stop"]))
        if tuple(part.shape) != want:
            raise CheckpointCorruptError(
                f"checkpoint leaf shard {p} has shape {tuple(part.shape)}, "
                f"manifest says {want}")
        sl = tuple(slice(a, b) for a, b in zip(f["start"], f["stop"]))
        arr[sl] = part.to(arr.dtype)
        covered += part.numel()
    if covered < arr.numel():
        raise CheckpointCorruptError(
            f"checkpoint leaf {entry.path!r} incompletely covered: "
            f"{covered}/{arr.numel()} elements present in "
            f"{len(entry.files)} shard file(s) under {dirpath}")
    return arr


def _parse_dict_keypath(path: str) -> Optional[List[str]]:
    """``"['params']['emb']"`` -> ``["params", "emb"]``; None when the
    keypath has non-dict components (then `like` is required)."""
    out: List[str] = []
    rest = path
    while rest:
        m = re.match(r"^\[(?:'([^']*)'|\"([^\"]*)\")\]", rest)
        if not m:
            return None
        out.append(m.group(1) if m.group(1) is not None else m.group(2))
        rest = rest[m.end():]
    return out


def _as_like(arr: torch.Tensor, like) -> Any:
    """The restored leaf in the type of `like`'s leaf: a numpy scalar or
    a Python number as that type, a numpy array as one (not bf16),
    anything else a host tensor."""
    if isinstance(like, (np.generic, bool, int, float, complex)):
        return type(like)(arr.item())
    if isinstance(like, np.ndarray) and arr.dtype != torch.bfloat16:
        return arr.numpy()
    return arr


def restore_tree(dirpath: str, entries: Sequence[LeafEntry],
                 like: Optional[Any] = None) -> Any:
    """Manifest entries -> tree of host leaves.

    With `like`: leaves are matched by keypath against `like`'s
    structure (a missing path is a CheckpointCorruptError naming it) and
    the result has `like`'s structure and leaf types. Without `like`:
    the tree is rebuilt as nested dicts of host tensors from the recorded
    keypaths (dict-only trees; anything else needs `like`)."""
    by_path: Dict[str, LeafEntry] = {e.path: e for e in entries}
    if like is not None:
        def load(path, leaf):
            e = by_path.get(path)
            if e is None:
                raise CheckpointCorruptError(
                    f"checkpoint at {dirpath} has no leaf {path!r} "
                    f"(has: {sorted(by_path)[:8]}...)")
            return _as_like(assemble_leaf(dirpath, e), leaf)
        return _map_like(like, load)
    root: Dict[str, Any] = {}
    for e in entries:
        keys = _parse_dict_keypath(e.path)
        if keys is None:
            raise CheckpointCorruptError(
                f"checkpoint leaf {e.path!r} is not dict-addressed; "
                f"restore it with like=<matching tree>")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = assemble_leaf(dirpath, e)
    return root


def reshard(tree: Any, mesh, specs: Any) -> Any:
    """Placing an assembled tree onto a device mesh under per-leaf specs
    needs the port's device mesh (parallel/mesh.py), which is not ported
    yet."""
    raise HorovodError("ckpt.reshard places leaves onto a device mesh, "
                       "which the port gets with parallel/mesh.py "
                       "(ROADMAP A11)")
