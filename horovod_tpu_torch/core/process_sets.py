"""Process sets: collectives over subsets of ranks (counterpart of
horovod_tpu/core/process_sets.py).

A ProcessSet is a sorted rank list; registered, it gets an id and a
communicator: `dist.new_group(ranks)` where the JAX package builds a
sub-mesh. The table reuses freed ids, gives identical rank lists one
id, refuses ranks out of range and never removes the global set (id 0,
the world's default group).

`new_group` is collective over the whole world: every rank registers
the same sets in the same order, members or not, as the JAX package
asks of every process (add_process_set with identical ranks). A rank
outside a set holds `GroupMember.NON_GROUP_MEMBER` for it, and the
collectives refuse it (`included()`). After init, adding and removing
sets needs HOROVOD_DYNAMIC_PROCESS_SETS=1; `init(process_sets=[...])`
registers them at init without it. `axis_process_set` returns the set
of one axis of the HOROVOD_MESH mesh (parallel/mesh.py), whose groups
init registered on every rank.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.exceptions import HorovodError

GLOBAL_PROCESS_SET_ID = 0


class ProcessSet:
    """A subset of ranks that collectives can be restricted to; None
    ranks is the global set."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(set(int(r) for r in ranks)) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self.group = None  # dist group; None is the default (world) group
        self.mesh_axis: Optional[str] = None  # set by axis_process_set

    def included(self) -> bool:
        """Is this process a member?"""
        from horovod_tpu_torch.core import topology
        return self.ranks is None or topology.rank() in self.ranks

    def size(self) -> int:
        if self.ranks is None:
            from horovod_tpu_torch.core import topology
            return topology.size()
        return len(self.ranks)

    def rank_index(self, global_rank: int) -> int:
        """Position of a global rank within this set."""
        if self.ranks is None:
            return global_rank
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            raise HorovodError(
                f"rank {global_rank} is not in process set "
                f"{self.process_set_id}")

    def global_rank(self, index: int) -> int:
        """The global rank at position `index` of this set."""
        return index if self.ranks is None else self.ranks[index]

    def __repr__(self) -> str:
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={self.ranks if self.ranks is not None else 'GLOBAL'})")


global_process_set = ProcessSet(None)


class ProcessSetTable:
    """Registry with id reuse (the JAX package's ProcessSetTable)."""

    def __init__(self, size: int) -> None:
        self._lock = threading.RLock()
        self._size = size
        self._table: Dict[int, ProcessSet] = {}  # guarded-by: _lock
        self._next_id = 1
        self._free_ids: List[int] = []
        global_process_set.process_set_id = GLOBAL_PROCESS_SET_ID
        global_process_set.group = None
        self._table[GLOBAL_PROCESS_SET_ID] = global_process_set

    def register(self, ps: ProcessSet) -> int:
        with self._lock:
            if ps.ranks is None:
                ps.process_set_id = GLOBAL_PROCESS_SET_ID
                ps.group = None
                return GLOBAL_PROCESS_SET_ID
            bad = [r for r in ps.ranks if r < 0 or r >= self._size]
            if bad:
                raise HorovodError(f"process set ranks out of range: {bad}")
            for sid, existing in self._table.items():
                if existing.ranks == ps.ranks:
                    ps.process_set_id = sid
                    ps.group = existing.group
                    return sid
            sid = self._free_ids.pop() if self._free_ids else self._next_id
            if sid == self._next_id:
                self._next_id += 1
            ps.process_set_id = sid
            ps.group = dist.new_group(ps.ranks)
            self._table[sid] = ps
            if ps.included():
                # The members' first operation on the group involves them
                # all: an NCCL communicator must start so before a
                # point-to-point exchange between some of them (Adasum).
                from horovod_tpu_torch.core import topology
                from horovod_tpu_torch.ops.collectives import guarded_wait
                guarded_wait(dist.all_reduce(
                    torch.zeros(1, device=topology.device()),
                    group=ps.group, async_op=True), "process_set_register")
            return sid

    def remove(self, ps: ProcessSet) -> None:
        with self._lock:
            sid = ps.process_set_id
            if sid in (None, GLOBAL_PROCESS_SET_ID):
                raise HorovodError("cannot remove the global process set")
            if sid in self._table:
                del self._table[sid]
                self._free_ids.append(sid)
                dist.destroy_process_group(ps.group)
            ps.process_set_id = None
            ps.group = None

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            if process_set_id not in self._table:
                raise HorovodError(
                    f"unknown process set id {process_set_id}")
            return self._table[process_set_id]

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._table)

    def clear(self) -> None:
        """Unregister every set (at shutdown, which destroys the groups
        with the world)."""
        with self._lock:
            for ps in self._table.values():
                ps.process_set_id = None
                ps.group = None
            self._table.clear()


def _current_table() -> ProcessSetTable:
    from horovod_tpu_torch.core import topology
    return topology._require().process_set_table


def _require_dynamic() -> None:
    from horovod_tpu_torch.core import topology
    if not topology.config().dynamic_process_sets:
        raise HorovodError(
            "adding/removing process sets after hvd.init() requires "
            "HOROVOD_DYNAMIC_PROCESS_SETS=1 (reference: "
            "horovod/common/process_sets.py:123 dynamic requirement); "
            "alternatively pass process_sets=[...] to hvd.init()")


def add_process_set(ranks_or_ps) -> ProcessSet:
    """Register a new process set after init; every rank calls it with
    the same ranks."""
    _require_dynamic()
    ps = ranks_or_ps if isinstance(ranks_or_ps, ProcessSet) else ProcessSet(
        ranks_or_ps)
    _current_table().register(ps)
    return ps


def remove_process_set(ps: ProcessSet) -> None:
    """Deregister a set and destroy its group; every rank calls it."""
    _require_dynamic()
    _current_table().remove(ps)


def get_process_set(process_set_id: int) -> ProcessSet:
    return _current_table().get(process_set_id)


def axis_process_set(axis: str, rank: Optional[int] = None) -> ProcessSet:
    """The process set of `rank`'s (default this rank's) sub-communicator
    along a named axis of the HOROVOD_MESH mesh.

    With HOROVOD_MESH="dp=2,sp=2", rank 3 sits at (dp=1, sp=1); its `dp`
    set is ranks [1, 3] and its `sp` set ranks [2, 3]. The set bypasses
    HOROVOD_DYNAMIC_PROCESS_SETS: it is a function of the mesh spec
    every rank agreed on at init, which registered every axis group
    already, so this only looks it up (the table dedupes identical rank
    lists). Returns a handle tagged with `axis` that shares the
    registered set's id and group, so two axes with the same ranks keep
    their own `mesh_axis`."""
    from horovod_tpu_torch.core import topology
    spec = topology.mesh_spec()
    if spec is None:
        raise HorovodError(
            "axis_process_set requires a hybrid mesh: set HOROVOD_MESH "
            "(e.g. \"dp=2,tp=4\") before hvd.init()")
    if rank is None:
        rank = topology.rank()
    group = spec.group_of(axis, rank)
    reg = ProcessSet(group)
    _current_table().register(reg)
    handle = ProcessSet(group)
    handle.process_set_id = reg.process_set_id
    handle.group = reg.group
    handle.mesh_axis = axis
    return handle
