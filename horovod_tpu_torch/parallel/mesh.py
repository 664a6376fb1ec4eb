"""The named-axis mesh over the process world (counterpart of
horovod_tpu/parallel/mesh.py).

    dp — data parallel (the gradient all-reduce)
    pp — pipeline stages
    tp — tensor parallel
    sp — sequence parallel (ring or Ulysses attention over this axis)
    ep — expert parallel

`MeshSpec`, the HOROVOD_MESH grammar and `slice_groups` are the JAX
package's, copied: the same names, sizes, rank partitions and errors
(HorovodError where the JAX package raises HorovodTpuError).

`build_mesh` is where the two packages differ. The JAX package reshapes
a device list into a `jax.sharding.Mesh`; here one process drives one
device, so the mesh is the world's ranks reshaped to `spec.sizes()`
(rank r at coordinate unravel(r, sizes)), and each axis group is a
registered process set (core/process_sets.py) with its torch process
group. Process sets and not `torch.distributed.device_mesh`: the eager
collectives, `DistributedOptimizer` and `hvd.axis_process_set` already
speak process sets, and the set table gives every identical rank list
one group, so the five axes of a 4-rank mesh cost at most one group
per distinct rank list. `new_group` is collective over the world, so
every rank builds every axis's groups, in AXIS_ORDER and then in group
order, members or not; `hvd.init()` does it once under HOROVOD_MESH.

Where the JAX package names an axis inside `shard_map`, the port names
it against the mesh in force: `use_mesh(mesh)` makes `mesh` the one
`axes_process_set` resolves names against on this thread (as shard_map's mesh
does for `lax.psum`), else the HOROVOD_MESH mesh of `hvd.init()`. An
axis of size 1, or no mesh at all, has no set: the collectives over it
are identities, as JAX's are over a size-1 axis. `shard_of` cuts this
rank's block of a global array under a partition spec, the block
`jax.device_put(x, NamedSharding(mesh, spec))` places on its device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from horovod_tpu_torch.common.exceptions import HorovodError

# Canonical axis order: latency-tolerant axes first (outermost),
# latency-sensitive last (innermost neighbours).
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "ep", "sp", "tp")

#: The HOROVOD_MESH spec grammar: comma-separated `axis=size` entries
#: over the canonical axes, e.g. "dp=2,sp=2". `auto` (or -1) gives one
#: axis every rank the others don't claim.
_SPEC_ENTRY_RE = re.compile(r"^([a-z]+)\s*=\s*(auto|-1|\d+)$")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes per named parallelism axis; 1 = axis unused."""
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self) -> None:
        for a in AXIS_ORDER:
            if getattr(self, a) < 1:
                raise HorovodError(
                    f"mesh axis {a}={getattr(self, a)} must be >= 1 "
                    "(use 1 for an unused axis)")

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def total(self) -> int:
        return int(math.prod(self.sizes()))

    @staticmethod
    def infer(n_devices: int, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1) -> "MeshSpec":
        """Fix the model axes; give every remaining rank to dp."""
        if n_devices < 1:
            raise HorovodError(f"n_devices={n_devices} must be >= 1")
        inner = tp * sp * pp * ep
        if inner < 1 or n_devices % inner:
            raise HorovodError(
                f"n_devices={n_devices} not divisible by tp*sp*pp*ep={inner}")
        return MeshSpec(dp=n_devices // inner, pp=pp, ep=ep, sp=sp, tp=tp)

    @staticmethod
    def parse(text: str, n_devices: Optional[int] = None) -> "MeshSpec":
        """Parse a HOROVOD_MESH spec such as "dp=2,sp=2".

        Unmentioned axes are 1, except dp, which is `auto` when
        `n_devices` is known (the `infer` rule). At most one axis may be
        `auto`/-1; with `n_devices` given the spec must cover the ranks
        exactly."""
        sizes: Dict[str, int] = {}
        auto_axis: Optional[str] = None
        for part in text.strip().split(","):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_ENTRY_RE.match(part)
            if not m:
                raise HorovodError(
                    f"bad HOROVOD_MESH entry {part!r}: expected "
                    f"axis=size with axis in {AXIS_ORDER} "
                    "(e.g. \"dp=2,tp=4\")")
            axis, val = m.group(1), m.group(2)
            if axis not in AXIS_ORDER:
                raise HorovodError(
                    f"unknown mesh axis {axis!r} in HOROVOD_MESH "
                    f"(choose from {AXIS_ORDER})")
            if axis in sizes or axis == auto_axis:
                raise HorovodError(
                    f"duplicate mesh axis {axis!r} in HOROVOD_MESH")
            if val in ("auto", "-1"):
                if auto_axis is not None:
                    raise HorovodError(
                        "at most one HOROVOD_MESH axis may be auto")
                auto_axis = axis
            else:
                sizes[axis] = int(val)
        if not sizes and auto_axis is None:
            raise HorovodError(f"empty HOROVOD_MESH spec {text!r}")
        if auto_axis is None and "dp" not in sizes and n_devices:
            auto_axis = "dp"
        if auto_axis is not None:
            if not n_devices:
                raise HorovodError(
                    f"HOROVOD_MESH axis {auto_axis}=auto needs a known "
                    "device count")
            fixed = math.prod(sizes.values()) if sizes else 1
            if fixed < 1 or n_devices % fixed:
                raise HorovodError(
                    f"HOROVOD_MESH {text!r}: {n_devices} devices not "
                    f"divisible by the fixed axes' product {fixed}")
            sizes[auto_axis] = n_devices // fixed
        spec = MeshSpec(**sizes)
        if n_devices and spec.total != n_devices:
            raise HorovodError(
                f"HOROVOD_MESH {text!r} covers {spec.total} devices, "
                f"job has {n_devices}")
        return spec

    def describe(self) -> str:
        """Canonical round-trippable spec string: the axes above 1 in
        canonical order, "dp=1" for the one-rank mesh."""
        parts = [f"{a}={getattr(self, a)}" for a in AXIS_ORDER
                 if getattr(self, a) > 1]
        return ",".join(parts) if parts else "dp=1"

    def axis_groups(self, axes) -> List[List[int]]:
        """Partition of the flat rank space `range(total)` into the
        sub-communicators of `axes` (an axis name or a set of them):
        ranks in one group differ only in their coordinates along
        `axes`."""
        wanted = {axes} if isinstance(axes, str) else set(axes)
        bad = wanted - set(AXIS_ORDER)
        if bad:
            raise HorovodError(f"unknown mesh axes {sorted(bad)}")
        sizes = self.sizes()
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        moving = [i for i, a in enumerate(AXIS_ORDER) if a in wanted]
        fixed = [i for i in range(len(sizes)) if i not in moving]
        groups: List[List[int]] = []
        for fcoord in itertools.product(*(range(sizes[i]) for i in fixed)):
            base = sum(c * strides[i] for c, i in zip(fcoord, fixed))
            group = [base + sum(c * strides[i] for c, i in
                                zip(mcoord, moving))
                     for mcoord in itertools.product(
                         *(range(sizes[i]) for i in moving))]
            groups.append(group)
        return groups

    def group_of(self, axis: Union[str, Iterable[str]],
                 rank: int) -> List[int]:
        """The ranks sharing `rank`'s sub-communicator along `axis` (an
        axis name or a set of them; rank included), in mesh order."""
        for g in self.axis_groups(axis):
            if rank in g:
                return g
        raise HorovodError(
            f"rank {rank} outside the {self.sizes()} mesh")


def spec_from_env(n_devices: int) -> Optional[MeshSpec]:
    """The HOROVOD_MESH MeshSpec, or None when the knob is unset or
    empty (a data-parallel world)."""
    text = os.environ.get("HOROVOD_MESH", "").strip()
    if not text:
        return None
    return MeshSpec.parse(text, n_devices)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks on the five named axes: `devices` holds rank r
    at coordinate unravel(r, spec.sizes()) (named as the JAX Mesh's
    field, whose cells are devices, one per rank here). Each axis group
    is a registered process set: `hvd.axis_process_set(axis)`."""

    spec: MeshSpec
    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXIS_ORDER
    # This rank's process set of each axis tuple looked up so far
    # (axes_process_set): a layer's collectives look theirs up each call.
    _sets: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s index along each axis."""
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}


def build_mesh(spec: MeshSpec) -> Mesh:
    """The mesh of `spec` over the initialized world: every axis group of
    every axis registered as a process set, on every rank in the same
    order (module docstring). Refuses a world whose size is not
    `spec.total`."""
    from horovod_tpu_torch.core import process_sets, topology
    size = topology.size()
    if spec.total != size:
        raise HorovodError(
            f"mesh spec {spec.sizes()} needs {spec.total} devices, "
            f"got {size}")
    table = process_sets._table()
    for axis in AXIS_ORDER:
        for group in spec.axis_groups(axis):
            table.register(process_sets.ProcessSet(group))
    return Mesh(spec, np.arange(size).reshape(spec.sizes()))


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def slice_groups(n_devices: int, slices: int) -> List[List[int]]:
    """Partition of the flat rank space into `slices` equal contiguous
    slices (HOROVOD_MESH_SLICES), aligned with the outermost (dp)
    axis."""
    if slices <= 0 or n_devices % slices:
        raise HorovodError(
            f"HOROVOD_MESH_SLICES={slices} does not divide the "
            f"{n_devices}-device world into equal slices")
    per = n_devices // slices
    return [list(range(s * per, (s + 1) * per)) for s in range(slices)]


# ------------------------------------------------- axes in the code

_active = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Resolve axis names against `mesh` on this thread inside the block
    (the port's shard_map scope); None: the HOROVOD_MESH mesh."""
    prev = getattr(_active, "mesh", None)
    _active.mesh = mesh
    try:
        yield mesh
    finally:
        _active.mesh = prev


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `use_mesh`, else `hvd.hybrid_mesh()`,
    else None (no world, or a data-parallel one)."""
    m = getattr(_active, "mesh", None)
    if m is not None:
        return m
    from horovod_tpu_torch.core import topology
    return topology.hybrid_mesh() if topology.is_initialized() else None


def axis_sizes(mesh: Optional[Mesh] = None) -> Dict[str, int]:
    """Every axis's size on `mesh` (default current_mesh(); 1 for each
    without one)."""
    m = mesh if mesh is not None else current_mesh()
    return mesh_axis_sizes(m) if m is not None else {a: 1 for a in
                                                      AXIS_ORDER}


def axis_index(axis: str, mesh: Optional[Mesh] = None) -> int:
    """This rank's index along `axis` (`lax.axis_index`); 0 without a
    mesh."""
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        return 0
    from horovod_tpu_torch.core import topology
    return m.coords(topology.rank())[axis]


def axes_process_set(axes: Union[str, Sequence[str]],
                     mesh: Optional[Mesh] = None):
    """This rank's process set over `axes` (one name or several) of
    `mesh` (default current_mesh()), or None where they span one rank.
    A set not registered yet is registered with every group of the same
    axes first, which is collective over the world: call it at the same
    point on every rank (a single axis's groups were registered by
    build_mesh, so for one axis this only looks the set up)."""
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        return None
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axis_sizes(m)
    if math.prod(sizes[a] for a in names) == 1:
        return None
    if names in m._sets:
        return m._sets[names]
    from horovod_tpu_torch.core import process_sets, topology
    table = process_sets._table()
    mine = None
    for group in m.spec.axis_groups(names):
        ps = process_sets.ProcessSet(group)
        table.register(ps)
        if topology.rank() in group:
            mine = ps
    m._sets[names] = mine
    return mine


def _spec_names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_index(spec, shape: Sequence[int], mesh: Mesh, rank: int
                ) -> Tuple[slice, ...]:
    """The slices of a global array of `shape` that rank `rank` holds
    under partition spec `spec` (one entry per leading dim: None, an axis
    name or a tuple of names, major first; missing trailing entries are
    None), as NamedSharding lays it out. A spec with one entry more than
    the array has dims leads with the axis of a stack the caller split
    already (the per-layer leaves of a pipelined model): that entry is
    skipped."""
    spec = tuple(spec or ())
    if len(spec) == len(shape) + 1:
        spec = spec[1:]
    if len(spec) > len(shape):
        raise HorovodError(f"partition spec {spec} has more entries than "
                           f"the array's {len(shape)} dims")
    sizes, at = mesh_axis_sizes(mesh), mesh.coords(rank)
    out = []
    for d, n in enumerate(shape):
        names = _spec_names(spec[d]) if d < len(spec) else ()
        parts, idx = 1, 0
        for a in names:
            parts, idx = parts * sizes[a], idx * sizes[a] + at[a]
        if n % parts:
            raise HorovodError(f"dim {d} of size {n} does not split over "
                               f"{names} ({parts} parts)")
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_of(x, spec, mesh: Optional[Mesh] = None, rank: Optional[int] = None):
    """Rank `rank`'s (default this rank's) block of the global array `x`
    under `spec` on `mesh` (default current_mesh()): a copy, so that the
    global array can go; `x` itself where no mesh is in force."""
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        return x
    if rank is None:
        from horovod_tpu_torch.core import topology
        rank = topology.rank()
    block = x[shard_index(spec, tuple(x.shape), m, rank)]
    return block.clone() if hasattr(block, "clone") else np.array(block)
