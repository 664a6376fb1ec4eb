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
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import re
from typing import Dict, List, Optional, Tuple

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

    def group_of(self, axis: str, rank: int) -> List[int]:
        """The ranks sharing `rank`'s sub-communicator along `axis` (rank
        included), in mesh order."""
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

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


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
