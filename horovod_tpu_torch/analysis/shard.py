"""hvdshard: static sharding and per-device memory analysis (HVD3xx;
counterpart of horovod_tpu/analysis/shard.py).

The classic failures of a sharded step are visible in its program
before a long run finds them:

* a large table nobody sharded is **replicated** on every device
  (HVD301);
* a resharding collective (all-gather/all-to-all/permute) nobody asked
  for moves whole tensors inside the step (HVD302);
* the per-device working set exceeds device memory (HVD303);
* a mesh axis is paid for but shards nothing (HVD304);
* an all-reduce whose consumers each keep only their shard should have
  been a reduce-scatter (HVD305).

This module is the sharding-aware layer over the model of
``analysis/hlo.py``:

* **StableHLO MLIR** (pre-partition): sharding arrives as
  ``mhlo.sharding`` attributes on arguments and ``custom_call
  @Sharding`` ops; shapes are *global*.
* **post-SPMD HLO text**: shapes are *per-device*, entry parameters keep
  their ``sharding={...}`` attrs, and the printed order is the schedule
  the donation-aware liveness pass walks for the static per-device
  peak-memory estimate.
* **a recorded torch step** (``analysis/graph.py``): one rank's program,
  per-device shapes in executed order like post-SPMD HLO; its entry
  parameters carry the sharding the optimizer's ``sharding_spec`` gives
  them, its collectives the chain of port functions that issued them
  (the origin HVD302 reads), and its views and in-place updates are
  aliases the liveness pass does not count twice.

Rules live in ``analysis/shard_rules.py``; findings ride the shared
driver machinery and feed ``hvdshard_findings_total{rule}``. ``python -m
horovod_tpu_torch.analysis --hlo-step lm_sharded`` records the tied LM's
dp x tp step in a gloo world and lints each rank's program.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis.hlo import (
    HloOp, HloProgram, TensorType, counter_metrics, op_sharding, parse,
    read_files, run_rules,
)

_MB = 1024 * 1024


def _bytes_env(name: str, default: Optional[int]) -> Optional[int]:
    """Byte-count env knob accepting plain ints or K/M/G suffixes
    (``HOROVOD_HLO_LINT_HBM_BUDGET=16G``). Unset -> default; a
    malformed value raises — silently falling back would disarm the
    very gate (HVD303 and friends) the knob was set to arm, in exactly
    the runs that set it (the flops.py loud-on-garbage policy)."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([kKmMgG]?)[bB]?", v)
    if not m:
        raise ValueError(
            f"{name}={v!r} is not a byte count (use plain bytes or a "
            "K/M/G suffix, e.g. 16G)")
    mult = {"": 1, "k": 1024, "m": _MB, "g": 1024 * _MB}[m.group(2).lower()]
    return int(float(m.group(1)) * mult)


# ---------------------------------------------------- sharding strings

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One parsed HLO sharding annotation.

    ``tile_dims`` are the per-tensor-dimension shard counts;
    ``replicate_factor`` is how many devices hold each shard (the
    trailing ``last_tile_dim_replicate`` group, or every device for
    ``{replicated}``); ``assignment`` is the flat device-id order over
    the C-order tile grid (+ the replication dim innermost), or None
    when the kind carries no grid (replicated/maximal/manual).
    """

    kind: str                     # replicated | tiled | maximal | manual
    tile_dims: Tuple[int, ...] = ()
    replicate_factor: int = 1
    assignment: Optional[Tuple[int, ...]] = None

    @property
    def shard_factor(self) -> int:
        n = 1
        for d in self.tile_dims:
            n *= d
        return n

    @property
    def fully_replicated(self) -> bool:
        return self.kind == "replicated" or (
            self.kind == "tiled" and self.shard_factor == 1)

    def shard_of(self, num_devices: int) -> Optional[Tuple[int, ...]]:
        """device id -> shard index, as a tuple indexed by device id;
        devices in the same replication group share a shard index.
        None when the annotation doesn't describe `num_devices` devices
        (foreign dump) or carries no grid to map."""
        if self.kind == "replicated":
            return tuple(0 for _ in range(num_devices))
        if self.assignment is None or len(self.assignment) != num_devices:
            return None
        out = [0] * num_devices
        rep = max(self.replicate_factor, 1)
        for flat, dev in enumerate(self.assignment):
            if not 0 <= dev < num_devices:
                return None
            out[dev] = flat // rep   # same shard for the rep-group
        return tuple(out)


def _iota_order(dims: Sequence[int], perm: Sequence[int]) -> List[int]:
    """Flat C-order device ids of ``iota(prod(dims)).reshape(dims)
    .transpose(perm)`` — the V2 tile-assignment ``<=[dims]T(perm)``
    encoding, expanded without numpy (lint must not need the runtime
    deps)."""
    strides = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    t_dims = [dims[p] for p in perm]
    t_strides = [strides[p] for p in perm]
    out = []
    for idx in itertools.product(*(range(d) for d in t_dims)):
        out.append(sum(i * s for i, s in zip(idx, t_strides)))
    return out


_TILED_RE = re.compile(
    r"devices=\[([\d,]+)\]"
    r"(?:<=\[([\d,]+)\](?:T\(([\d,]+)\))?|((?:\d+,?)+))")
_LAST_TILE_DIMS_RE = re.compile(r"last_tile_dims=\{([^{}]*)\}")


def parse_sharding(text: Optional[str]) -> Optional[ShardSpec]:
    """Parse one HLO sharding annotation string (either textual form
    prints the same grammar): ``{replicated}``, ``{maximal device=0}``,
    ``{manual}``, V1 explicit device lists ``{devices=[2,2]0,1,2,3}``
    and V2 iota forms ``{devices=[4,1,2]<=[2,4]T(1,0)
    last_tile_dim_replicate}``. None on no/unrecognized annotation
    (size-based rules must skip, not guess)."""
    if not text:
        return None
    body = text.strip()
    # Strip exactly ONE outer brace pair: .strip("{}") would also eat
    # the closing brace of a trailing `last_tile_dims={replicated}`.
    if body.startswith("{") and body.endswith("}"):
        body = body[1:-1].strip()
    if not body:
        return None
    if body.startswith("replicated"):
        return ShardSpec("replicated")
    if body.startswith("maximal"):
        return ShardSpec("maximal")
    if body.startswith("manual"):
        return ShardSpec("manual")
    m = _TILED_RE.search(body)
    if not m:
        return None
    printed = [int(d) for d in m.group(1).split(",") if d]
    if m.group(2):                           # V2 iota [+ transpose]
        reshape = [int(d) for d in m.group(2).split(",") if d]
        perm = ([int(p) for p in m.group(3).split(",") if p]
                if m.group(3) else list(range(len(reshape))))
        if sorted(perm) != list(range(len(reshape))):
            return None
        assignment = _iota_order(reshape, perm)
    else:                                    # V1 explicit device list
        assignment = [int(d) for d in m.group(4).split(",") if d]
    total = 1
    for d in printed:
        total *= d
    if total != len(assignment) or total == 0:
        return None
    # Trailing non-data tile dims: one for last_tile_dim_replicate,
    # len(list) for last_tile_dims={...}; all treated as replication
    # (a manual trailing dim still means "these devices hold the same
    # data-sharded tile").
    trailing = 0
    if "last_tile_dim_replicate" in body:
        trailing = 1
    else:
        lt = _LAST_TILE_DIMS_RE.search(body)
        if lt:
            trailing = len([t for t in lt.group(1).split(",") if t.strip()])
    if trailing >= len(printed):
        return None
    tile_dims = tuple(printed[:len(printed) - trailing])
    rep = 1
    for d in printed[len(printed) - trailing:]:
        rep *= d
    return ShardSpec("tiled", tile_dims, rep, tuple(assignment))


def per_device_bytes(ttype: Optional[TensorType],
                     spec: Optional[ShardSpec],
                     fmt: str) -> Optional[int]:
    """Bytes one device holds for a tensor under `spec`. Post-SPMD HLO
    shapes are already per-device — bytes pass through; StableHLO
    shapes are global and divide by the (ceil-per-dim) tiling."""
    if ttype is None:
        return None
    nb = ttype.nbytes
    if nb is None:
        return None
    if fmt != "stablehlo" or spec is None or spec.kind != "tiled":
        return nb
    itemsize = ttype.itemsize
    elems = 1
    for i, d in enumerate(ttype.dims):
        t = spec.tile_dims[i] if i < len(spec.tile_dims) else 1
        elems *= -(-d // max(t, 1))
    return elems * itemsize


# ----------------------------------------------- annotated tensor sweep

@dataclasses.dataclass(frozen=True)
class AnnotatedTensor:
    """One sharding-annotated value: an entry parameter or an explicit
    constraint (`custom_call @Sharding` / an op-level ``sharding=``)."""

    name: str
    type: Optional[TensorType]
    spec: Optional[ShardSpec]
    line: int
    origin: str                   # "param" | "constraint"


def annotated_tensors(prog: HloProgram) -> List[AnnotatedTensor]:
    out: List[AnnotatedTensor] = []
    for p in prog.entry_params:
        if p.sharding is not None:
            out.append(AnnotatedTensor(p.name, p.type,
                                       parse_sharding(p.sharding),
                                       p.line, "param"))
    for op in prog.ops:
        if op.scope != prog.entry_scope:
            continue
        s = op_sharding(op)
        if s is None:
            continue
        t = (op.result_types[0] if op.result_types else
             (op.operand_types[0] if op.operand_types else None))
        out.append(AnnotatedTensor(op.result or op.opcode, t,
                                   parse_sharding(s), op.line,
                                   "constraint"))
    return out


def partition_classes(tensors: Sequence[AnnotatedTensor],
                      num_devices: int) -> Optional[int]:
    """Number of distinct device classes under the common refinement of
    every tensor's shard partition: two devices in the same class hold
    identical shards of EVERY tensor in `tensors` — paid-for devices
    that add no parallelism. None when any annotation can't be mapped
    onto `num_devices` devices (foreign/partial dump: don't guess)."""
    if num_devices <= 1:
        return None
    keys: List[Tuple] = [() for _ in range(num_devices)]
    for t in tensors:
        if t.spec is None:
            return None
        shard = t.spec.shard_of(num_devices)
        if shard is None:
            return None
        keys = [k + (s,) for k, s in zip(keys, shard)]
    return len(set(keys))


# --------------------------------------- collective provenance (HVD302)

#: jax collective primitive names as they appear as the LAST component
#: of a post-opt ``metadata={op_name="jit(f)/.../psum"}`` path: a
#: collective carrying one of these was asked for by user code; one
#: carrying the op it was inserted FOR (dot_general, gather, ...) — or
#: no metadata at all — came from the SPMD partitioner.
USER_COLLECTIVE_MARKERS = frozenset({
    "psum", "psum_scatter", "pmean", "pmax", "pmin", "all_gather",
    "all_to_all", "ppermute", "pshuffle", "reduce_scatter",
    "all_reduce", "collective_permute",
})

_OP_NAME_RE = re.compile(r'op_name="([^"]*)"')


#: The port's counterpart: a recorded collective's ``op_name`` is the
#: chain of port functions that issued it (``analysis/graph.py``,
#: outermost first, ``<module>.<qualname>`` below the package). One that
#: passed through the port's collective API (a public function of
#: ops/collectives.py) or its differentiable collectives
#: (parallel/comm.py, backward passes included) was asked for; one that
#: did not was issued behind the user's back. The port has no
#: partitioner, so this is HVD302's reading of "inserted" there.
TORCH_USER_MODULES = ("parallel.comm.",)
TORCH_USER_API_MODULE = "ops.collectives."


def _torch_user_frame(frame: str) -> bool:
    if frame.startswith(TORCH_USER_MODULES):
        return True
    if frame.startswith(TORCH_USER_API_MODULE):
        name = frame[len(TORCH_USER_API_MODULE):]
        return not name.startswith("_")
    return False


def traceable_to_user_collective(op: HloOp) -> bool:
    m = _OP_NAME_RE.search(op.attrs)
    if not m:
        return False
    if "recorded=true" in op.attrs:
        return any(_torch_user_frame(f) for f in m.group(1).split("/"))
    last = m.group(1).rsplit("/", 1)[-1]
    last = re.split(r"[\[\s(]", last, 1)[0]
    return last in USER_COLLECTIVE_MARKERS


# ------------------------------------- per-axis comms attribution

#: Collective opcodes whose wire traffic the per-axis attribution
#: accounts (post-SPMD HLO names).
_COMMS_OPCODES = frozenset({
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "collective_permute",
})

_REPLICA_GROUPS_LIST_RE = re.compile(
    r"replica_groups=\{((?:\{[^{}]*\},?)*)\}")
_REPLICA_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_SOURCE_TARGET_RE = re.compile(
    r"source_target_pairs=\{((?:\{[^{}]*\},?)*)\}")


def _parse_replica_groups(attrs: str,
                          num_devices: int) -> Optional[List[List[int]]]:
    """The device-id groups one collective communicates over, from
    either textual form XLA prints: the explicit
    ``replica_groups={{0,1},{2,3}}`` list, the V2 iota
    ``replica_groups=[2,4]<=[8]`` form, or (collective-permute)
    ``source_target_pairs`` — whose connected components are the
    communicating sets. ``replica_groups={}`` / absent means one group
    of every device."""
    m = _REPLICA_GROUPS_IOTA_RE.search(attrs)
    if m:
        printed = [int(d) for d in m.group(1).split(",") if d]
        reshape = [int(d) for d in m.group(2).split(",") if d]
        perm = ([int(p) for p in m.group(3).split(",") if p]
                if m.group(3) else list(range(len(reshape))))
        if sorted(perm) != list(range(len(reshape))):
            return None
        flat = _iota_order(reshape, perm)
        if len(printed) != 2 or printed[0] * printed[1] != len(flat):
            return None
        g = printed[1]
        return [flat[i:i + g] for i in range(0, len(flat), g)]
    m = _REPLICA_GROUPS_LIST_RE.search(attrs)
    if m:
        inner = m.group(1)
        if not inner.strip():
            return [list(range(num_devices))]
        return [[int(x) for x in grp.strip("{}").split(",") if x.strip()]
                for grp in re.findall(r"\{[^{}]*\}", inner)]
    m = _SOURCE_TARGET_RE.search(attrs)
    if m:
        pairs = [tuple(int(x) for x in grp.strip("{}").split(","))
                 for grp in re.findall(r"\{[^{}]*\}", m.group(1))]
        # Union-find over the permute graph: the communicating sets.
        parent = list(range(num_devices))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for s, t in pairs:
            if 0 <= s < num_devices and 0 <= t < num_devices:
                parent[find(s)] = find(t)
        comps: Dict[int, List[int]] = {}
        touched = {d for p in pairs for d in p}
        for d in sorted(touched):
            comps.setdefault(find(d), []).append(d)
        return list(comps.values()) or None
    if "replica_groups" in attrs:
        return None
    return [list(range(num_devices))]


def _axis_partitions(axis_sizes: Sequence[Tuple[str, int]]
                     ) -> Dict[frozenset, str]:
    """Canonical device-id partition -> axis label, for every non-empty
    subset of the size>1 axes. Devices are flat C-order indices over
    `axis_sizes` (outermost first) — exactly `build_mesh`'s device
    order, so flat index == Horovod rank == SPMD partition id."""
    sizes = [s for _, s in axis_sizes]
    names = [a for a, _ in axis_sizes]
    live = [i for i, s in enumerate(sizes) if s > 1]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    out: Dict[frozenset, str] = {}
    for r in range(1, len(live) + 1):
        for subset in itertools.combinations(live, r):
            moving = list(subset)
            fixed = [i for i in range(len(sizes)) if i not in subset]
            groups = []
            for fcoord in itertools.product(
                    *(range(sizes[i]) for i in fixed)):
                base = sum(c * strides[i]
                           for c, i in zip(fcoord, fixed))
                groups.append(frozenset(
                    base + sum(c * strides[i]
                               for c, i in zip(mcoord, moving))
                    for mcoord in itertools.product(
                        *(range(sizes[i]) for i in moving))))
            label = "+".join(names[i] for i in moving)
            out[frozenset(groups)] = label
    return out


def group_axis_label(groups: Optional[List[List[int]]],
                     partitions: Dict[frozenset, str]) -> Optional[str]:
    """Mesh-axis label one collective's parsed replica groups span — the
    ONE group-classification helper shared by :func:`comms_by_axis` and
    the hvdsched cost model (analysis/schedule.comms_model), so the two
    attributions can never disagree on what a group means.

    ``None`` means every group is a *degenerate single-device set*
    (size-1 groups from a size-1 mesh axis): no wire traffic moves, the
    caller must skip the op — distinct from ``replica_groups={}``,
    which parses to one full-mesh group upstream. Unparseable groups
    (``groups is None``) and real groups matching no axis partition
    land under ``"other"``.
    """
    if groups is None:
        return "other"
    norm = frozenset(frozenset(g) for g in groups if len(g) > 1)
    if not norm:
        return None  # degenerate single-device groups: no wire
    return partitions.get(norm, "other")


def comms_by_axis(text: str, axis_sizes: Sequence[Tuple[str, int]],
                  path: str = "<compiled>") -> Dict[str, Dict[str, object]]:
    """Attribute every collective's payload bytes in a post-SPMD module
    to the mesh axis (or axis combination) its replica groups span —
    the static dp-vs-tp wire-traffic split of the hybrid backend
    (docs/parallelism.md; the perfscope/bench ``comms_by_axis`` stamp).

    `axis_sizes`: ordered (axis, size) pairs outermost-first — i.e.
    ``zip(AXIS_ORDER, MeshSpec.sizes())``. Groups that match no single
    axis partition land under the joined label ("dp+tp" = a collective
    over the whole mesh); unclassifiable groups land under "other".
    Returns ``{label: {"bytes_per_step", "ops", "by_op"}}``.
    """
    prog = parse(text, path)
    ndev = 1
    for _, s in axis_sizes:
        ndev *= s
    partitions = _axis_partitions(axis_sizes)
    # Singleton groups (a one-device "collective") carry no traffic.
    out: Dict[str, Dict[str, object]] = {}
    from horovod_tpu_torch.analysis import hlo_rules
    for op in prog.ops:
        if op.opcode not in _COMMS_OPCODES:
            continue
        groups = _parse_replica_groups(op.attrs, ndev)
        label = group_axis_label(groups, partitions)
        if label is None:
            continue  # degenerate single-device groups: no wire
        nb = hlo_rules._collective_payload(op)
        if nb is None:
            nb = _result_bytes(op)
        ent = out.setdefault(label, {"bytes_per_step": 0, "ops": 0,
                                     "by_op": {}})
        ent["bytes_per_step"] += int(nb or 0)
        ent["ops"] += 1
        by = ent["by_op"]
        by[op.opcode] = by.get(op.opcode, 0) + int(nb or 0)
    return out


# ------------------------------------------- per-device peak-HBM model

#: Result-aliases-operand opcodes: no new buffer is materialized.
_ALIAS_OPCODES = {"bitcast", "get_tuple_element", "tuple"}
#: A recorded op whose result is a view or an in-place update of its
#: first operand (analysis/graph.py) materializes nothing either.
ALIAS_ATTR = "alias=operand0"


def _is_alias(op: HloOp) -> bool:
    return op.opcode in _ALIAS_OPCODES or ALIAS_ATTR in op.attrs

_CALLEE_RE = re.compile(
    r"(?:to_apply|calls|body|condition)=(%[\w.-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^{}]*)\}")


@dataclasses.dataclass
class MemoryEstimate:
    """Static per-device peak-HBM estimate of one post-SPMD module."""

    peak_bytes: int
    peak_line: int
    args_bytes: int               # entry parameter buffers
    donated_bytes: int            # of which donated (reusable)
    out_bytes: int                # root/result buffers
    num_partitions: int
    #: largest live buffers at the peak program point, for messages
    top: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, object]:
        return {"peak_bytes": self.peak_bytes,
                "peak_mb": round(self.peak_bytes / _MB, 2),
                "args_bytes": self.args_bytes,
                "donated_bytes": self.donated_bytes,
                "out_bytes": self.out_bytes,
                "num_partitions": self.num_partitions,
                "top_live": [
                    {"buffer": n, "mb": round(b / _MB, 2)}
                    for n, b in self.top]}


def _result_bytes(op: HloOp) -> int:
    total = 0
    for t in op.result_types:
        if t is not None and t.nbytes is not None:
            total += t.nbytes
    return total


def _callees(op: HloOp) -> List[str]:
    names = [m.group(1) for m in _CALLEE_RE.finditer(op.attrs)]
    bm = _BRANCHES_RE.search(op.attrs)
    if bm:
        names.extend(t.strip() for t in bm.group(1).split(",")
                     if t.strip())
    return names


class _PeakWalker:
    """Donation-aware liveness over the post-opt (scheduled) printed
    instruction order. The model errs structural, not optimistic:

    * every op result materializes its full result bytes (except the
      alias opcodes and ``fusion``/``call``-wrapped fusions, whose
      interiors never hit HBM — that is what fusion means);
    * operands die at their last textual use; donated entry parameters
      die like temps (XLA reuses the buffer), undonated ones live to
      the end next to the outputs — the exact cost HVD203 describes;
    * a ``while``/``call``/conditional adds its callee's *interior*
      peak (params and root excluded — those alias the caller's
      buffers, already counted) on top of the caller's live set.
    """

    def __init__(self, prog: HloProgram) -> None:
        self.prog = prog
        self.by_scope: Dict[str, List[HloOp]] = {}
        for op in prog.ops:
            self.by_scope.setdefault(op.scope, []).append(op)
        self._interior: Dict[str, int] = {}
        self._visiting: Set[str] = set()

    def _interior_of(self, scope: str) -> int:
        if scope in self._interior:
            return self._interior[scope]
        if scope in self._visiting or scope not in self.by_scope:
            return 0
        self._visiting.add(scope)
        peak, _, root, _ = self._walk(scope, count_params=False)
        self._visiting.discard(scope)
        interior = max(0, peak - root)
        self._interior[scope] = interior
        return interior

    def _walk(self, scope: str, count_params: bool
              ) -> Tuple[int, int, int, Dict[str, int]]:
        """(peak bytes, peak line, root result bytes, live-at-peak
        snapshot) for one scope."""
        ops = self.by_scope.get(scope, [])
        params = {p.name: p for p in self.prog.params
                  if p.scope == scope}
        # Alias chains first (aliases are defined before their uses in
        # SSA order), so liveness is keyed on CANONICAL buffers — a
        # bitcast's last use must not free the underlying buffer while
        # the original name is still consumed later, and vice versa.
        # get-tuple-element resolves to the tupled ELEMENT when the
        # tuple is scope-local (a tuple aliases ALL its operands, not
        # just the first).
        root_of: Dict[str, str] = {}

        def root(name: str) -> str:
            seen = set()
            while name in root_of and name not in seen:
                seen.add(name)
                name = root_of[name]
            return name

        defs = {op.result: op for op in ops if op.result}
        for op in ops:
            if not op.result or not op.operands:
                continue
            if op.opcode == "bitcast" or ALIAS_ATTR in op.attrs:
                root_of[op.result] = op.operands[0]
            elif op.opcode == "get_tuple_element":
                d = defs.get(op.operands[0])
                im = re.search(r"index=(\d+)", op.attrs)
                idx = int(im.group(1)) if im else None
                if d is not None and d.opcode == "tuple" \
                        and idx is not None and idx < len(d.operands):
                    root_of[op.result] = d.operands[idx]
                else:
                    root_of[op.result] = op.operands[0]
        last_use: Dict[str, int] = {}
        for i, op in enumerate(ops):
            for o in op.operands:
                last_use[root(o)] = i
        # A live tuple keeps EVERY element alive: extend each element's
        # lifetime to the tuple's own last use (a gte at index i would
        # otherwise let the tuple op count as element i+1's last use
        # and free a buffer still reachable through the tuple).
        for op in ops:
            if op.opcode != "tuple" or not op.result:
                continue
            tl = last_use.get(op.result)
            if tl is None:
                continue
            for o in op.operands:
                r = root(o)
                last_use[r] = max(last_use.get(r, -1), tl)
        live: Dict[str, int] = {}
        if count_params:
            for p in params.values():
                nb = p.type.nbytes if p.type is not None else None
                live[p.name] = nb or 0
        peak = sum(live.values())
        peak_line = ops[0].line if ops else 0
        snapshot: Dict[str, int] = dict(live)
        for i, op in enumerate(ops):
            if op.opcode == "parameter":
                continue  # accounted above (or free in interior scopes)
            rb = 0 if _is_alias(op) else _result_bytes(op)
            interior = 0
            if op.opcode not in ("fusion",):
                for callee in _callees(op):
                    # fusion computations reached through the CPU
                    # backend's parallel-call wrappers recurse to ~0
                    interior = max(interior, self._interior_of(callee))
            here = sum(live.values()) + rb + interior
            if here > peak:
                peak = here
                peak_line = op.line
                snapshot = dict(live)
                if rb and op.result:
                    snapshot[op.result] = rb
            if rb and op.result:
                live[op.result] = rb
            # free buffers whose last use was this op
            for o in op.operands:
                r = root(o)
                if last_use.get(r) != i:
                    continue
                if r in params:
                    p = params[r]
                    if not count_params or not p.donated:
                        continue  # undonated args live to program end
                live.pop(r, None)
            if op.result and root(op.result) not in last_use \
                    and not _is_alias(op) \
                    and i < len(ops) - 1:
                live.pop(op.result, None)  # unused result: short-lived
        root_bytes = 0
        if ops:
            last = ops[-1]
            root_bytes = 0 if _is_alias(last) else _result_bytes(last)
        return peak, peak_line, root_bytes, snapshot

    def estimate(self) -> Optional[MemoryEstimate]:
        scope = self.prog.entry_scope
        if scope not in self.by_scope:
            return None
        peak, line, root_bytes, snapshot = self._walk(
            scope, count_params=True)
        args = donated = 0
        for p in self.prog.entry_params:
            nb = p.type.nbytes if p.type is not None else None
            args += nb or 0
            if p.donated:
                donated += nb or 0
        top = sorted(snapshot.items(), key=lambda kv: -kv[1])[:3]
        return MemoryEstimate(peak, line, args, donated, root_bytes,
                              self.prog.num_partitions, top)


def peak_memory(prog: HloProgram) -> Optional[MemoryEstimate]:
    """Static per-device peak-memory estimate. Only meaningful on the
    per-device forms (post-SPMD HLO, a recorded step: per-device shapes,
    scheduled order); None on StableHLO input or an empty module."""
    if not prog.per_device:
        return None
    return _PeakWalker(prog).estimate()


def estimate_compiled_text(text: str) -> Optional[MemoryEstimate]:
    """Convenience for bench/serve stamping: parse + estimate one
    ``compiled.as_text()`` dump."""
    try:
        return peak_memory(parse(text, "<compiled>"))
    except Exception:
        return None


# ------------------------------------------------------------- linting

def registry() -> Dict[str, Tuple[str, object]]:
    from horovod_tpu_torch.analysis import shard_rules
    return dict(shard_rules.RULES)


def lint_text(text: str, path: str = "<hlo>",
              select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> List[Finding]:
    """Run the HVD3xx sharding rules over one lowered module's text
    (either form; each rule self-selects the form it can judge)."""
    prog = parse(text, path)
    return lint_program(prog, select=select, ignore=ignore)


def lint_program(prog: HloProgram,
                 select: Optional[Sequence[str]] = None,
                 ignore: Sequence[str] = ()) -> List[Finding]:
    out = run_rules(registry(), prog, select, ignore)
    out.sort(key=lambda f: (f.line, f.rule_id))
    return out


def lint_files(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = ()) -> List[Finding]:
    findings, progs = read_files(paths, parse)
    for prog in progs:
        findings.extend(lint_program(prog, select=select, ignore=ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def record_metrics(findings: Sequence[Finding]) -> None:
    """hvdshard_findings_total{rule}."""
    counter_metrics("hvdshard_findings_total", "hvdshard findings by rule",
                    findings)




# ---------------------------------------- canonical dp x tp step record

#: The mesh the sharded step programs are recorded on: dp = 2 x tp = 2,
#: a gloo world of four on the host (the JAX programs lower on
#: dp = 2 x tp = 4 over eight virtual devices).
SHARDED_MESH = "dp=2,tp=2"


def replicated_twin_forced() -> bool:
    """HOROVOD_SHARD_LINT_REPLICATED=1: record `lm_sharded`/`lm_runtime`
    with every parameter fully replicated — the twin that must trip
    HVD301 on the tied LM's tables."""
    from horovod_tpu_torch.common.config import _env_bool
    return _env_bool("HOROVOD_SHARD_LINT_REPLICATED")


def record_rank_program(kind: str, replicated: Optional[bool] = None
                        ) -> HloProgram:
    """This rank's recorded program of the canonical tied-LM dp x tp step
    (counterpart of the JAX `lower_sharded_step_texts` and
    `lower_runtime_step_texts`), in the world already joined with its
    hybrid mesh in force (HOROVOD_MESH).

    The port has one sharded step, DistributedOptimizer(sharding_spec=
    ...).sharded_step over `models/tied_lm.local_loss` (vocab-parallel
    embedding, column/row-parallel FFN, SGD at 0.01), on the canonical
    shapes (a 16 MB f32 embedding, batch 16 x 64). `lm_sharded` builds
    it through `build_sharded_train_step` (the functional API, the
    counterpart of the annotation-driven GSPMD program), `lm_runtime`
    through the optimizer's own `sharded_step`. Each entry parameter
    carries the sharding its spec gives it on the mesh
    (graph.sharding_annotation). The replicated twin (`replicated=True`
    or HOROVOD_SHARD_LINT_REPLICATED=1) stores and steps every
    parameter whole, which trips HVD301 on every table >= 4 MB. The
    JAX GSPMD twin also trips HVD302 on the all-gather its partitioner
    inserts; the port has no partitioner, so its twin does not."""
    import torch

    from horovod_tpu_torch.analysis import graph
    from horovod_tpu_torch.analysis.hlo import step_path
    from horovod_tpu_torch.core import topology
    from horovod_tpu_torch.models import tied_lm
    from horovod_tpu_torch.optim.optimizer import (
        DistributedOptimizer, build_sharded_train_step)
    from horovod_tpu_torch.parallel import mesh as mesh_mod

    if kind not in ("lm_sharded", "lm_runtime"):
        raise ValueError(f"unknown sharded step program {kind!r}")
    if replicated is None:
        replicated = replicated_twin_forced()
    mesh = mesh_mod.current_mesh()
    if mesh is None:
        raise ValueError(f"the {kind} step needs a hybrid mesh: set "
                         f"HOROVOD_MESH={SHARDED_MESH!r}")
    cfg = tied_lm.canonical_config()
    specs = (tied_lm.replicated_specs(cfg) if replicated
             else tied_lm.param_specs(cfg))
    dev = topology.device()
    sizes = mesh_mod.mesh_axis_sizes(mesh)
    with mesh_mod.use_mesh(mesh):
        shards = {n: torch.nn.Parameter(mesh_mod.shard_of(v, specs[n]))
                  for n, v in tied_lm.init(0, cfg, dev).items()}
        batch = tuple(mesh_mod.shard_of(a, ("dp",)) for a in
                      tied_lm.sample_batch(0, cfg, batch=16, seq=64,
                                           device=dev))
    inner = torch.optim.SGD(list(shards.values()), lr=0.01)

    def loss_fn(p, b):
        return tied_lm.local_loss(p, b[0], b[1], cfg)

    if kind == "lm_sharded":
        step = build_sharded_train_step(loss_fn, inner, list(shards.items()),
                                        mesh=mesh, param_specs=specs)
    else:
        opt = DistributedOptimizer(inner, named_parameters=list(
            shards.items()), sharding_spec=specs, mesh=mesh)
        step = opt.sharded_step(loss_fn)
    world = topology.size()
    entries = [(t, graph.sharding_annotation(specs[n], sizes, world))
               for n, t in shards.items()]
    entries += [(t, None) for t in batch]
    rank = topology.rank()
    _, prog = graph.record(step, batch,
                           path=f"{step_path(kind)[:-1]}:rank{rank}>",
                           entries=entries)
    return prog


#: Seconds the ranks of `record_sharded_programs` get, together.
RECORD_TIMEOUT = 180.0


def _rank_main(kind: str, rank: int, world: int, store: str,
               out: str) -> None:
    """One rank of `record_sharded_programs`: join, record, pickle."""
    import pickle

    os.environ.update({"HOROVOD_RANK": str(rank),
                       "HOROVOD_SIZE": str(world),
                       "HOROVOD_LOCAL_RANK": str(rank),
                       "HOROVOD_LOCAL_SIZE": str(world),
                       "HOROVOD_MESH": SHARDED_MESH})
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", init_method=f"file://{store}")
    try:
        prog = record_rank_program(kind)
    finally:
        hvd.shutdown()
    with open(out, "wb") as fh:
        pickle.dump(prog, fh)


def record_sharded_programs(kind: str) -> List[HloProgram]:
    """Every rank's program of the `kind` step, recorded in a spawned
    gloo world of SHARDED_MESH's ranks on the host (the CLI's
    --hlo-step lm_sharded / lm_runtime). A rank that fails or outlives
    RECORD_TIMEOUT fails the whole call."""
    import multiprocessing as mp
    import pickle
    import tempfile
    import time

    world = math.prod(int(part.split("=")[1])
                      for part in SHARDED_MESH.split(","))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        outs = [os.path.join(d, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, args=(
            kind, r, world, os.path.join(d, "store"), outs[r]))
            for r in range(world)]
        for p in procs:
            p.start()
        end = time.time() + RECORD_TIMEOUT
        for p in procs:
            p.join(max(0.0, end - time.time()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"recording the {kind} step failed: rank "
                               f"exit codes {codes}")
        progs = []
        for path in outs:
            with open(path, "rb") as fh:
                progs.append(pickle.load(fh))
    return progs
