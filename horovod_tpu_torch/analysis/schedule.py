"""hvdsched: static cross-device collective-schedule verification and
the analytic comms cost model (HVD4xx; counterpart of
horovod_tpu/analysis/schedule.py).

The runtime fingerprint verifier (analysis/verifier.py) catches a
collective-order divergence only live, once every rank already waits
inside the mismatched collective. hvdsched proves the same property
before anything runs: it reconstructs each device's collective schedule
from a program — every all-reduce / all-gather / reduce-scatter /
all-to-all / collective-permute / broadcast / send / recv with its
replica groups (explicit list, V2 iota, permute source-target pairs),
channel id and payload bytes, in scheduled order — and checks that
every member of every replica group reaches the same collectives in the
same order (analysis/sched_rules.py). A lowered SPMD module is one
program for every device; a recorded torch step (analysis/graph.py) is
one rank's program, so the ranks' programs of one step are linted as
one set, the "MPMD pair" case of the cross-program rules.

On the same event stream sits the analytic comms cost model: ring time
= wire_bytes / link GB/s with the standard wire factors — 2(k-1)/k for
all-reduce, (k-1)/k for all-gather / reduce-scatter / all-to-all, one
hop for permute/send/recv — over a two-tier link table: within one
machine ("ici") and between machines ("dcn"), the boundary declared by
``HOROVOD_MESH_SLICES`` (parallel/mesh.slice_groups). The constants are
documented fallbacks (`ICI_LINK_GBPS`, `DCN_LINK_GBPS`), overridable
through ``HOROVOD_SCHED_LINK_GBPS``, with a loud ValueError on garbage.
Both attributions share one group classifier (shard.group_axis_label).

Findings are baselined (``analysis/hvdsched_baseline.json``), not
suppressed inline.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis.hlo import (
    HloProgram, counter_metrics, parse, read_files, run_rules,
)
from horovod_tpu_torch.analysis.shard import (
    _SOURCE_TARGET_RE,
    _axis_partitions,
    _bytes_env,
    _parse_replica_groups,
    group_axis_label,
)

_MB = 1024 * 1024

#: Opcodes that participate in the cross-device schedule. Async pairs
#: fold onto their ``*_start`` half (the issue point in the schedule);
#: the ``*_done`` halves are dropped.
SCHED_OPCODES = frozenset({
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "collective_permute", "send", "recv", "collective_broadcast",
})

_ASYNC_START = re.compile(r"^(.*)_start$")
_ASYNC_DONE = re.compile(r"^(.*)_done$")

# StableHLO attribute forms (post-SPMD HLO text forms are delegated to
# shard._parse_replica_groups / _SOURCE_TARGET_RE — one parser, not two).
_DENSE_GROUPS_RE = re.compile(r"replica_groups\s*=\s*dense<([^>]*)>")
_DENSE_PAIRS_RE = re.compile(r"source_target_pairs\s*=\s*dense<([^>]*)>")
_CHANNEL_MLIR_RE = re.compile(
    r"channel_handle\s*=\s*#stablehlo\.channel_handle<\s*handle\s*=\s*(\d+)")
_CHANNEL_HLO_RE = re.compile(r"channel_id=(\d+)")
_P2P_BATCH_RE = re.compile(r"p2p_batch=(\d+)")


def _parse_dense_rows(body: str) -> Optional[List[List[int]]]:
    """Rows of a 2-D ``dense<[[0, 1], [2, 3]]>`` literal (or a splat
    ``dense<0>``), as lists of ints; None when unparseable."""
    body = body.strip()
    if body.startswith("[["):
        rows = re.findall(r"\[([\d,\s-]*)\]", body[1:-1])
        out = []
        for row in rows:
            cells = [c for c in row.replace(" ", "").split(",") if c]
            out.append([int(c) for c in cells])
        return out
    if re.fullmatch(r"-?\d+", body):
        return [[int(body)]]
    return None


# -------------------------------------------------- the event stream

@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One scheduled collective, as every participating device sees it."""

    line: int
    opcode: str                              # canonical (start/done folded)
    groups: Tuple[Tuple[int, ...], ...]      # sorted device-id groups
    pairs: Optional[Tuple[Tuple[int, int], ...]]  # permute (src, tgt)
    channel_id: Optional[int]
    nbytes: int                              # payload (pre-wire-factor)
    path: str
    #: "send" / "recv" for one end of a recorded point-to-point transfer
    #: (a one-pair permute as one rank sees it), else None.
    p2p: Optional[str] = None
    #: The batch a recorded end was posted in (one batch_isend_irecv):
    #: the ends of one batch have no order among themselves.
    batch: Optional[int] = None

    @property
    def signature(self) -> Tuple:
        """What must match across devices for the schedule to agree:
        (opcode, replica groups, payload bytes). Channel ids are
        assigned per-lowering and line numbers per-program, so neither
        participates."""
        return (self.opcode, self.groups, self.nbytes)

    def involves(self, device: int) -> bool:
        return any(device in g for g in self.groups)

    def describe(self) -> str:
        gtxt = ",".join("[" + ",".join(str(d) for d in g) + "]"
                        for g in self.groups[:4])
        if len(self.groups) > 4:
            gtxt += ",..."
        ch = f", ch={self.channel_id}" if self.channel_id is not None else ""
        return (f"{self.opcode}({self.nbytes / _MB:.2f} MB, "
                f"groups={gtxt}{ch})")


def _event_pairs(attrs: str) -> Optional[Tuple[Tuple[int, int], ...]]:
    m = _DENSE_PAIRS_RE.search(attrs)
    if m:
        rows = _parse_dense_rows(m.group(1))
        if rows:
            return tuple((r[0], r[1]) for r in rows if len(r) >= 2)
    m = _SOURCE_TARGET_RE.search(attrs)
    if m:
        pairs = []
        for grp in re.findall(r"\{[^{}]*\}", m.group(1)):
            cells = [int(x) for x in grp.strip("{}").split(",") if x.strip()]
            if len(cells) >= 2:
                pairs.append((cells[0], cells[1]))
        return tuple(pairs) or None
    return None


def _event_groups(attrs: str,
                  pairs: Optional[Tuple[Tuple[int, int], ...]],
                  num_devices: int) -> Optional[List[List[int]]]:
    m = _DENSE_GROUPS_RE.search(attrs)
    if m:
        return _parse_dense_rows(m.group(1))
    if pairs:
        # Connected components of the permute graph, via the shared
        # HLO-text parser (it already union-finds source_target_pairs).
        fake = ("source_target_pairs={" +
                ",".join("{%d,%d}" % p for p in pairs) + "}")
        return _parse_replica_groups(fake, num_devices)
    return _parse_replica_groups(attrs, num_devices)


def _explicit_ids(attrs: str) -> Iterable[int]:
    """Every device id named literally in a collective's group/pair
    attributes — the first pass that sizes the device space before
    full-mesh ``replica_groups={}`` groups can be expanded."""
    for rx in (_DENSE_GROUPS_RE, _DENSE_PAIRS_RE):
        m = rx.search(attrs)
        if m:
            for row in _parse_dense_rows(m.group(1)) or []:
                for d in row:
                    yield d
    for rx in (_SOURCE_TARGET_RE,):
        m = rx.search(attrs)
        if m:
            for cell in re.findall(r"\d+", m.group(1)):
                yield int(cell)
    m = re.search(r"replica_groups=\{((?:\{[^{}]*\},?)+)\}", attrs)
    if m:
        for cell in re.findall(r"\d+", m.group(1)):
            yield int(cell)


def _canonical_opcode(opcode: str) -> Optional[str]:
    """Fold async halves onto the issue point; None for opcodes
    outside the schedule (incl. every ``*_done`` completion)."""
    if _ASYNC_DONE.match(opcode):
        return None
    m = _ASYNC_START.match(opcode)
    if m and m.group(1) in SCHED_OPCODES:
        return m.group(1)
    return opcode if opcode in SCHED_OPCODES else None


class ProgramSchedule:
    """The per-device collective schedule of one program: events in
    printed (scheduled) order; a device's schedule is its
    involvement-filtered projection. A recorded torch step is ONE
    rank's schedule (the MPMD case: one program per device), so its
    only device is that rank, and the two ends of a point-to-point
    transfer fold onto one one-pair ``collective_permute`` signature
    that the sender's and the receiver's programs both carry."""

    def __init__(self, prog: HloProgram):
        self.prog = prog
        self.path = prog.path
        ops = [(op, _canonical_opcode(op.opcode)) for op in prog.ops]
        ops = [(op, canon) for op, canon in ops if canon is not None]
        ndev = max(prog.num_partitions or 0, 1)
        for op, _ in ops:
            for d in _explicit_ids(op.attrs):
                ndev = max(ndev, d + 1)
        self.num_devices = ndev
        from horovod_tpu_torch.analysis import hlo_rules
        events: List[CollectiveEvent] = []
        for op, canon in ops:
            pairs = (_event_pairs(op.attrs)
                     if canon in ("collective_permute", "send", "recv")
                     else None)
            groups = _event_groups(op.attrs, pairs, ndev)
            nb = hlo_rules._collective_payload(op) or 0
            gt = (tuple(tuple(sorted(g)) for g in groups)
                  if groups is not None else ())
            ch = None
            m = (_CHANNEL_MLIR_RE.search(op.attrs)
                 or _CHANNEL_HLO_RE.search(op.attrs))
            if m:
                ch = int(m.group(1))
            p2p = batch = None
            if prog.rank is not None and canon in ("send", "recv"):
                p2p, canon = canon, "collective_permute"
                bm = _P2P_BATCH_RE.search(op.attrs)
                batch = int(bm.group(1)) if bm else None
            events.append(CollectiveEvent(
                line=op.line, opcode=canon, groups=gt, pairs=pairs,
                channel_id=ch, nbytes=int(nb), path=self.path, p2p=p2p,
                batch=batch))
        self.events = events

    @property
    def devices(self) -> List[int]:
        if self.prog.rank is not None:
            return [self.prog.rank]
        return sorted({d for e in self.events for g in e.groups for d in g})

    def device_events(self, device: int) -> List[CollectiveEvent]:
        return [e for e in self.events if e.involves(device)]


@dataclasses.dataclass
class ScheduleSet:
    """All programs linted together — the unit the cross-program rules
    (HVD401/HVD403) see. One SPMD program is internally consistent by
    construction; divergence needs two independently-authored programs
    (e.g. a hand-split MPMD pipeline, one module per stage group)."""

    schedules: List[ProgramSchedule]


def parse_schedule(text: str, path: str = "<hlo>") -> ProgramSchedule:
    return ProgramSchedule(parse(text, path))


# ------------------------------------------- analytic ICI/DCN cost model

#: The port's two tiers, GB/s per device, keeping the JAX package's
#: names: "ici" is within one machine, "dcn" between machines (the
#: boundary is HOROVOD_MESH_SLICES, one slice per machine).
#: ICI: the lowest bus bandwidth of the port's own all-reduce on four
#: NVLink-joined NVIDIA H100 80GB HBM3 cards (collective_bench.py,
#: 25,557,032 bf16 values: 209.3-252.7 bus GB/s, chip_smoke.py phase
#: 7; PERF.md section 5). Bus bandwidth is payload x 2(k-1)/k over the
#: time, the wire factor this model applies, so the two compare
#: directly.
#: DCN: an ASSUMPTION, not measured (no machine here has a second
#: host): one 400 Gb/s NDR InfiniBand port per card, 50 GB/s, of which
#: ~90% is usable.
#: HOROVOD_SCHED_LINK_GBPS="ici=90,dcn=12.5" sets the JAX package's
#: TPU table; any deployment can set its own.
ICI_LINK_GBPS = 209.3
DCN_LINK_GBPS = 45.0

_LINK_ENV = "HOROVOD_SCHED_LINK_GBPS"
_LINK_ENTRY_RE = re.compile(r"(ici|dcn)\s*=\s*(\d+(?:\.\d+)?)")


class _LinkTableCache:
    """Process-wide cache of parsed HOROVOD_SCHED_LINK_GBPS tables,
    keyed by the raw env string (bench workers and concurrent lint
    threads share one parse per distinct value). Instrumented by
    hvdrace (race.DEFAULT_MODULES)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tables: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock

    def get(self, raw: str) -> Optional[Dict[str, float]]:
        with self._lock:
            hit = self._tables.get(raw)
            return dict(hit) if hit is not None else None

    def put(self, raw: str, table: Dict[str, float]) -> None:
        with self._lock:
            self._tables[raw] = dict(table)


_link_cache = _LinkTableCache()


def link_gbps() -> Dict[str, float]:
    """The two-tier link table ``{"ici": GB/s, "dcn": GB/s}``.

    Env grammar: comma-separated ``tier=GB/s`` entries, either tier
    optional (``HOROVOD_SCHED_LINK_GBPS="dcn=25"`` overrides only the
    DCN tier). Malformed input raises ValueError — the `_bytes_env`
    lesson: a mistyped knob must fail the lint loudly, never silently
    revert to defaults.
    """
    raw = os.environ.get(_LINK_ENV, "").strip()
    hit = _link_cache.get(raw)
    if hit is not None:
        return hit
    table = {"ici": ICI_LINK_GBPS, "dcn": DCN_LINK_GBPS}
    if raw:
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            m = _LINK_ENTRY_RE.fullmatch(part)
            if not m or float(m.group(2)) <= 0:
                raise ValueError(
                    f"{_LINK_ENV}={raw!r}: expected comma-separated "
                    f"tier=GB/s entries with tier in (ici, dcn) and a "
                    f"positive value, e.g. 'ici=209.3,dcn=45'; bad "
                    f"entry {part!r}")
            table[m.group(1)] = float(m.group(2))
    _link_cache.put(raw, table)
    return table


_SLICES_ENV = "HOROVOD_MESH_SLICES"


def declared_slices() -> Optional[int]:
    """The declared hierarchical-mesh slice count (None = flat mesh,
    HVD404 unarmed and everything rides the ICI tier). Malformed input
    raises ValueError (loud-knob policy)."""
    raw = os.environ.get(_SLICES_ENV, "").strip()
    if not raw:
        return None
    if not re.fullmatch(r"\d+", raw) or int(raw) < 1:
        raise ValueError(
            f"{_SLICES_ENV}={raw!r}: expected a positive integer "
            f"slice count (contiguous equal slices of the flat rank "
            f"space; parallel/mesh.slice_groups)")
    return int(raw)


def wire_factor(opcode: str, k: int) -> float:
    """Bytes-on-the-wire multiple of the payload for one collective
    over a k-member ring: all-reduce moves 2(k-1)/k (reduce-scatter +
    all-gather halves), gather/scatter/all-to-all move (k-1)/k, a
    permute / send / recv is one hop."""
    if k <= 1:
        return 0.0
    if opcode == "all_reduce":
        return 2.0 * (k - 1) / k
    if opcode in ("all_gather", "reduce_scatter", "all_to_all"):
        return (k - 1) / k
    return 1.0


def group_tier(group: Sequence[int], slices: Optional[int],
               num_devices: int) -> str:
    """"dcn" when the group crosses a declared slice boundary (the
    whole collective then moves at the slowest member link), else
    "ici". Slice of rank d = d // (num_devices // slices), matching
    parallel/mesh.slice_groups."""
    if not slices or slices <= 1 or num_devices % slices:
        return "ici"
    per = num_devices // slices
    return "dcn" if len({d // per for d in group}) > 1 else "ici"


@dataclasses.dataclass(frozen=True)
class EventCost:
    tier: str            # "ici" | "dcn"
    wire_bytes: int      # payload x wire_factor
    seconds: float


def event_cost(ev: CollectiveEvent, num_devices: int,
               slices: Optional[int] = None,
               table: Optional[Dict[str, float]] = None) -> EventCost:
    """Analytic time of one collective: ring time = wire bytes over
    the slowest tier any of its groups touches."""
    if table is None:
        table = link_gbps()
    k = max((len(g) for g in ev.groups), default=1)
    wire = int(ev.nbytes * wire_factor(ev.opcode, k))
    tier = "ici"
    for g in ev.groups:
        if len(g) > 1 and group_tier(g, slices, num_devices) == "dcn":
            tier = "dcn"
            break
    sec = wire / (table[tier] * 1e9) if wire else 0.0
    return EventCost(tier=tier, wire_bytes=wire, seconds=sec)


def comms_model(text: str, axis_sizes: Sequence[Tuple[str, int]],
                path: str = "<compiled>",
                slices: Optional[int] = None) -> Dict[str, object]:
    """The bench ``comms_model`` stamp: predicted per-axis wire bytes
    and time from the analytic model, off the SAME compiled text the
    measured ``comms_by_axis`` reads, classified by the SAME
    shard.group_axis_label helper — so predicted_vs_measured compares
    the wire-factor model against the payload accounting and nothing
    else (docs/perf.md).
    """
    sched = parse_schedule(text, path)
    if slices is None:
        slices = declared_slices()
    table = link_gbps()
    partitions = _axis_partitions(axis_sizes)
    ndev = 1
    for _, s in axis_sizes:
        ndev *= s
    per_axis: Dict[str, Dict[str, object]] = {}
    payload_total = 0
    wire_total = 0
    time_total = 0.0
    for ev in sched.events:
        groups = [list(g) for g in ev.groups] if ev.groups else None
        label = group_axis_label(groups, partitions)
        if label is None:
            continue  # degenerate single-device groups: no wire
        cost = event_cost(ev, ndev, slices, table)
        ent = per_axis.setdefault(label, {
            "bytes_per_step": 0, "wire_bytes_per_step": 0,
            "predicted_s": 0.0, "ops": 0, "tier": "ici"})
        ent["bytes_per_step"] += ev.nbytes
        ent["wire_bytes_per_step"] += cost.wire_bytes
        ent["predicted_s"] += cost.seconds
        ent["ops"] += 1
        if cost.tier == "dcn":
            ent["tier"] = "dcn"
        payload_total += ev.nbytes
        wire_total += cost.wire_bytes
        time_total += cost.seconds
    return {
        "link_gbps": table,
        "slices": slices,
        "per_axis": per_axis,
        "payload_bytes_per_step": payload_total,
        "predicted_bytes_per_step": wire_total,
        "predicted_total_s": time_total,
    }


# -------------------------------- the overlappable backward window

_WINDOW_ENV = "HOROVOD_SCHED_OVERLAP_WINDOW_MS"
_PEAK_ENV = "HOROVOD_SCHED_PEAK_TFLOPS"
_FRACTION_ENV = "HOROVOD_SCHED_OVERLAP_FRACTION"

#: Backward share of step compute — the window gradient collectives
#: can hide inside (fwd recompute excluded). The classic 2/3 of the
#: 3x-forward-FLOPs training step; documented fallback, env override.
DEFAULT_OVERLAP_FRACTION = 0.67


def _float_env(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r}: expected a number") from None
    if val <= 0:
        raise ValueError(f"{name}={raw!r}: expected a positive number")
    return val


_MLIR_CONTRACT_RE = re.compile(
    r"contracting_dims\s*=\s*\[([\d, ]*)\]\s*x\s*\[([\d, ]*)\]")
_HLO_LHS_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def dot_flops(prog: HloProgram) -> int:
    """Total dot/dot_general FLOPs of one program: 2 x output elems x
    contracted extent per dot (contracting dims parsed the same way
    hvdhlo's lane-padding rule does). Convolutions are not counted —
    the estimate is deliberately a floor."""
    total = 0
    for op in prog.ops:
        if op.opcode not in ("dot", "dot_general"):
            continue
        out = op.result_types[0] if op.result_types else None
        lhs = op.operand_types[0] if op.operand_types else None
        if out is None or lhs is None or not out.elems:
            continue
        m = (_MLIR_CONTRACT_RE.search(op.attrs)
             or _HLO_LHS_CONTRACT_RE.search(op.attrs))
        if not m:
            continue
        idxs = [int(x) for x in m.group(1).replace(" ", "").split(",") if x]
        extent = 1
        for i in idxs:
            if i < len(lhs.dims):
                extent *= lhs.dims[i]
        total += 2 * out.elems * max(extent, 1)
    return total


def overlap_window_s(prog: Optional[HloProgram] = None,
                     phases_s: Optional[Dict[str, float]] = None
                     ) -> Optional[float]:
    """The overlappable backward window predicted comms must hide in.

    Priority: an explicit ``HOROVOD_SCHED_OVERLAP_WINDOW_MS``; a
    perfscope-style phase split (``phases_s`` with a measured
    ``device_compute`` phase, times in seconds); else the analytic
    dot-FLOPs / ``HOROVOD_SCHED_PEAK_TFLOPS`` estimate — each scaled
    by ``HOROVOD_SCHED_OVERLAP_FRACTION``. None when nothing is
    configured: HVD405 stays silent, so the default CPU CI programs
    (no declared peak) lint clean.
    """
    ms = _float_env(_WINDOW_ENV)
    if ms is not None:
        return ms / 1e3
    frac = _float_env(_FRACTION_ENV)
    if frac is None:
        frac = DEFAULT_OVERLAP_FRACTION
    if phases_s:
        compute = phases_s.get("device_compute")
        if compute is None:
            compute = sum(v for v in phases_s.values()
                          if isinstance(v, (int, float)))
        return float(compute) * frac
    if prog is not None:
        tflops = _float_env(_PEAK_ENV)
        if tflops is not None:
            return dot_flops(prog) / (tflops * 1e12) * frac
    return None


def min_staged_bytes() -> int:
    """HVD404's payload floor (HOROVOD_SCHED_MIN_STAGED_BYTES,
    default 1 MiB): below it, flat cross-slice collectives are latency-
    dominated and staging buys nothing."""
    return _bytes_env("HOROVOD_SCHED_MIN_STAGED_BYTES", _MB)


# ----------------------------------------------------- lint entrypoints

def registry() -> Dict[str, Tuple[str, object]]:
    from horovod_tpu_torch.analysis import sched_rules
    return dict(sched_rules.RULES)


def lint_schedules(scheds: Sequence[ProgramSchedule],
                   select: Optional[Sequence[str]] = None,
                   ignore: Sequence[str] = ()) -> List[Finding]:
    """Run the HVD4xx rules over one ScheduleSet — programs linted
    together so the cross-program rules see every pairing."""
    out = run_rules(registry(), ScheduleSet(list(scheds)), select, ignore)
    out.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return out


def lint_programs(progs: Sequence[HloProgram],
                  select: Optional[Sequence[str]] = None,
                  ignore: Sequence[str] = ()) -> List[Finding]:
    """The HVD4xx rules over programs linted as one set (each rank's
    recorded program of one step, for example)."""
    return lint_schedules([ProgramSchedule(p) for p in progs],
                          select=select, ignore=ignore)


def lint_text(text: str, path: str = "<hlo>",
              select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> List[Finding]:
    return lint_schedules([parse_schedule(text, path)],
                          select=select, ignore=ignore)


def lint_files(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = ()) -> List[Finding]:
    """Parse ALL paths into one ScheduleSet before linting: the
    misordered-pair HVD401 acceptance only exists across files."""
    findings, scheds = read_files(paths, parse_schedule)
    findings.extend(lint_schedules(scheds, select=select, ignore=ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def record_metrics(findings: Sequence[Finding]) -> None:
    """hvdsched_findings_total{rule}; pre-registers the counter even on
    a clean run so dashboards see the series."""
    counter_metrics("hvdsched_findings_total", "hvdsched findings by rule",
                    findings)
