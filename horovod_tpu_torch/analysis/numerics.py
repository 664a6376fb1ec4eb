"""hvdnum: static numerics and reduction-semantics verification (HVD5xx;
counterpart of horovod_tpu/analysis/numerics.py).

The bugs that corrupt training silently are numeric: a matmul that
accumulates in bf16, a gradient downcast before (not after) its
all-reduce, a sum-vs-mean divisor baked in as the world size that goes
stale the first time the elastic world changes, and reduction orders
that differ from run to run, which void a bit-identical resume. All of
them are properties of a program, checkable from the model
``analysis/hlo.py`` builds from lowered text or a recorded torch step.

This module builds the state the HVD5xx rules (``num_rules.py``) read:

* a **dtype-flow lattice** propagated forward over the def-use graph:
  per value, the current element type, the widest type on any upstream
  path, and the most recent precision-dropping ``convert``, so a reduce
  can tell "natively narrow" from "narrowed on the way here" (HVD502);
* a **gradient-scale table**: one entry per fp reduce collective, with
  its group size, the explicit post-reduce scale constant resolved
  through ``hlo.constant_value`` (a recorded step turns a Python scalar
  operand, and a host scalar tensor, into a ``constant`` op), and the
  effective multiplier ``k / divisor`` that HVD503 checks in-program and
  HVD505 diffs across a mesh pair;
* `accumulation_dtype`, the accumulation type of a dot/conv, whose
  mapping for recorded torch ops is in its docstring.

Findings are baselined (``analysis/hvdnum_baseline.json``), not
suppressed inline, and feed ``hvdnum_findings_total{rule}``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.analysis.driver import Finding
from horovod_tpu_torch.analysis.hlo import (
    DTYPE_BYTES,
    HloOp,
    HloProgram,
    constant_value,
    counter_metrics,
    parse,
    read_files,
    run_rules,
)
from horovod_tpu_torch.analysis.schedule import (
    CollectiveEvent, ProgramSchedule,
)
from horovod_tpu_torch.analysis.shard import (
    _axis_partitions,
    _bytes_env,
    group_axis_label,
)

#: Floating-point element types, by width class. f8 variants share the
#: low-precision bucket with bf16/f16: none can hold a long gradient
#: accumulation without catastrophic rounding.
FP_DTYPES = frozenset({
    "f64", "f32", "bf16", "f16",
    "f8e4m3fn", "f8e5m2", "f8e4m3b11fnuz", "f8e4m3fnuz", "f8e5m2fnuz",
})
LOW_PRECISION = frozenset(d for d in FP_DTYPES
                          if DTYPE_BYTES.get(d, 4) < 4)

#: Collectives that *combine* values (order- and scale-sensitive);
#: gather/permute ops only move bytes and carry no reduction semantics.
REDUCE_COLLECTIVES = frozenset({"all_reduce", "reduce_scatter"})

#: Ops a reduced value flows through unchanged on the way to its
#: explicit scale op (the divide/multiply HVD503 audits). Arithmetic
#: ops are deliberately absent: the scan must stop at the first op
#: that changes the value's magnitude.
_SCALE_TRANSPARENT = frozenset({
    "convert", "copy", "bitcast", "reshape", "transpose", "slice",
    "get_tuple_element", "tuple", "optimization_barrier",
})

#: Ops resolved through when chasing a scale operand back to its
#: defining scalar constant (a divisor is usually broadcast first).
_CONST_TRANSPARENT = frozenset({
    "broadcast", "broadcast_in_dim", "reshape", "convert", "copy",
    "bitcast", "constant",
})

#: Keyless RNG opcodes: per-device implicit seed state, so a restored
#: replica replays a different stream (HVD504). ``rng_bit_generator``
#: threads its state explicitly and is exempt. A recorded torch step
#: writes a random op drawn from the default generator as ``rng`` and
#: one given an explicit ``generator=`` as ``rng_bit_generator``
#: (analysis/graph.py).
KEYLESS_RNG_OPS = frozenset({"rng", "rng_uniform", "rng_normal"})

#: The other determinism hazard of a recorded step: an op that
#: accumulates with CUDA atomics, whose summation order differs from
#: run to run (``index_add_``; ``scatter_add_`` where two indices can meet
#: one address). ``index_put_`` with accumulate=True sorts its indices on
#: CUDA and is not one (graph.py ATOMIC_OPS, after a chip run). The
#: recorder marks such an op with this attribute (on the host too: the
#: same step on the card takes the atomic path).
ATOMIC_ATTR = "atomic_accumulate=true"


# ------------------------------------------------------ loud env knobs

_MIN_REDUCE_ENV = "HOROVOD_NUM_MIN_REDUCE_BYTES"
_SCALE_TOL_ENV = "HOROVOD_NUM_SCALE_TOL"
_ALLOW_ACCUM_ENV = "HOROVOD_NUM_ALLOW_ACCUM"

#: Default relative tolerance when matching an explicit scale constant
#: against a group size: XLA folds divides into reciprocal multiplies,
#: so 1/3 round-trips through a printed decimal.
DEFAULT_SCALE_TOL = 0.01


def min_reduce_bytes() -> int:
    """HVD502/HVD503 payload floor (``HOROVOD_NUM_MIN_REDUCE_BYTES``,
    default 0: every fp gradient reduction is judged). Malformed input
    raises ValueError (loud-knob policy)."""
    return _bytes_env(_MIN_REDUCE_ENV, 0)


def scale_tol() -> float:
    """Relative tolerance for divisor-vs-group-size comparison
    (``HOROVOD_NUM_SCALE_TOL``, default 0.01). Loud on garbage."""
    from horovod_tpu_torch.analysis.schedule import _float_env
    tol = _float_env(_SCALE_TOL_ENV)
    return DEFAULT_SCALE_TOL if tol is None else tol


class _AccumAllowCache:
    """Process-wide cache of parsed HOROVOD_NUM_ALLOW_ACCUM sets, keyed
    by the raw env string (bench workers and concurrent lint threads
    share one parse per distinct value). Instrumented by hvdrace
    (race.DEFAULT_MODULES)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sets: Dict[str, frozenset] = {}  # guarded-by: _lock

    def get(self, raw: str) -> Optional[frozenset]:
        with self._lock:
            return self._sets.get(raw)

    def put(self, raw: str, allowed: frozenset) -> None:
        with self._lock:
            self._sets[raw] = allowed


_accum_cache = _AccumAllowCache()


def allowed_accum() -> frozenset:
    """Low-precision dtypes HVD501 accepts as accumulation types
    (``HOROVOD_NUM_ALLOW_ACCUM="bf16"`` for a model that has qualified
    bf16 accumulation). Comma-separated dtype tokens; an unknown token
    raises ValueError — a typo'd knob must fail the lint loudly, never
    silently widen or narrow the rule."""
    raw = os.environ.get(_ALLOW_ACCUM_ENV, "").strip()
    hit = _accum_cache.get(raw)
    if hit is not None:
        return hit
    tokens = frozenset(t.strip().lower() for t in raw.split(",")
                       if t.strip())
    for t in tokens:
        if t not in DTYPE_BYTES:
            raise ValueError(
                f"{_ALLOW_ACCUM_ENV}={raw!r}: unknown dtype token {t!r} "
                f"(expected comma-separated XLA dtype names, e.g. "
                f"'bf16' or 'bf16,f16')")
    _accum_cache.put(raw, tokens)
    return tokens


# ------------------------------------------------- the dtype-flow lattice

@dataclasses.dataclass
class ValueFlow:
    """Lattice state of one SSA value: current element type, the widest
    fp type on any upstream path, and the most recent precision-dropping
    convert that produced the narrowing (None = natively this wide)."""

    dtype: Optional[str]
    width: Optional[int]
    max_width: int
    narrowed_at: Optional[HloOp]


@dataclasses.dataclass(frozen=True)
class GradReduction:
    """One fp reduce collective + its resolved scale semantics."""

    op: HloOp
    event: CollectiveEvent
    dtype: str
    group_size: int
    nbytes: int
    #: Explicit post-reduce scale expressed as a divisor (a downstream
    #: ``divide`` by c, or ``multiply`` by 1/c); None = bare sum, or a
    #: dynamic scale when ``dynamic`` is set.
    divisor: Optional[float]
    divisor_line: Optional[int]
    #: The nearest scale op divides by a runtime value (e.g. an
    #: allreduced live group size — the elastic-correct pattern): the
    #: static multiplier is unknowable and the scale rules skip it.
    dynamic: bool = False

    @property
    def multiplier(self) -> Optional[float]:
        """Effective per-replica gradient multiplier: k for a bare sum,
        k/divisor with an explicit scale (1.0 = true mean), None when
        the scale is dynamic."""
        if self.dynamic:
            return None
        if self.divisor:
            return self.group_size / self.divisor
        return float(self.group_size)


#: The accumulation type a recorded op declares (analysis/graph.py).
ACCUM_RE = re.compile(r"accumulation_type=(\w+)")


def accumulation_dtype(op: HloOp) -> Optional[str]:
    """The fp type a dot/conv (or a kernel op) accumulates in.

    Lowered text has no such field: the result type is the accumulator
    (``preferred_element_type``). A recorded torch op states the type it
    really uses, as ``accumulation_type=`` (analysis/graph.py), mapped
    from what the library does, not from the result type:

    ========================================  =========================
    op, inputs                                accumulation type
    ========================================  =========================
    matmul (cuBLAS), bf16, where split-K is   bf16 when ``torch.backends.
    possible (graph.split_k_possible: fewer   cuda.matmul.allow_bf16_
    128x128 output tiles than the H100's      reduced_precision_
    132 SMs, and K >= 1024)                   reduction`` is set (torch's
                                              default: the split-K
                                              partial sums may round in
                                              bf16), else f32
    matmul (cuBLAS), f16, where split-K is    f16 when ``allow_fp16_
    possible                                  reduced_precision_
                                              reduction`` is set (torch's
                                              default), else f32
    matmul, bf16/f16, any other shape         f32 (cuBLAS's accumulator)
    matmul, f32 (tf32 or not)                 f32
    convolution (cuDNN), bf16/f16/f32         f32
    kernels 1-6 (custom_call)                 f32, their accumulators
    ========================================  =========================

    The mapping is the card's whichever device recorded the op: a host
    recording stands in for the card's step. Split-K is cuBLAS's choice;
    the shape test only rules it out where it cannot pay.
    """
    m = ACCUM_RE.search(op.attrs)
    if m:
        return m.group(1)
    return _fp_dtype(op.result_types[0] if op.result_types else None)


def _fp_dtype(t) -> Optional[str]:
    if t is None:
        return None
    d = t.dtype.lower()
    return d if d in FP_DTYPES else None


class NumericsProgram:
    """The hvdnum analysis state of one lowered program: the parsed
    module, its collective schedule, the dtype-flow lattice, and the
    gradient-scale table."""

    def __init__(self, prog: HloProgram):
        self.prog = prog
        self.path = prog.path
        self.schedule = ProgramSchedule(prog)
        #: (scope, ssa name) -> ValueFlow
        self.flow: Dict[Tuple[str, str], ValueFlow] = {}
        self.reductions: List[GradReduction] = []
        self._propagate()
        self._collect_reductions()

    # -- forward dtype-flow pass (printed order is SSA order in both
    # textual forms, so one linear sweep converges)
    def _propagate(self) -> None:
        for op in self.prog.ops:
            if not op.result:
                continue
            out_t = op.result_types[0] if op.result_types else None
            dtype = _fp_dtype(out_t)
            width = DTYPE_BYTES.get(dtype) if dtype else None
            max_width = width or 0
            narrowed: Optional[HloOp] = None
            for o in op.operands:
                f = self.flow.get((op.scope, o))
                if f is None:
                    continue
                max_width = max(max_width, f.max_width)
                if narrowed is None and f.narrowed_at is not None:
                    narrowed = f.narrowed_at
            if op.opcode == "convert":
                src = (op.operand_types[0] if op.operand_types else None)
                src_d = _fp_dtype(src)
                src_w = DTYPE_BYTES.get(src_d) if src_d else None
                if src_w is None and op.operands:
                    f = self.flow.get((op.scope, op.operands[0]))
                    src_w = f.width if f else None
                if (src_w is not None and width is not None
                        and dtype and width < src_w):
                    narrowed = op
                    max_width = max(max_width, src_w)
            self.flow[(op.scope, op.result)] = ValueFlow(
                dtype, width, max_width, narrowed)

    # -- gradient-scale table
    def _collect_reductions(self) -> None:
        opmap = {op.line: op for op in self.prog.ops}
        ndev = self.schedule.num_devices
        for ev in self.schedule.events:
            if ev.opcode not in REDUCE_COLLECTIVES:
                continue
            op = opmap.get(ev.line)
            if op is None:
                continue
            dtype = None
            for t in list(op.operand_types) + list(op.result_types):
                dtype = _fp_dtype(t)
                if dtype:
                    break
            if dtype is None:
                continue  # integer/predicate reductions are exact
            k = max((len(g) for g in ev.groups), default=ndev)
            divisor, dline, dyn = self._post_scale(op)
            self.reductions.append(GradReduction(
                op=op, event=ev, dtype=dtype, group_size=max(k, 1),
                nbytes=ev.nbytes, divisor=divisor, divisor_line=dline,
                dynamic=dyn))

    def _resolve_const(self, scope: str, name: str,
                       depth: int = 8) -> Optional[float]:
        """Chase an operand back through broadcasts/reshapes to its
        defining scalar constant (hlo.constant_value)."""
        while depth > 0:
            depth -= 1
            d = self.prog.defining(scope, name)
            if d is None:
                return None
            if d.opcode == "constant":
                return constant_value(d)
            if d.opcode not in _CONST_TRANSPARENT or not d.operands:
                return None
            name = d.operands[0]
        return None

    def _post_scale(self, op: HloOp, max_visits: int = 128
                    ) -> Tuple[Optional[float], Optional[int], bool]:
        """The first explicit scale applied to a reduce's result
        (through _SCALE_TRANSPARENT ops), as
        ``(divisor, line, dynamic)``. BFS so the *nearest* scale op
        wins: a mean's 1/k multiply is adjacent to the reduce, while
        the learning-rate multiply rides behind the optimizer's update
        math. A divide by a runtime value (allreduced live group size)
        reports dynamic=True — the elastic-correct pattern the static
        rules must not second-guess."""
        if not op.result:
            return None, None, False
        seen = {op.result}
        frontier = [op]
        visits = 0
        while frontier and visits < max_visits:
            cur = frontier.pop(0)
            visits += 1
            for use in self.prog.uses(cur.scope, cur.result):
                if use.opcode == "divide" and len(use.operands) >= 2:
                    if use.operands[0] != cur.result:
                        continue  # our value is the denominator of
                        # someone else's math, not a scale of ours
                    c = self._resolve_const(use.scope, use.operands[1])
                    if c:
                        return c, use.line, False
                    return None, use.line, True
                if use.opcode == "multiply" and len(use.operands) >= 2:
                    c = None
                    for other in use.operands:
                        if other == cur.result:
                            continue
                        c = self._resolve_const(use.scope, other)
                        if c:
                            break
                    if c:
                        return 1.0 / c, use.line, False
                    return None, use.line, True
                if use.opcode in _SCALE_TRANSPARENT and use.result \
                        and use.result not in seen:
                    seen.add(use.result)
                    frontier.append(use)
        return None, None, False


@dataclasses.dataclass
class NumericsSet:
    """All programs linted together — the unit HVD505 sees. The
    cross-mesh diff only exists across programs (the different-mesh
    restore pair lowered from one step), so lint_files parses every
    path into ONE set, mirroring hvdsched."""

    programs: List[NumericsProgram]


def analyze_text(text: str, path: str = "<hlo>") -> NumericsProgram:
    return NumericsProgram(parse(text, path))


# ------------------------------------------------------------- linting

def registry() -> Dict[str, Tuple[str, object]]:
    """rule_id -> (description, check(nset) -> iterable[Finding])."""
    from horovod_tpu_torch.analysis import num_rules
    return dict(num_rules.RULES)


def lint_programs(nprogs: Sequence[NumericsProgram],
                  select: Optional[Sequence[str]] = None,
                  ignore: Sequence[str] = ()) -> List[Finding]:
    """Run the HVD5xx rules over one NumericsSet (`nprogs` may also hold
    parsed or recorded HloPrograms)."""
    nset = NumericsSet([p if isinstance(p, NumericsProgram)
                        else NumericsProgram(p) for p in nprogs])
    out = run_rules(registry(), nset, select, ignore)
    out.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return out


def lint_text(text: str, path: str = "<hlo>",
              select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> List[Finding]:
    return lint_programs([analyze_text(text, path)],
                         select=select, ignore=ignore)


def lint_files(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = ()) -> List[Finding]:
    """Parse ALL paths into one NumericsSet before linting: the
    HVD505 mesh-pair diff only exists across files."""
    findings, nprogs = read_files(paths, analyze_text)
    findings.extend(lint_programs(nprogs, select=select, ignore=ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def record_metrics(findings: Sequence[Finding]) -> None:
    """hvdnum_findings_total{rule}; pre-registers the counter even on
    a clean run so dashboards see the series."""
    counter_metrics("hvdnum_findings_total", "hvdnum findings by rule",
                    findings)


# ---------------------------------------------------- the bench stamp

#: Op families whose result dtype IS an accumulation type: what the
#: stamp's ``accum_dtypes`` reports (the compile-time answer to "what
#: precision do my matmuls and gradient reductions accumulate in?").
_ACCUM_OPS = frozenset({"dot", "dot_general", "convolution", "reduce"})


def stamp(text: str,
          axis_sizes: Optional[Sequence[Tuple[str, int]]] = None,
          path: str = "<compiled>") -> Dict[str, object]:
    """The bench ``numerics`` stamp: accumulation dtypes seen plus the
    gradient-scale table, off the SAME compiled text the comms stamps
    read, replica groups classified by the SAME shard.group_axis_label
    helper — so scale attribution and comms attribution can never
    disagree on what a group means. perf_gate requires this stamp
    structurally on every gspmd section; perfboard carries its finding
    count across rounds."""
    np_ = analyze_text(text, path)
    accum = set()
    for op in np_.prog.ops:
        if op.opcode in _ACCUM_OPS or ACCUM_RE.search(op.attrs):
            d = accumulation_dtype(op)
            if d:
                accum.add(d)
    for r in np_.reductions:
        accum.add(r.dtype)
    partitions = (_axis_partitions(axis_sizes)
                  if axis_sizes is not None else None)
    table: List[Dict[str, object]] = []
    for r in np_.reductions:
        mult = r.multiplier
        ent: Dict[str, object] = {
            "opcode": r.event.opcode,
            "dtype": r.dtype,
            "group_size": r.group_size,
            "bytes": r.nbytes,
            "divisor": r.divisor,
            "multiplier": None if mult is None else round(mult, 6),
        }
        if partitions is not None:
            groups = [list(g) for g in r.event.groups] or None
            ent["axis"] = group_axis_label(groups, partitions)
        table.append(ent)
    findings = lint_programs([np_])
    record_metrics(findings)
    rules: Dict[str, int] = {}
    for f in findings:
        rules[f.rule_id] = rules.get(f.rule_id, 0) + 1
    out: Dict[str, object] = {
        "accum_dtypes": sorted(accum),
        "grad_scale": table,
        "findings": len(findings),
        "clean": not findings,
    }
    if rules:
        out["rules"] = rules
    return out


def close(a: float, b: float, tol: Optional[float] = None) -> bool:
    """Scale comparison helper shared by HVD503/HVD505 (one tolerance,
    one knob)."""
    if tol is None:
        tol = scale_tol()
    return math.isclose(a, b, rel_tol=tol, abs_tol=1e-12)
