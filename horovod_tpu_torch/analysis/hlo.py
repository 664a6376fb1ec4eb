"""hvdhlo: structural analysis of a step program (counterpart of
horovod_tpu/analysis/hlo.py).

The HVD2xx-5xx rules (``hlo_rules``, ``shard_rules``, ``sched_rules``,
``num_rules``) read one op/def-use model, `HloProgram`, which comes from
either of two sources:

* **lowered text**: the two textual forms the JAX package's toolchain
  prints, parsed here exactly as the JAX parser does (the parsers are a
  copy, so that a dump lints the same in both packages):

  - **StableHLO MLIR** (``jax.jit(f).lower(*args).as_text()``); donation
    shows up as ``jax.buffer_donor``/``tf.aliasing_output`` argument
    attributes;
  - **HLO text** (``lowered.compile().as_text()`` or a dumped module);
    donation shows up in the module-level ``input_output_alias`` map.

  The parser is line-structural, not a grammar: it recovers (result,
  opcode, operands, operand/result tensor types, attribute text) per
  instruction plus entry parameters and their donation bits, and
  ignores everything else.
* **a recorded torch step** (``analysis/graph.py``): the port runs
  eagerly and lowers nothing, so its counterpart of "lower the step" is
  one real step run under a ``TorchDispatchMode`` recorder, which emits
  the same model with ``fmt == "torch"``: per-rank (per-device) shapes
  in executed order, like a post-SPMD module. `record_step_program` is
  the counterpart of the JAX `lower_step_text`.

Findings ride the driver machinery (`driver.Finding`, ``file:line
RULE-ID msg``, ``--format json``, ``--baseline``); there are no source
comments in a program, so findings are silenced via the baseline file
(``analysis/hvdhlo_baseline.json``), not inline suppressions. Findings
feed ``hvdhlo_findings_total{rule}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from horovod_tpu_torch.analysis.driver import Finding

#: Bytes per element for the dtypes XLA prints. Unknown dtypes parse to
#: itemsize None and size-based rules skip the value instead of guessing.
DTYPE_BYTES = {
    "pred": 1, "i1": 1, "s8": 1, "u8": 1, "i8": 1, "ui8": 1,
    "s16": 2, "u16": 2, "i16": 2, "ui16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "i32": 4, "ui32": 4, "f32": 4,
    "s64": 8, "u64": 8, "i64": 8, "ui64": 8, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3fnuz": 1,
    "f8e5m2fnuz": 1,
}


@dataclasses.dataclass(frozen=True)
class TensorType:
    """One tensor type: dtype token + static dims (None on dynamic)."""

    dtype: str
    dims: Tuple[int, ...]

    @property
    def elems(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def itemsize(self) -> Optional[int]:
        return DTYPE_BYTES.get(self.dtype.lower())

    @property
    def nbytes(self) -> Optional[int]:
        i = self.itemsize
        return None if i is None else self.elems * i

    def __str__(self) -> str:
        dims = "x".join(str(d) for d in self.dims)
        return f"{self.dtype}[{dims}]" if self.dims else f"{self.dtype}[]"


@dataclasses.dataclass
class HloOp:
    """One instruction, normalized across the two textual forms."""

    line: int                     # 1-based line in the analyzed text
    result: str                   # "%23" ("" for results-less ops)
    opcode: str                   # canonical: all_reduce, dot_general, ...
    operands: Tuple[str, ...]     # SSA names, '#i' projections stripped
    operand_types: Tuple[Optional[TensorType], ...]
    result_types: Tuple[Optional[TensorType], ...]
    attrs: str                    # raw remainder text for attr regexes
    scope: str                    # enclosing function / computation name
    #: Scalar value of a ``constant`` op's literal (both textual forms,
    #: incl. scientific notation, typed ``bf16[] 8`` spellings and MLIR
    #: ``dense<>`` splats); None for non-constants and non-scalars.
    literal: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class HloParam:
    """One computation parameter (entry, `call`ee, or shard_map body —
    sharding/donation attrs are recorded uniformly at every function
    boundary, not just the entry signature)."""

    index: int
    name: str                     # "%arg0" / "%p.1"
    type: Optional[TensorType]
    donated: bool
    scope: str
    line: int
    #: Raw sharding annotation text ("{replicated}",
    #: "{devices=[2,4]<=[8]}", ...) or None when unannotated. The
    #: sharding-aware layer (analysis/shard.py) interprets it.
    sharding: Optional[str] = None


class HloProgram:
    """Parsed module: op list + def/use indexes the rules query."""

    def __init__(self, path: str, ops: List[HloOp],
                 params: List[HloParam], entry_scope: str,
                 fmt: str, num_partitions: int = 1,
                 rank: Optional[int] = None,
                 device_memory: Optional[int] = None) -> None:
        self.path = path
        self.ops = ops
        self.params = params
        self.entry_scope = entry_scope
        self.fmt = fmt  # "stablehlo" | "hlo" | "torch"
        #: SPMD partition count (mhlo.num_partitions module attr /
        #: HloModule header); the world size of a recorded program; 1
        #: for unpartitioned programs.
        self.num_partitions = num_partitions
        #: The rank whose step a recorded program is (None for text): a
        #: recorded program is one device's schedule, not an SPMD one.
        self.rank = rank
        #: `total_memory` of the card a program was recorded on (None on
        #: the host and for text): the default HVD303 budget.
        self.device_memory = device_memory
        self._defs: Dict[Tuple[str, str], HloOp] = {}
        self._uses: Dict[Tuple[str, str], List[HloOp]] = {}
        for op in ops:
            if op.result:
                self._defs.setdefault((op.scope, op.result), op)
            for o in op.operands:
                self._uses.setdefault((op.scope, o), []).append(op)

    @property
    def per_device(self) -> bool:
        """Shapes are per device and the op order is the schedule: the
        post-SPMD HLO text and a recorded torch step, not StableHLO."""
        return self.fmt != "stablehlo"

    @property
    def entry_params(self) -> List[HloParam]:
        return [p for p in self.params if p.scope == self.entry_scope]

    def defining(self, scope: str, name: str) -> Optional[HloOp]:
        return self._defs.get((scope, name))

    def uses(self, scope: str, name: str) -> List[HloOp]:
        return self._uses.get((scope, name), [])

    def depends_on(self, op: HloOp, target: HloOp,
                   max_visits: int = 4096) -> bool:
        """True when `op` transitively consumes `target`'s result
        (same-scope def-use reachability; the overlap-chain query)."""
        if op.scope != target.scope or not target.result:
            return False
        seen: Set[str] = set()
        frontier = list(op.operands)
        visits = 0
        while frontier and visits < max_visits:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            visits += 1
            if name == target.result:
                return True
            d = self.defining(op.scope, name)
            if d is not None:
                frontier.extend(d.operands)
        return False


# ------------------------------------------------------------- parsing

_TENSOR_RE = re.compile(r"tensor<([^<>]*?)>")
_HLO_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]+[a-z0-9]*|pred)\[([0-9,]*)\]")
_SSA_RE = re.compile(r"%[\w.-]+")


def _parse_mlir_tensor(inner: str) -> Optional[TensorType]:
    """``2x8x8x64xbf16`` / ``f32`` / ``?x128xf32`` -> TensorType|None."""
    parts = inner.split("x")
    dims: List[int] = []
    for i, p in enumerate(parts):
        p = p.strip()
        if p.isdigit():
            dims.append(int(p))
            continue
        if p == "?":
            return None  # dynamic: size-based rules must skip
        dtype = "x".join(parts[i:]).strip()
        # complex<f32> etc. keep their full token; lookup just misses.
        return TensorType(dtype, tuple(dims))
    return None


def _mlir_types(segment: str) -> List[Optional[TensorType]]:
    """Every tensor<> type in `segment`, in order (non-tensor -> None
    is NOT emitted; callers align by count only when it matches)."""
    return [_parse_mlir_tensor(m.group(1))
            for m in _TENSOR_RE.finditer(segment)]


def _hlo_types(segment: str) -> List[Optional[TensorType]]:
    return [TensorType(m.group(1),
                       tuple(int(d) for d in m.group(2).split(",") if d))
            for m in _HLO_SHAPE_RE.finditer(segment)]


def _operand_names(segment: str) -> Tuple[str, ...]:
    return tuple(m.group(0).split("#")[0]
                 for m in _SSA_RE.finditer(segment))


# Constant literals, both textual forms. XLA prints scalars plain
# (``constant(8)``), in scientific notation (``constant(1.25e-05)``)
# and — for the narrow dtypes — typed (``constant(bf16[] 8)``,
# ``constant(f8e4m3fn[] 1.5e-2)``); StableHLO prints ``dense<>`` attrs
# (``dense<1.250000e-01>``). The number grammar must cover all of them:
# a literal the parser cannot read is a silently skipped operand, and
# the HVD503 divisor extraction then misses the baked scale constant.
_LITERAL_NUM_RE = re.compile(
    r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
_MLIR_DENSE_RE = re.compile(r"dense<(.*)>\s*$", re.DOTALL)


def parse_literal(text: str) -> Optional[float]:
    """Scalar value of one constant literal, or None when the literal
    is non-scalar (array/tuple braces, hex-encoded dense blobs) — the
    caller must then skip the value rather than guess."""
    s = text.strip()
    m = _MLIR_DENSE_RE.match(s)
    if m:
        s = m.group(1).strip()
    # typed scalar literal: a leading `dtype[]` token before the value
    tm = _HLO_SHAPE_RE.match(s)
    if tm and tm.start() == 0:
        if tm.group(2).strip():
            return None  # shaped literal: `f32[2] {1, 2}` is not scalar
        s = s[tm.end():].strip()
    if not s or s[0] in "{[\"":
        return None  # array / tuple / hex-string literal
    low = s.lower()
    if low in ("true", "false"):
        return 1.0 if low == "true" else 0.0
    if low in ("inf", "+inf", "-inf", "nan"):
        return float(low)
    if _LITERAL_NUM_RE.fullmatch(s):
        return float(s)
    return None


def constant_value(op: "HloOp") -> Optional[float]:
    """The scalar a ``constant`` op defines; None for anything else.
    The HVD503 gradient-scale rules resolve explicit divide/multiply
    scale factors through this accessor."""
    return op.literal if op.opcode == "constant" else None


# StableHLO op header: `%23 = "stablehlo.all_reduce"(%22) <{...}> ({`
# or `%0 = stablehlo.dot_general %arg0, %arg1, ... : (T, T) -> T`
# or `stablehlo.return %25 : tensor<f32>` / `return %1 : tensor<...>`.
_MLIR_OP_RE = re.compile(
    r"^\s*(?:(%[\w]+)(?::\d+)?\s*=\s*)?"
    r'"?([a-zA-Z_][\w$]*\.)?([a-zA-Z_][\w$-]*)"?\s*(?=[ (%<"@]|$)')
_MLIR_FUNC_RE = re.compile(
    r"^\s*func\.func\s+(?:(public|private)\s+)?@([\w$-]+)\s*\((.*)$")
# The attr dict may nest braces two levels (mhlo.sharding strings like
# {jax.buffer_donor = true, mhlo.sharding = "{devices=[2,4]<=[8]
# last_tile_dims={replicated}}"}) — the donation bit and the sharding
# string must both survive riding alongside each other.
_MLIR_ARG_RE = re.compile(
    r"(%arg\d+):\s*"
    r"([^,){]+(?:\{(?:[^{}]|\{(?:[^{}]|\{[^{}]*\})*\})*\})?)")
_MLIR_SHARDING_RE = re.compile(r'mhlo\.sharding\s*=\s*"([^"]*)"')
_MLIR_NUM_PARTITIONS_RE = re.compile(
    r"mhlo\.num_partitions\s*=\s*(\d+)")
# HLO text: `sharding={devices=[4,1,2]<=[2,4]T(1,0)
# last_tile_dim_replicate}` / `sharding={replicated}` instruction attr
# (entry parameters keep their annotation through SPMD partitioning).
_HLO_SHARDING_RE = re.compile(
    r"sharding=(\{(?:[^{}]|\{[^{}]*\})*\})")
_HLO_NUM_PARTITIONS_RE = re.compile(r"\bnum_partitions=(\d+)")


def op_sharding(op: HloOp) -> Optional[str]:
    """The raw sharding annotation carried by one instruction, for BOTH
    textual forms: ``mhlo.sharding = "..."`` on a StableHLO custom-call
    (`@Sharding` = `with_sharding_constraint`), ``sharding={...}`` on an
    HLO-text instruction. None when the op is unannotated."""
    m = _MLIR_SHARDING_RE.search(op.attrs)
    if m:
        return m.group(1)
    m = _HLO_SHARDING_RE.search(op.attrs)
    return m.group(1) if m else None

#: MLIR keywords the op regex would otherwise read as opcodes.
_MLIR_NOISE = {"module", "func", "}", "{", "^bb0", "cond", "do"}


def _parse_stablehlo(text: str, path: str) -> HloProgram:
    ops: List[HloOp] = []
    params: List[HloParam] = []
    entry_scope = ""
    scope = ""
    num_partitions = 1
    # stack of (op, brace_balance_at_open) for region ops whose result
    # type arrives on the closing `}) : (...) -> ...` line
    pending: List[HloOp] = []
    lines = text.splitlines()
    for lineno, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("//"):
            continue
        if line.startswith("module"):
            pm = _MLIR_NUM_PARTITIONS_RE.search(line)
            if pm:
                num_partitions = int(pm.group(1))
            continue
        fm = _MLIR_FUNC_RE.match(raw)
        if fm:
            vis, name, argtext = fm.group(1), fm.group(2), fm.group(3)
            scope = name
            if vis == "public" or (not entry_scope and name == "main"):
                entry_scope = name
            for i, am in enumerate(_MLIR_ARG_RE.finditer(argtext)):
                arg, typetext = am.group(1), am.group(2)
                types = _mlir_types(typetext)
                donated = ("jax.buffer_donor" in typetext
                           or "tf.aliasing_output" in typetext)
                sm = _MLIR_SHARDING_RE.search(typetext)
                params.append(HloParam(i, arg, types[0] if types else None,
                                       donated, scope, lineno,
                                       sm.group(1) if sm else None))
            continue
        if line.startswith("})"):
            # close of a region op: its functional type rides here
            _, _, typesig = line.partition(":")
            if pending:
                op = pending.pop()
                ins, _, outs = typesig.partition("->")
                op.operand_types = tuple(_mlir_types(ins))
                op.result_types = tuple(_mlir_types(outs))
            continue
        m = _MLIR_OP_RE.match(raw)
        if not m:
            continue
        result = m.group(1) or ""
        opcode = m.group(3)
        if opcode in _MLIR_NOISE or line.startswith("^"):
            continue
        opcode = opcode.replace("-", "_")
        rest = raw[m.end():]
        # the trailing ` : type` annotation (absent on region openers)
        body, _, typesig = rest.rpartition(" : ")
        if not body:
            body, typesig = rest, ""
        operand_types: Tuple[Optional[TensorType], ...] = ()
        result_types: Tuple[Optional[TensorType], ...] = ()
        if "->" in typesig:
            ins, _, outs = typesig.partition("->")
            operand_types = tuple(_mlir_types(ins))
            result_types = tuple(_mlir_types(outs))
        elif typesig:
            result_types = tuple(_mlir_types(typesig))
        op = HloOp(lineno, result, opcode, _operand_names(body),
                   operand_types, result_types, rest.strip(), scope,
                   parse_literal(body) if opcode == "constant" else None)
        ops.append(op)
        # `({` with no matching `})` on the same line opens a region
        if rest.count("({") > rest.count("})"):
            pending.append(op)
    return HloProgram(path, ops, params, entry_scope or "main",
                      "stablehlo", num_partitions)


# HLO text: `  %all-reduce.2 = f32[256,256]{1,0} all-reduce(f32[...] %x),
# channel_id=1, ...` inside `ENTRY %main ... {` ... `}` computations.
# XLA prints the `%` name sigil in some modes and omits it in others;
# both spellings are accepted.
_HLO_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?(%?[\w.-]+)\s*=\s*(.+?)\s([a-z][a-z0-9-]*)\((.*)$")
_HLO_COMP_RE = re.compile(
    r"^\s*(ENTRY\s+)?(%?[\w.-]+)\s.*->\s.*\{\s*$")
_HLO_ALIAS_RE = re.compile(
    r"input_output_alias=\{([^{}]*(?:\{[^{}]*\}[^{}]*)*)\}")


def _hlo_alias_params(header: str) -> Set[int]:
    """Donated parameter numbers from the module-level alias map:
    ``{0}: (0, {}, may-alias)`` -> param 0."""
    m = _HLO_ALIAS_RE.search(header)
    if not m:
        return set()
    return {int(g) for g in re.findall(r"\(\s*(\d+)\s*,", m.group(1))}


def _split_args(segment: str) -> Tuple[str, str]:
    """(arg list, attr remainder) of an instruction tail, honoring
    nested parens: ``f32[2]{0} %a, %b), channel_id=1`` splits at the
    close paren matching the opcode's open."""
    depth = 0
    for i, ch in enumerate(segment):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            if ch == ")" and depth == 0:
                return segment[:i], segment[i + 1:]
            depth -= 1
    return segment, ""


def _parse_hlo_text(text: str, path: str) -> HloProgram:
    ops: List[HloOp] = []
    params: List[HloParam] = []
    entry_scope = ""
    scope = ""
    in_entry = False
    donated: Set[int] = set()
    num_partitions = 1
    lines = text.splitlines()
    for lineno, raw in enumerate(lines, 1):
        if raw.startswith("HloModule"):
            donated = _hlo_alias_params(raw)
            pm = _HLO_NUM_PARTITIONS_RE.search(raw)
            if pm:
                num_partitions = int(pm.group(1))
            continue
        im = _HLO_INSTR_RE.match(raw)
        if im:
            result, typetext, opcode, tail = im.groups()
            args, attrs = _split_args(tail)
            opcode = opcode.replace("-", "_")
            op = HloOp(lineno, result, opcode, _operand_names(args),
                       tuple(_hlo_types(args)), tuple(_hlo_types(typetext)),
                       attrs.strip(", "), scope,
                       parse_literal(args) if opcode == "constant"
                       else None)
            ops.append(op)
            if opcode == "parameter":
                pm = re.match(r"\s*(\d+)", args)
                idx = int(pm.group(1)) if pm else len(params)
                params.append(HloParam(
                    idx, result, op.result_types[0] if op.result_types
                    else None, in_entry and idx in donated, scope, lineno,
                    op_sharding(op)))
            continue
        cm = _HLO_COMP_RE.match(raw)
        if cm and "=" not in raw.split("->")[0]:
            in_entry = bool(cm.group(1))
            scope = cm.group(2)
            if in_entry:
                entry_scope = scope
    # parameters of non-entry computations are never donation candidates
    # (only the entry alias map carries donation bits), but they DO keep
    # their sharding attrs — call/shard_map boundaries are recorded
    # uniformly with the entry signature.
    return HloProgram(path, ops, params, entry_scope, "hlo",
                      num_partitions)


def parse(text: str, path: str = "<hlo>") -> HloProgram:
    """Parse either textual form; dispatch by content."""
    head = text[:4096]
    if "HloModule" in head:
        return _parse_hlo_text(text, path)
    return _parse_stablehlo(text, path)


# ------------------------------------------------------------- linting

def registry() -> Dict[str, Tuple[str, object]]:
    """rule_id -> (description, check(program) -> iterable[Finding])."""
    from horovod_tpu_torch.analysis import hlo_rules
    return dict(hlo_rules.RULES)


def run_rules(reg: Dict[str, Tuple[str, object]], unit,
              select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> List[Finding]:
    """Every rule of `reg` that `select`/`ignore` let through, over one
    unit (a program, a schedule set, a numerics set): the loop each
    family's lint runs."""
    wanted = {r.upper() for r in select} if select is not None else None
    ignored = {r.upper() for r in ignore}
    out: List[Finding] = []
    for rule_id, (_desc, check) in sorted(reg.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        if rule_id in ignored:
            continue
        out.extend(check(unit))
    return out


def lint_program(prog: HloProgram,
                 select: Optional[Sequence[str]] = None,
                 ignore: Sequence[str] = ()) -> List[Finding]:
    """Run the HVD2xx rules over one program (parsed or recorded)."""
    out = run_rules(registry(), prog, select, ignore)
    out.sort(key=lambda f: (f.line, f.rule_id))
    return out


def lint_text(text: str, path: str = "<hlo>",
              select: Optional[Sequence[str]] = None,
              ignore: Sequence[str] = ()) -> List[Finding]:
    """Run the HVD2xx rules over one lowered module's text."""
    return lint_program(parse(text, path), select=select, ignore=ignore)


def read_files(paths: Sequence[str], parser
               ) -> Tuple[List[Finding], list]:
    """(HVD999 findings for unreadable paths, parser(text, path) for
    the others): unreadable paths fail the gate, mirroring the AST
    driver's contract."""
    findings: List[Finding] = []
    units = []
    for p in paths:
        try:
            with open(p, "r", encoding="utf-8") as fh:
                text = fh.read()
        except OSError as e:
            findings.append(Finding(str(p), 1, "HVD999",
                                    f"unreadable: {e}"))
            continue
        units.append(parser(text, str(p)))
    return findings, units


def lint_files(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = ()) -> List[Finding]:
    """Lint dumped modules, one at a time."""
    findings, progs = read_files(paths, parse)
    for prog in progs:
        findings.extend(lint_program(prog, select=select, ignore=ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def lint_enabled() -> bool:
    """HOROVOD_HLO_LINT gate (default on) for the serving engine's
    stamp; the CLI path runs unconditionally."""
    from horovod_tpu_torch.common.config import _env_on
    return _env_on("HOROVOD_HLO_LINT", True)


#: A stamp holds at most this many findings (full details always come
#: from re-running the CLI).
_SUMMARY_MAX_FINDINGS = 20


def lint_summary(program, path: str = "<lowered>") -> Dict[str, object]:
    """The compact stamp of one program (`program`: lowered text or a
    recorded `HloProgram`)."""
    prog = (program if isinstance(program, HloProgram)
            else parse(program, path))
    findings = lint_program(prog)
    record_metrics(findings)
    rules: Dict[str, int] = {}
    for f in findings:
        rules[f.rule_id] = rules.get(f.rule_id, 0) + 1
    out: Dict[str, object] = {"count": len(findings),
                              "clean": not findings}
    if findings:
        out["rules"] = rules
        out["findings"] = [f.render()
                           for f in findings[:_SUMMARY_MAX_FINDINGS]]
        if len(findings) > _SUMMARY_MAX_FINDINGS:
            out["truncated"] = len(findings) - _SUMMARY_MAX_FINDINGS
    return out


def counter_metrics(name: str, help_: str,
                    findings: Sequence[Finding]) -> None:
    """<family>_findings_total{rule}; lint must work in environments
    without the runtime deps, so failures are swallowed."""
    try:
        from horovod_tpu_torch.observability import metrics as m
        counter = m.registry().counter(name, help_, labelnames=("rule",))
        for f in findings:
            counter.labels(rule=f.rule_id).inc()
    except Exception:
        pass


def record_metrics(findings: Sequence[Finding]) -> None:
    """hvdhlo_findings_total{rule}."""
    counter_metrics("hvdhlo_findings_total", "hvdhlo findings by rule",
                    findings)


#: Stable pseudo-path for --hlo-step findings, so baseline entries
#: survive across hosts and invocations.
def step_path(kind: str) -> str:
    return f"<hlo-step:{kind}>"


# ------------------------------------------------ canonical step record

@contextlib.contextmanager
def step_world(device):
    """The port's world for recording a step: the one already joined,
    else a world of one (gloo on the host, NCCL on the card) for the
    body's length."""
    import tempfile

    import horovod_tpu_torch as hvd
    if hvd.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as d:
        hvd.init(device="cpu" if device.type == "cpu" else None,
                 init_method=f"file://{d}/store")
        try:
            yield
        finally:
            hvd.shutdown()


def record_step_program(kind: str = "lm", device=None) -> HloProgram:
    """The recorded counterpart of the JAX `lower_step_text`: one step of
    the canonical program under the CURRENT fusion/layout config,
    recorded by analysis/graph.py (`device`: "cpu" or the card, default
    the card when there is one).

    `lm`: the tied-embedding LM of the JAX program (D 256, F 1024, V
    8192, 6 residual tanh-FFN blocks, an 8 MB embedding, ~20 MB of f32
    gradients, batch 16 x 64) through the port's bucketed hook path
    (DistributedOptimizer over SGD): with the bucket cap intact every
    all-reduce payload stays <= the cap; HOROVOD_FUSION_THRESHOLD=64MB
    with HOROVOD_BUCKET_CAP=0 (the single-giant-allreduce plan) trips
    HVD201.

    `resnet_block`: the C = 64 ResNet bottleneck block of the JAX
    program (trunk 64, width 64, batch 128 at 8x8, 1000 classes) on the
    port's block route: the three 1x1 conv+BN(+ReLU) sites through
    kernels 1 and 2 (ops/conv_block.py; their plain versions on the
    host), the 3x3 conv through cuDNN. At the port's lane (64) every
    channel dim is aligned; at the JAX package's lane (128) it pads, as
    the JAX program does before its layout pass.
    """
    import torch
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if kind not in ("lm", "resnet_block"):
        raise ValueError(f"unknown --hlo-step program {kind!r}")
    build = _lm_step if kind == "lm" else _resnet_block_step
    with step_world(dev):
        step, entries = build(dev)
        from horovod_tpu_torch.analysis import graph
        _, prog = graph.record(step, path=step_path(kind), entries=entries)
    return prog


def _lm_step(dev):
    import torch

    from horovod_tpu_torch.analysis import graph
    from horovod_tpu_torch.models import tied_lm
    from horovod_tpu_torch.optim.optimizer import DistributedOptimizer

    cfg = tied_lm.TiedLMConfig(vocab=8192, d_model=256, d_ff=1024,
                               n_layers=6)
    params = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(v)
         for k, v in tied_lm.init(0, cfg, dev).items()})
    opt = DistributedOptimizer(torch.optim.SGD(params.parameters(), lr=0.01),
                               named_parameters=params.named_parameters())
    tok, tgt = tied_lm.sample_batch(0, cfg, batch=16, seq=64, device=dev)

    def step():
        opt.zero_grad()
        loss = tied_lm.global_loss(dict(params.items()), tok, tgt, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    step._keep = opt  # the optimizer's hooks hold it weakly
    return step, graph.model_entries(params, opt, (tok, tgt))


def _resnet_block_step(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.analysis import graph
    from horovod_tpu_torch.ops.conv_block import conv1x1_bn_act_nhwc

    C, W, B, HW, K = 64, 64, 128, 8, 1000
    rng = np.random.default_rng(0)

    def t(shape, scale):
        return torch.nn.Parameter(torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev))

    def bn(c):
        return (torch.nn.Parameter(torch.ones(c, device=dev)),
                torch.nn.Parameter(torch.zeros(c, device=dev)))

    p = torch.nn.ParameterDict({
        "conv1": t((C, W), (2.0 / C) ** 0.5),
        "conv2": t((W, W, 3, 3), (2.0 / (9 * W)) ** 0.5),
        "conv3": t((W, 4 * W), (2.0 / W) ** 0.5),
        "proj": t((C, 4 * W), (2.0 / C) ** 0.5),
        "fc": t((4 * W, K), (4 * W) ** -0.5)})
    for name, c in (("bn1", W), ("bn2", W), ("bn3", 4 * W), ("bnp", 4 * W)):
        p[name + "_scale"], p[name + "_bias"] = bn(c)
    opt = torch.optim.SGD(p.parameters(), lr=0.01)
    x = torch.from_numpy(rng.standard_normal((B, HW, HW, C)).astype(
        np.float32)).to(dev)
    yl = torch.from_numpy(rng.integers(0, K, (B,))).to(dev)

    def step():
        opt.zero_grad()
        h, _ = conv1x1_bn_act_nhwc(x, p["conv1"], p["bn1_scale"],
                                   p["bn1_bias"])
        h = F.conv2d(h.permute(0, 3, 1, 2), p["conv2"], padding=1)
        h = F.relu(F.batch_norm(h, None, None, p["bn2_scale"],
                                p["bn2_bias"], training=True))
        h = h.permute(0, 2, 3, 1).contiguous()
        h, _ = conv1x1_bn_act_nhwc(h, p["conv3"], p["bn3_scale"],
                                   p["bn3_bias"], relu=False)
        sc, _ = conv1x1_bn_act_nhwc(x, p["proj"], p["bnp_scale"],
                                    p["bnp_bias"], relu=False)
        h = F.relu(h + sc).mean(dim=(1, 2))
        loss = F.cross_entropy(h @ p["fc"], yl)
        loss.backward()
        opt.step()
        return loss.detach()

    return step, graph.model_entries(p, opt, (x, yl))
