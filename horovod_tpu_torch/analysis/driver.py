"""hvdlint driver: rule registry, suppression handling, CLI
(counterpart of horovod_tpu/analysis/driver.py).

One entrypoint (``python -m horovod_tpu_torch.analysis``), one exit
code, one output format::

    file:line RULE-ID message

Rules have stable IDs (HVD0xx collective consistency, HVD1xx concurrency
discipline, HVD-ENV documentation drift). A finding on a line is
suppressed by a trailing ``hvdlint: disable=HVD001 -- root-only by
design`` comment on that line. The rationale after ``--`` is mandatory:
a bare suppression is itself a finding (HVD000), so every silenced rule
carries an explanation a reviewer can audit. ``disable`` with no ID list
suppresses every rule on the line (rationale still required).

Findings also feed the process metrics registry
(``hvdlint_findings_total{rule}``, observability/metrics.py) so lint runs
wired into jobs surface in the same telemetry plane as the runtime.

The analyzers of step programs run in the same CLI: ``--hlo`` (HVD2xx),
``--shard`` (HVD3xx), ``--sched`` (HVD4xx) and ``--num`` (HVD5xx) over
lowered StableHLO/HLO text dumps, as the JAX CLI runs them, and
``--hlo-step {lm,resnet_block,lm_sharded,lm_runtime}`` over the port's
own canonical steps, recorded by analysis/graph.py (``--device cpu`` on
the host; the card by default when there is one; the two dp x tp
programs always in a gloo world of four on the host).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import pathlib
import re
import sys
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: Suppression comment grammar (docs/static_analysis.md). A rule ID
#: token may contain single dashes (HVD-ENV) but the token pattern
#: cannot cross the ``--`` rationale separator.
_ID_TOKEN = r"[A-Za-z0-9_]+(?:-[A-Za-z0-9_]+)*"
_SUPPRESS_RE = re.compile(
    r"#\s*hvdlint:\s*disable"
    rf"(?:=(?P<ids>{_ID_TOKEN}(?:\s*,\s*{_ID_TOKEN})*))?"
    r"(?:\s*--\s*(?P<why>\S.*))?")

#: Suppress-all sentinel in a parsed suppression entry.
_ALL = "*"

HVD000 = "HVD000"

#: Shared by the AST pass and the HVD-ENV pass — lint_paths dedupes
#: cross-pass findings by exact message, so there must be ONE copy.
MSG_NO_RATIONALE = ("suppression comment lacks a rationale: append "
                    "' -- <why this is safe>' to the disable comment")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, anchored to a source location."""

    path: str
    line: int
    rule_id: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule_id} {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line,
                "rule": self.rule_id, "message": self.message}


def parse_suppression(line: str) -> Optional[Tuple[Set[str], bool]]:
    """(suppressed rule ids or {"*"}, has_rationale) for one source
    line, or None if it carries no suppression comment. Shared by the
    AST rules (via SourceFile) and the repo-level HVD-ENV rule."""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return None
    ids = m.group("ids")
    ruleset = ({_ALL} if ids is None else
               {i.strip().upper() for i in ids.split(",") if i.strip()})
    return ruleset, m.group("why") is not None


def suppression_covers(entry: Optional[Tuple[Set[str], bool]],
                       rule_id: str) -> bool:
    if entry is None:
        return False
    ruleset, _ = entry
    return _ALL in ruleset or rule_id.upper() in ruleset


class SourceFile:
    """Parsed source + per-line suppression table shared by every rule."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        # line -> (set of suppressed rule ids or {_ALL}, has_rationale)
        self.suppressions: Dict[int, Tuple[Set[str], bool]] = {}
        for lineno, line in enumerate(self.lines, 1):
            entry = parse_suppression(line)
            if entry is not None:
                self.suppressions[lineno] = entry

    def suppressed(self, line: int, rule_id: str) -> bool:
        return suppression_covers(self.suppressions.get(line), rule_id)

    def finding(self, node: ast.AST, rule_id: str, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1), rule_id,
                       message)


def _rationale_findings(sf: SourceFile) -> Iterable[Finding]:
    """HVD000: a suppression without a ``-- rationale`` is a finding."""
    for lineno, (_ids, has_why) in sorted(sf.suppressions.items()):
        if not has_why:
            yield Finding(sf.path, lineno, HVD000, MSG_NO_RATIONALE)


def registry() -> Dict[str, Tuple[str, object]]:
    """rule_id -> (one-line description, check(sf) -> iterable[Finding]).

    Imported lazily so the CLI only pays for (and only can fail on) the
    rule modules it actually runs.
    """
    from horovod_tpu_torch.analysis import collective_rules, concurrency_rules
    reg: Dict[str, Tuple[str, object]] = {}
    reg.update(collective_rules.RULES)
    reg.update(concurrency_rules.RULES)
    return reg


#: Step-program rule families: (CLI flag, analysis module exposing a
#: ``registry()`` hook). ``--list-rules`` derives its listing from this
#: table, so a new family appears by registering here once.
HLO_RULE_FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("--hlo", "horovod_tpu_torch.analysis.hlo"),
    ("--shard", "horovod_tpu_torch.analysis.shard"),
    ("--sched", "horovod_tpu_torch.analysis.schedule"),
    ("--num", "horovod_tpu_torch.analysis.numerics"),
)

#: The canonical step programs of --hlo-step.
HLO_STEPS = ("lm", "resnet_block", "lm_sharded", "lm_runtime")


def family_registries() -> Dict[str, Dict[str, Tuple[str, object]]]:
    """CLI flag -> that family's rule registry, one entry per
    HLO_RULE_FAMILIES row (imported lazily, like registry())."""
    import importlib
    out: Dict[str, Dict[str, Tuple[str, object]]] = {}
    for flag, modname in HLO_RULE_FAMILIES:
        out[flag] = importlib.import_module(modname).registry()
    return out


def lint_source(text: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None,
                ignore: Sequence[str] = (),
                graph: Optional[object] = None) -> List[Finding]:
    """Run the AST rule families over one source blob (unit-test surface).

    Returns surviving findings (suppressions applied), sorted by line.
    `graph` is the lint run's shared CallGraph; a single-blob run builds
    its own one-file graph.
    """
    sf = SourceFile(path, text)
    return _lint_sf(sf, select=select, ignore=ignore, graph=graph)


def _lint_sf(sf: SourceFile,
             select: Optional[Sequence[str]] = None,
             ignore: Sequence[str] = (),
             graph: Optional[object] = None) -> List[Finding]:
    if graph is None:
        from horovod_tpu_torch.analysis.callgraph import CallGraph
        graph = CallGraph([sf])
    sf.graph = graph
    reg = registry()
    wanted = {r.upper() for r in select} if select is not None else None
    ignored = {r.upper() for r in ignore}
    out: List[Finding] = []
    if (wanted is None or HVD000 in wanted) and HVD000 not in ignored:
        out.extend(_rationale_findings(sf))
    for rule_id, (_desc, check) in sorted(reg.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        if rule_id in ignored:
            continue
        for f in check(sf):
            if not sf.suppressed(f.line, f.rule_id):
                out.append(f)
    out.sort(key=lambda f: (f.line, f.rule_id))
    return out


def _iter_py_files(paths: Sequence[str]) -> Iterable[pathlib.Path]:
    seen: Set[pathlib.Path] = set()
    for p in paths:
        path = pathlib.Path(p)
        candidates = (sorted(path.rglob("*.py")) if path.is_dir()
                      else [path])
        for c in candidates:
            c = c.resolve()
            if c in seen or c.suffix != ".py" or not c.exists():
                continue
            # Generated/vendored trees have no lint contract.
            if "__pycache__" in c.parts:
                continue
            seen.add(c)
            yield c


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               ignore: Sequence[str] = (),
               root: Optional[str] = None,
               env_rule: bool = True) -> List[Finding]:
    """Lint every ``*.py`` under `paths` + the repo-level HVD-ENV rule."""
    findings: List[Finding] = []
    for p in paths:
        # A typo'd path must FAIL the gate, not silently lint nothing —
        # this command fronts CI.
        if not pathlib.Path(p).exists():
            findings.append(Finding(str(p), 1, "HVD999",
                                    "path does not exist"))
    # Parse everything FIRST: the interprocedural rules need one call
    # graph spanning every linted file before any rule runs.
    sfs: List[SourceFile] = []
    for path in _iter_py_files(paths):
        rel = path
        if root is not None:
            try:
                rel = path.relative_to(pathlib.Path(root).resolve())
            except ValueError:
                pass
        try:
            text = path.read_text(encoding="utf-8")
            sfs.append(SourceFile(str(rel), text))
        except SyntaxError as e:
            findings.append(Finding(str(rel), e.lineno or 1, "HVD999",
                                    f"syntax error: {e.msg}"))
        except OSError as e:
            findings.append(Finding(str(rel), 1, "HVD999",
                                    f"unreadable: {e}"))
    from horovod_tpu_torch.analysis.callgraph import CallGraph
    graph = CallGraph(sfs)
    for sf in sfs:
        findings.extend(_lint_sf(sf, select=select, ignore=ignore,
                                 graph=graph))
    if env_rule and (select is None or "HVD-ENV" in
                     {s.upper() for s in select}) \
            and "HVD-ENV" not in {i.upper() for i in ignore}:
        from horovod_tpu_torch.analysis import env_rule as env_mod
        findings.extend(env_mod.check_project(root))
    # The AST pass and the project-level HVD-ENV pass can both report
    # the same location (e.g. HVD000 for one bare suppression): dedupe.
    unique: Dict[Tuple[str, int, str, str], Finding] = {}
    for f in findings:
        unique.setdefault((f.path, f.line, f.rule_id, f.message), f)
    findings = list(unique.values())
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def _baseline_key(f: Finding) -> Tuple[str, str, str]:
    """Baseline identity for a finding. Line numbers churn with every
    unrelated edit, so they are excluded — both the anchor line and any
    line references embedded in the message (normalized to 'N')."""
    return (f.path, f.rule_id, re.sub(r"\d+", "N", f.message))


def load_baseline(path: str) -> Counter:
    """Multiset of accepted findings from a ``--format json`` dump (or a
    bare JSON list of finding objects)."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("findings", []) if isinstance(data, dict) else data
    # Shape errors must surface as ValueError so the CLI's 'unreadable
    # baseline' exit-2 path catches them (not an AttributeError crash).
    if not isinstance(entries, list) \
            or not all(isinstance(e, dict) for e in entries):
        raise ValueError(
            "baseline must be a --format json dump (or a JSON list of "
            "finding objects)")
    keys = []
    for e in entries:
        keys.append((str(e.get("path", "")), str(e.get("rule", "")),
                     re.sub(r"\d+", "N", str(e.get("message", "")))))
    return Counter(keys)


def apply_baseline(findings: Sequence[Finding],
                   baseline: Counter) -> Tuple[List[Finding], int]:
    """(new findings, count matched by the baseline). Multiplicity-aware:
    a baseline entry absorbs at most as many findings as it was recorded
    with, so a *new* duplicate of a baselined finding still gates."""
    budget = Counter(baseline)
    new: List[Finding] = []
    matched = 0
    for f in findings:
        key = _baseline_key(f)
        if budget[key] > 0:
            budget[key] -= 1
            matched += 1
        else:
            new.append(f)
    return new, matched


def render_json(findings: Sequence[Finding]) -> str:
    """The ``--format json`` payload — also the baseline file format."""
    return json.dumps(
        {"findings": [f.as_dict() for f in findings],
         "count": len(findings)}, indent=2, sort_keys=True) + "\n"


def _record_metrics(findings: Sequence[Finding]) -> None:
    """Feed findings into the metrics plane (observability/metrics.py);
    lint must still work in environments without the runtime deps, so
    any import failure is swallowed."""
    try:
        from horovod_tpu_torch.observability import metrics as m
        counter = m.registry().counter(
            "hvdlint_findings_total", "hvdlint findings by rule",
            labelnames=("rule",))
        for f in findings:
            counter.labels(rule=f.rule_id).inc()
    except Exception:
        pass


def _lint_step(args, select, ignore) -> List[Finding]:
    """Findings of the --hlo-step program `args.hlo_step`: HVD2xx (and
    HVD5xx with --num) on lm / resnet_block; every family on each rank's
    program of lm_sharded / lm_runtime, the cross-program rules over the
    ranks' programs as one set. A recording that fails raises
    RuntimeError."""
    from horovod_tpu_torch.analysis import hlo as hlo_mod
    from horovod_tpu_torch.analysis import numerics as num_mod
    from horovod_tpu_torch.analysis import schedule as sched_mod
    from horovod_tpu_torch.analysis import shard as shard_mod
    findings: List[Finding] = []
    try:
        if args.hlo_step in ("lm_sharded", "lm_runtime"):
            progs = shard_mod.record_sharded_programs(args.hlo_step)
        else:
            progs = [hlo_mod.record_step_program(args.hlo_step,
                                                 args.device)]
    except ValueError:
        raise  # a malformed knob: the CLI's tool-error path as it is
    except Exception as e:
        raise RuntimeError(f"cannot record step program "
                           f"{args.hlo_step!r}: {e}") from e
    for prog in progs:
        findings.extend(hlo_mod.lint_program(prog, select=select,
                                             ignore=ignore))
    if args.hlo_step in ("lm_sharded", "lm_runtime"):
        for prog in progs:
            findings.extend(shard_mod.lint_program(prog, select=select,
                                                   ignore=ignore))
        findings.extend(sched_mod.lint_programs(progs, select=select,
                                                ignore=ignore))
    if args.num or args.hlo_step in ("lm_sharded", "lm_runtime"):
        findings.extend(num_mod.lint_programs(progs, select=select,
                                              ignore=ignore))
    return findings


def _family_name(args, select) -> str:
    """The tool a run reports as: the one family that judged it."""
    sel_all = (lambda pat: bool(select) and all(
        re.fullmatch(pat, r.strip().upper()) for r in select))
    sched_only = ((args.sched or sel_all(r"HVD4\d\d"))
                  and not (args.hlo or args.shard or args.num))
    num_only = ((args.num or sel_all(r"HVD5\d\d"))
                and not (args.hlo or args.shard or args.sched))
    shard_mode = args.shard or args.hlo_step in ("lm_sharded",
                                                 "lm_runtime")
    return ("hvdnum" if num_only
            else "hvdsched" if sched_only
            else "hvdshard" if shard_mode else "hvdhlo")


def _lint_programs(args, select, ignore) -> List[Finding]:
    """--hlo / --shard / --sched / --num over the dumps, plus the
    --hlo-step program."""
    from horovod_tpu_torch.analysis import hlo as hlo_mod
    from horovod_tpu_torch.analysis import numerics as num_mod
    from horovod_tpu_torch.analysis import schedule as sched_mod
    from horovod_tpu_torch.analysis import shard as shard_mod
    findings: List[Finding] = []
    # --hlo runs HVD2xx, --shard HVD3xx, --sched HVD4xx, --num HVD5xx;
    # the flags compose over the same dumps. A bare --hlo-step adds no
    # file findings (paths empty).
    if args.hlo or (args.paths and not args.shard and not args.sched
                    and not args.num):
        findings.extend(hlo_mod.lint_files(args.paths, select=select,
                                           ignore=ignore))
    if args.shard:
        findings.extend(shard_mod.lint_files(args.paths, select=select,
                                             ignore=ignore))
    if args.sched:
        findings.extend(sched_mod.lint_files(args.paths, select=select,
                                             ignore=ignore))
    if args.num:
        findings.extend(num_mod.lint_files(args.paths, select=select,
                                           ignore=ignore))
    if args.hlo_step is not None:
        findings.extend(_lint_step(args, select, ignore))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def _record_family_metrics(findings: Sequence[Finding]) -> None:
    """Each family owns its counter: HVD3xx -> hvdshard_findings_total,
    HVD4xx -> hvdsched_, HVD5xx -> hvdnum_, the rest -> hvdhlo_."""
    from horovod_tpu_torch.analysis import hlo as hlo_mod
    from horovod_tpu_torch.analysis import numerics as num_mod
    from horovod_tpu_torch.analysis import schedule as sched_mod
    from horovod_tpu_torch.analysis import shard as shard_mod
    by = {"3": [], "4": [], "5": [], "": []}
    for f in findings:
        m = re.fullmatch(r"HVD([345])\d\d", f.rule_id)
        by[m.group(1) if m else ""].append(f)
    hlo_mod.record_metrics(by[""])
    shard_mod.record_metrics(by["3"])
    sched_mod.record_metrics(by["4"])
    num_mod.record_metrics(by["5"])


def run_cli(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="hvdlint: collective-consistency and concurrency "
                    "static analysis of Python source, plus the "
                    "analyzers of step programs (lowered text dumps, or "
                    "the port's recorded canonical steps)")
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint")
    parser.add_argument("--hlo", action="store_true",
                        help="hvdhlo mode: treat paths as lowered "
                             "StableHLO/HLO text dumps and run the "
                             "HVD2xx performance-contract rules")
    parser.add_argument("--shard", action="store_true",
                        help="hvdshard mode: run the HVD3xx sharding/"
                             "memory rules over the dumps; composes with "
                             "--hlo")
    parser.add_argument("--sched", action="store_true",
                        help="hvdsched mode: reconstruct each device's "
                             "collective schedule and run the HVD4xx "
                             "rules; ALL paths are linted as one set so "
                             "the cross-program rules see every pairing")
    parser.add_argument("--num", action="store_true",
                        help="hvdnum mode: the HVD5xx numerics rules; ALL "
                             "paths are linted as one set (the cross-mesh "
                             "HVD505 diff); with --hlo-step lm or "
                             "resnet_block, also over the step")
    parser.add_argument("--hlo-step", default=None, metavar="PROGRAM",
                        choices=HLO_STEPS,
                        help="record the named canonical step under the "
                             "current fusion/layout config and lint it: "
                             "lm and resnet_block under HVD2xx, "
                             "lm_sharded and lm_runtime (the tied LM at "
                             "dp=2 x tp=2, each rank's program) under "
                             "every family")
    parser.add_argument("--device", default=None,
                        help="where --hlo-step lm / resnet_block runs: "
                             "cpu, or a card (default: the card when there "
                             "is one)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule IDs to run (default all)")
    parser.add_argument("--ignore", default="",
                        help="comma-separated rule IDs to skip")
    parser.add_argument("--no-env", action="store_true",
                        help="skip the repo-level HVD-ENV docs-drift rule")
    parser.add_argument("--root", default=None,
                        help="repo root for HVD-ENV and relative paths "
                             "(default: auto-detected from this package)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", dest="fmt",
                        help="output format; json doubles as the "
                             "--baseline file format")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="diff-aware mode: findings recorded in FILE "
                             "(a --format json dump) are accepted; only "
                             "NEW findings are printed and gate the exit "
                             "code")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        from horovod_tpu_torch.analysis import env_rule as env_mod
        reg = dict(registry())
        reg[env_mod.RULE_ID] = (env_mod.DESCRIPTION, None)
        reg[HVD000] = ("suppression comment lacks a rationale", None)
        for flag, family in family_registries().items():
            for rule_id, (desc, _check) in family.items():
                reg[rule_id] = (f"[{flag}] {desc}", None)
        for rule_id in sorted(reg):
            print(f"{rule_id}  {reg[rule_id][0]}")
        return 0
    hlo_mode = (args.hlo or args.shard or args.sched or args.num
                or args.hlo_step is not None)
    if not args.paths and not args.hlo_step:
        parser.error("no paths given (try: horovod_tpu_torch/)")

    root = args.root
    if root is None:
        # horovod_tpu_torch/analysis/driver.py -> the repo root, two
        # levels up from the package directory.
        root = str(pathlib.Path(__file__).resolve().parent.parent.parent)
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    ignore = [s.strip() for s in args.ignore.split(",") if s.strip()]
    name = _family_name(args, select) if hlo_mode else "hvdlint"
    if hlo_mode:
        try:
            findings = _lint_programs(args, select, ignore)
        except (ValueError, RuntimeError) as e:
            # A malformed knob raises by design, and a step that cannot
            # be recorded is no clean lint: both are tool errors (one
            # line, exit 2), never findings.
            print(f"{name}: {e}", file=sys.stderr)
            return 2
    else:
        findings = lint_paths(args.paths, select=select, ignore=ignore,
                              root=root, env_rule=not args.no_env)
    matched = 0
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            # A broken baseline must fail the gate, not pass everything.
            print(f"{name}: unreadable baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        findings, matched = apply_baseline(findings, baseline)
    if hlo_mode:
        _record_family_metrics(findings)
    else:
        _record_metrics(findings)
    if args.fmt == "json":
        sys.stdout.write(render_json(findings))
    else:
        for f in findings:
            print(f.render())
    if findings:
        tag = " new" if args.baseline is not None else ""
        print(f"{name}: {len(findings)}{tag} finding(s)"
              + (f" ({matched} baselined)" if matched else ""),
              file=sys.stderr)
        return 1
    if args.fmt != "json":
        print(f"{name}: clean"
              + (f" ({matched} baselined)" if matched else ""))
    return 0


def main() -> None:
    sys.exit(run_cli())
